"""The generated standalone scorer (the POJO) and the C++ MOJO scorer of
the port (``h2o3_tpu_torch/genmodel/codegen.py``, ``native_scorer.py``;
``model.testJavaScoring`` in ``rapids/exec.py``) against the JAX package's
(``h2o3_tpu/genmodel/codegen.py``, ``native/mojo_scorer.cpp`` as
``tests/test_mojo_native.py`` builds it), on numpy-seeded frames of 256
rows trained by the port.

- For each family the generated source is the JAX package's, character
  for character, for the same model (the port's, read by the JAX package
  from its MOJO), and it imports neither package.
- It scores as in ``tests/test_codegen.py``: GBM binomial with a
  categorical and its row API, multinomial GBM, DRF regression, GLM
  (atol 1e-5; DRF 1e-4) and KMeans (99% of assignments); NaiveBayes is
  refused. ``model.testJavaScoring`` through the Rapids engine returns 1.
- The C++ scorer, built by the port's loader, scores MOJOs the port wrote
  (GBM regression with a categorical, binomial, multinomial, DRF) at
  ``tests/test_mojo_native.py``'s tolerances (rtol 1e-5, atol 1e-5 to
  1e-6; multinomial rtol 1e-4); skipped without ``g++``, as that file is.
"""

import shutil

import numpy as np
import pytest
import torch

from h2o3_tpu.genmodel import codegen as jcodegen
from h2o3_tpu.genmodel.mojo import MojoModel as JMojo
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.genmodel import codegen as pcodegen
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.kmeans import KMeans
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 256


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


def _exec_module(src: str) -> dict:
    ns: dict = {}
    exec(compile(src, "<pojo>", "exec"), ns)
    return ns


def _tree_X(fr, model) -> np.ndarray:
    cols = []
    for c in model.output["x_cols"]:
        v = fr.vec(c)
        x = np.asarray(v.to_numpy(), np.float64)
        if v.is_categorical:
            x = np.where(x < 0, np.nan, x)
        cols.append(x)
    return np.stack(cols, axis=1)


@pytest.fixture(scope="module")
def binfr():
    rng = np.random.default_rng(42)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    X[::29, 1] = np.nan
    cat = rng.choice(["a", "b", "c"], size=N)
    logit = 1.5 * X[:, 0] - np.nan_to_num(X[:, 1]) + (cat == "a")
    y = np.where(rng.random(N) < 1 / (1 + np.exp(-logit)), "yes", "no")
    yv = (2 * X[:, 0] - X[:, 2] + rng.normal(scale=0.2, size=N))
    ym = np.array(["a", "b", "c"])[np.argmax(
        X + rng.normal(scale=0.5, size=(N, 3)), 1)]
    return Frame.from_arrays({"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
                              "cat": cat, "y": y, "ym": ym,
                              "yv": yv.astype(np.float32)})


#: family: (builder, params, y, x)
FAMILIES = {
    "gbm": (GBM, dict(ntrees=8, max_depth=3, seed=1), "y",
            ["x0", "x1", "x2", "cat"]),
    "gbm_multinomial": (GBM, dict(ntrees=5, max_depth=3, seed=2), "ym",
                        ["x0", "x1", "x2"]),
    "drf": (DRF, dict(ntrees=6, max_depth=5, seed=3), "yv",
            ["x0", "x1", "x2"]),
    "glm": (GLM, dict(family="binomial", lambda_=0.0), "y",
            ["x0", "x1", "x2", "cat"]),
    "kmeans": (KMeans, dict(k=2, seed=4), None, ["x0", "x2"]),
}


@pytest.fixture(scope="module")
def models(binfr):
    return {fam: cls(**params).train(x=x, y=y, training_frame=binfr)
            for fam, (cls, params, y, x) in FAMILIES.items()}


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_the_source_is_the_jax_packages(models, fam, tmp_path):
    m = models[fam]
    jm = JMojo.load(m.download_mojo(str(tmp_path / "m.mojo")))._inner
    src = pcodegen.generate_pojo(m)
    assert src == jcodegen.generate_pojo(jm)
    assert "h2o3_tpu." not in src and "import torch" not in src
    path = m.download_pojo(str(tmp_path / "m.py"))
    with open(path) as fh:
        assert fh.read() == src


def test_gbm_pojo_scores_and_its_row_api(models, binfr):
    m = models["gbm"]
    ns = _exec_module(pcodegen.generate_pojo(m))
    got = ns["score_batch"](_tree_X(binfr, m))
    want = m.predict(binfr).vec("pyes").to_numpy()
    np.testing.assert_allclose(got[:, 1], want, atol=1e-5)
    row = {c: (binfr.vec(c).labels()[0] if binfr.vec(c).is_categorical
               else float(binfr.vec(c).to_numpy()[0]))
           for c in m.output["x_cols"]}
    np.testing.assert_allclose(ns["score"](row)[1], want[0], atol=1e-5)


def test_multinomial_and_drf_pojos_score(models, binfr):
    m = models["gbm_multinomial"]
    got = _exec_module(pcodegen.generate_pojo(m))["score_batch"](
        _tree_X(binfr, m))
    pred = m.predict(binfr)
    for k, d in enumerate(m.response_domain):
        np.testing.assert_allclose(got[:, k], pred.vec(f"p{d}").to_numpy(),
                                   atol=1e-5)
    m = models["drf"]
    got = _exec_module(pcodegen.generate_pojo(m))["score_batch"](
        _tree_X(binfr, m))
    np.testing.assert_allclose(got, m.predict(binfr).vec("predict")
                               .to_numpy(), atol=1e-4)


def test_glm_and_kmeans_pojos_score(models, binfr):
    m = models["glm"]
    di = m.data_info
    X = np.stack([np.where(np.asarray(binfr.vec(c).to_numpy(), np.float64)
                           < 0, np.nan, binfr.vec(c).to_numpy())
                  if binfr.vec(c).is_categorical
                  else np.asarray(binfr.vec(c).to_numpy(), np.float64)
                  for c in di.cat_cols + di.num_cols], axis=1)
    got = _exec_module(pcodegen.generate_pojo(m))["score_batch"](X)
    np.testing.assert_allclose(got[:, 1], m.predict(binfr).vec("pyes")
                               .to_numpy(), atol=1e-5)
    m = models["kmeans"]
    X = np.stack([binfr.vec(c).to_numpy().astype(np.float64)
                  for c in ("x0", "x2")], axis=1)
    got = _exec_module(pcodegen.generate_pojo(m))["score_batch"](X)
    want = m.predict(binfr).vec("predict").to_numpy().astype(int)
    assert (got == want).mean() > 0.99


def test_unsupported_algo_raises(binfr):
    from h2o3_tpu_torch.models.naive_bayes import NaiveBayes
    m = NaiveBayes().train(x=["x0", "x1"], y="y", training_frame=binfr)
    with pytest.raises(ValueError, match="no standalone codegen"):
        pcodegen.generate_pojo(m)


@pytest.mark.parametrize("fam", ["gbm", "gbm_multinomial", "drf"])
def test_model_test_java_scoring_through_rapids(models, binfr, fam):
    from h2o3_tpu_torch.rapids import exec as px
    DKV.put("tj_model", models[fam])
    DKV.put("tj_frame", binfr)
    assert px.rapids("(model.testJavaScoring tj_model tj_frame "
                     "'predict' 1e-4)") == 1.0


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")


def _csv(path, cols: dict) -> None:
    names = list(cols)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(len(cols[names[0]])):
            f.write(",".join("" if (isinstance(cols[c][i], (float,
                                                             np.floating))
                                    and np.isnan(cols[c][i]))
                             else str(cols[c][i]) for c in names) + "\n")


def _raw_cols(fr, names) -> dict:
    return {c: (list(fr.vec(c).labels()) if fr.vec(c).is_categorical
                else fr.vec(c).to_numpy().astype(np.float64))
            for c in names}


@needs_gxx
@pytest.mark.parametrize("case", ["regression", "binomial", "multinomial",
                                  "drf"])
def test_the_cpp_scorer_scores_a_port_mojo(binfr, case, tmp_path):
    from h2o3_tpu_torch.genmodel import native_scorer
    x = ["x0", "x1", "x2", "cat"]
    if case == "regression":
        m = GBM(ntrees=7, max_depth=4, seed=1).train(x=x, y="yv",
                                                     training_frame=binfr)
    elif case == "binomial":
        m = GBM(ntrees=6, max_depth=3, seed=2).train(x=x, y="y",
                                                     training_frame=binfr)
    elif case == "multinomial":
        m = GBM(ntrees=5, max_depth=3, seed=3).train(x=x[:3], y="ym",
                                                     training_frame=binfr)
    else:
        m = DRF(ntrees=6, max_depth=4, seed=4).train(x=x, y="y",
                                                     training_frame=binfr)
    mojo = m.download_mojo(str(tmp_path / "m.mojo"))
    _csv(tmp_path / "d.csv", _raw_cols(binfr, m.output["x_cols"]))
    rows = native_scorer.score_csv(mojo, str(tmp_path / "d.csv"))
    assert native_scorer.build_info["path"].endswith(
        native_scorer.executable().name)
    pred = m.predict(binfr)
    if case == "regression":
        got = np.array([float(r[0]) for r in rows])
        np.testing.assert_allclose(got, pred.vec("predict").to_numpy(),
                                   rtol=1e-5, atol=1e-5)
        return
    tol = dict(rtol=1e-4, atol=1e-5) if case == "multinomial" else \
        dict(rtol=1e-5, atol=1e-6)
    for k, d in enumerate(m.response_domain):
        got = np.array([float(r[1 + k]) for r in rows])
        np.testing.assert_allclose(got, pred.vec(f"p{d}").to_numpy(), **tol)
    if case == "binomial":
        assert [r[0] for r in rows] == list(pred.vec("predict").labels())
