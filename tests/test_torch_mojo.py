"""MOJOs both ways between the port (``h2o3_tpu_torch/genmodel/mojo.py``,
``generic.py``, ``tools.py``) and the JAX package (``h2o3_tpu/genmodel/``),
for every family of ``tests/test_mojo_v2.py``: GBM, multinomial DRF,
XGBoost, GLM, DeepLearning, KMeans, IsotonicRegression and a
StackedEnsemble (GBM and GLM with 3-fold CV), each trained by the port on
a numpy-seeded frame (320 rows, a multiple of 64: no pad rows in the
reference).

- A MOJO the port writes loads in ``h2o3_tpu.genmodel.mojo.MojoModel`` as
  the JAX package's own model class and scores there equal to the port's
  ``_score_raw``. That model, written again by the JAX package's
  ``write_mojo`` (a MOJO of the JAX package, without the port's
  ``tensors`` key), loads in the port through ``convert`` and scores equal
  to the JAX package's ``_score_raw``. Both at ``tests/test_mojo_v2.py``'s
  tolerance (rtol 1e-5, atol 1e-6: float32 arithmetic in two libraries).
  Training the families in the JAX package as well would add about 40 s of
  XLA compiles; the JAX package's own trained MOJOs are read in
  ``tests/test_torch_mojo_ref.py``'s generic import and by the real H2O-3
  zips.
- A MOJO the port writes and loads scores bit for bit; its members are the
  three of the format and its structure names the JAX package's class.
- A v1 pickle artifact and an unknown class are refused.
- ``import_mojo``/``Generic`` take both formats and register the model.
- ``print_mojo``'s text (dot and list) equals the JAX package's for the
  same MOJO, exactly; ``EasyPredictModelWrapper`` equals the JAX
  package's (rtol 1e-6 on the probabilities, labels exactly).
"""

import configparser
import io
import json
import pickle
import runpy
import sys
import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.genmodel import mojo as jmojo
from h2o3_tpu.genmodel import tools as jtools
from h2o3_tpu_torch import import_mojo, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.genmodel import mojo as pmojo
from h2o3_tpu_torch.genmodel import tools as ptools
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 320
RTOL, ATOL = 1e-5, 1e-6


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


def bin_cols(seed=42):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    y = X[:, 0] - X[:, 1] > 0
    cat = rng.integers(0, 4, size=N)
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
            "g": np.array(list("wxyz"), dtype=object)[cat],
            "y": np.array(["no", "yes"], dtype=object)[y.astype(int)]}


def multi_cols(seed=43):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 2)).astype(np.float32)
    y = np.argmax(np.stack([X[:, 0], -X[:, 1], X[:, 0] * 0], 1), axis=1)
    return {"a": X[:, 0], "b": X[:, 1],
            "y": np.array(["u", "v", "w"], dtype=object)[y]}


def iso_cols(seed=44):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N).astype(np.float32)
    return {"x": x, "y": (x + 0.2 * rng.normal(size=N)).astype(np.float32)}


#: family: (module, class, params, cols, y, x)
FAMILIES = {
    "gbm": ("gbm", "GBM", dict(ntrees=5, max_depth=3, seed=1), bin_cols,
            "y", None),
    "drf_multinomial": ("gbm", "DRF", dict(ntrees=6, max_depth=4, seed=1),
                        multi_cols, "y", None),
    "xgboost": ("xgboost", "XGBoost", dict(ntrees=5, max_depth=3, seed=1),
                bin_cols, "y", None),
    "glm": ("glm", "GLM", dict(family="binomial", lambda_=1e-3), bin_cols,
            "y", None),
    "deeplearning": ("deeplearning", "DeepLearning",
                     dict(hidden=[8], epochs=2, seed=1), bin_cols, "y",
                     None),
    "kmeans": ("kmeans", "KMeans", dict(k=3, seed=1), bin_cols, None,
               ["a", "b", "c"]),
    "isotonic": ("isotonic", "IsotonicRegression", dict(), iso_cols, "y",
                 ["x"]),
}


def _builder(pkg, mod, cls):
    import importlib
    return getattr(importlib.import_module(f"{pkg}.models.{mod}"), cls)


def _ensemble(frame):
    from h2o3_tpu_torch.orchestration import StackedEnsemble
    common = dict(nfolds=3, keep_cross_validation_predictions=True, seed=1)
    base = [_builder("h2o3_tpu_torch", "gbm", "GBM")(
                ntrees=5, max_depth=3, **common).train(
                    y="y", training_frame=frame),
            _builder("h2o3_tpu_torch", "glm", "GLM")(
                family="binomial", **common).train(
                    y="y", training_frame=frame)]
    return StackedEnsemble(base_models=base).train(y="y",
                                                   training_frame=frame)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """family: (the JAX package's model read from the port's MOJO, the
    port's model, JAX frame, port frame)."""
    d = tmp_path_factory.mktemp("mojo")
    out = {}
    for fam in ALL:
        if fam == "stackedensemble":
            c = bin_cols()
            pf = Frame.from_arrays(c)
            pm = _ensemble(pf)
        else:
            mod, cls, params, cols, y, x = FAMILIES[fam]
            c = cols()
            pf = Frame.from_arrays(c)
            pm = _builder("h2o3_tpu_torch", mod, cls)(**params).train(
                x=x, y=y, training_frame=pf)
        path = pm.download_mojo(str(d / f"{fam}.mojo"))
        out[fam] = (jmojo.MojoModel.load(path)._inner, pm,
                    JFrame.from_arrays(c), pf)
    return out


ALL = list(FAMILIES) + ["stackedensemble"]


def _jraw(model, frame) -> np.ndarray:
    return np.asarray(model._score_raw(frame))[:N]


@pytest.mark.parametrize("fam", ALL)
def test_port_mojo_scores_in_the_reference(models, fam, tmp_path):
    jm, pm, jf, pf = models[fam]
    path = pm.download_mojo(str(tmp_path / f"{fam}.mojo"))
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) == {"model.ini", "structure.json",
                                     "arrays.npz"}
        structure = json.loads(z.read("structure.json"))
    assert structure["class"] == type(pm).__name__ == type(jm).__name__
    assert jmojo.MojoModel.load(path).nclasses == pm.nclasses
    np.testing.assert_allclose(_jraw(jm, jf), pm._score_raw(pf).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fam", ALL)
def test_reference_mojo_scores_in_the_port(models, fam, tmp_path):
    jm, _, jf, pf = models[fam]
    path = jmojo.write_mojo(jm, str(tmp_path / f"{fam}.mojo"))
    with zipfile.ZipFile(path) as z:
        assert "tensors" not in json.loads(z.read("structure.json"))
    mojo = pmojo.MojoModel.load(path, device="cpu")
    assert type(mojo._inner).__name__ == type(jm).__name__
    assert mojo.algo == jm.algo and mojo.nclasses == jm.nclasses
    got = mojo._score_raw(pf)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), _jraw(jm, jf), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fam", ALL)
def test_port_mojo_round_trip_is_bit_for_bit(models, fam, tmp_path):
    _, pm, _, pf = models[fam]
    path = pmojo.write_mojo(pm, str(tmp_path / f"{fam}.mojo"))
    mojo = pmojo.MojoModel.load(path, device="cpu")
    assert mojo._inner.key == pm.key
    assert torch.equal(mojo._score_raw(pf), pm._score_raw(pf))
    a, b = mojo.predict(pf), pm.predict(pf)
    assert a.names == b.names
    for va, vb in zip(a.vecs, b.vecs):
        assert torch.equal(va.data, vb.data)


def test_v1_pickle_artifact_is_refused(models, tmp_path):
    from h2o3_tpu_torch.persist.model_io import host_copy
    _, pm, _, pf = models["gbm"]
    ini = configparser.ConfigParser()
    ini["info"] = {"format": "h2o3_tpu_mojo", "version": "1.0",
                   "algorithm": "gbm", "n_classes": "2"}
    buf = io.StringIO()
    ini.write(buf)
    p = tmp_path / "legacy.mojo"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("model.ini", buf.getvalue())
        z.writestr("payload.bin", pickle.dumps(host_copy(pm)))
    with pytest.raises(ValueError, match="pickle-payload"):
        pmojo.MojoModel.load(str(p), device="cpu")
    mojo = pmojo.MojoModel.load(str(p), allow_legacy=True, device="cpu")
    assert mojo.algo == "gbm"
    assert torch.equal(mojo._score_raw(pf), pm._score_raw(pf))


def test_unknown_class_and_format_are_refused(models, tmp_path):
    _, pm, _, _ = models["gbm"]
    path = pmojo.write_mojo(pm, str(tmp_path / "m.mojo"))
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    structure = json.loads(members["structure.json"])
    structure["class"] = "NoSuchModel"
    bad = tmp_path / "bad.mojo"
    with zipfile.ZipFile(bad, "w") as z:
        for n, data in members.items():
            z.writestr(n, json.dumps(structure) if n == "structure.json"
                       else data)
    with pytest.raises(ValueError, match="NoSuchModel"):
        pmojo.MojoModel.load(str(bad), device="cpu")
    other = tmp_path / "other.mojo"
    with zipfile.ZipFile(other, "w") as z:
        z.writestr("model.ini", "[info]\nformat = something\n")
    with pytest.raises(ValueError, match="not a h2o3_tpu_mojo"):
        pmojo.MojoModel.load(str(other), device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_import_mojo_takes_both_formats(models, writer, tmp_path):
    jm, pm, jf, pf = models["gbm"]
    path = str(tmp_path / "m.mojo")
    (pmojo if writer == "port" else jmojo).write_mojo(
        pm if writer == "port" else jm, path)
    g = import_mojo(path, model_id="imported", device="cpu")
    assert DKV.get("imported") is g
    assert g.output["source_algo"] == "gbm"
    assert g.response_column == "y" and g.response_domain == ("no", "yes")
    want = pm._score_raw(pf).numpy() if writer == "port" else _jraw(jm, jf)
    got = g.predict(pf)
    assert got.names == ["predict", "pno", "pyes"]
    np.testing.assert_allclose(got.vec("pyes").to_numpy(), want[:, 1],
                               rtol=RTOL, atol=ATOL)
    mm = g.model_performance(pf)
    assert mm.auc == pytest.approx(pm.training_metrics.auc, abs=1e-3)


@pytest.mark.parametrize("fam,fmt", [("gbm", "dot"), ("gbm", "list"),
                                     ("drf_multinomial", "dot"),
                                     ("drf_multinomial", "list")])
def test_print_mojo_is_the_references_text(models, fam, fmt, tmp_path):
    jm, pm, _, _ = models[fam]
    for writer, src in ((jmojo, jm), (pmojo, pm)):
        path = writer.write_mojo(src, str(tmp_path / "m.mojo"))
        want = jtools.print_mojo(path, fmt=fmt, max_trees=3)
        got = ptools.print_mojo(path, fmt=fmt, max_trees=3, device="cpu")
        assert got == want and got.count("leaf") > 3


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_print_mojo_command_line(models, tmp_path, capsys, monkeypatch):
    _, pm, _, _ = models["gbm"]
    path = pm.download_mojo(str(tmp_path / "m.mojo"))
    monkeypatch.setattr(sys, "argv", ["tools", path, "--format", "list",
                                      "--max-trees", "2", "--device", "cpu"])
    runpy.run_module("h2o3_tpu_torch.genmodel.tools", run_name="__main__")
    assert capsys.readouterr().out == ptools.print_mojo(
        path, fmt="list", max_trees=2, device="cpu")


@pytest.mark.parametrize("fam", ["gbm", "drf_multinomial", "xgboost"])
def test_easy_predict_is_the_references(models, fam, tmp_path):
    jm, _, _, _ = models[fam]
    path = jmojo.write_mojo(jm, str(tmp_path / "m.mojo"))
    ji = jmojo.MojoModel.load(path)._inner
    pi = pmojo.MojoModel.load(path, device="cpu")._inner
    cols = FAMILIES[fam][3]()
    x_cols = list(pi.output.get("x_cols", []))
    rows = [{c: (cols[c][i] if not isinstance(cols[c][i], np.floating)
                 else float(cols[c][i])) for c in x_cols} for i in range(7)]
    rows[1].pop(x_cols[0])                   # a missing key is NA
    jw = jtools.EasyPredictModelWrapper(ji)
    pw = ptools.EasyPredictModelWrapper(pi, device="cpu")
    want, got = jw.predict_batch(rows), pw.predict_batch(rows)
    assert [pw.predict(r) for r in rows[:2]] == got[:2]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        if "label" in a:
            assert a["label"] == b["label"]
            for d, p in a["class_probabilities"].items():
                assert p == pytest.approx(b["class_probabilities"][d],
                                          rel=1e-6, abs=1e-7)
        else:
            assert a["value"] == pytest.approx(b["value"], rel=1e-6)
