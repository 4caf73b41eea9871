"""The explanation functions of the port (``h2o3_tpu_torch/explanation.py``)
against the JAX package's (``h2o3_tpu/explanation.py``), the calls of
tests/test_explanation.py; and the data plane under them: the host string
Vec, ``Vec.labels`` and ``rapids/munge.py:gather_rows``.

Both packages explain the same models: the JAX package's GBMs and GLM are
carried into the port with ``convert``, so the functions are compared and
not the fits. Row samples and shuffles come from numpy's
``default_rng(seed)`` in both.

Tolerances: partial-dependence and ICE responses at rtol 1e-5 (the
port's statistics are float64 sums on the device, the reference's float32
numpy means; the two packages' scores of the same trees differ by float32
ulps); SHAP summaries at rtol 1e-5 with the same ranking; permutation
importances at rtol 1e-4 with an absolute floor of 1e-6 (differences of
two metrics of one frame); model correlations at atol 1e-6; varimp
heatmaps exactly (the same trees' gains, summed in float64).
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu import explanation as jex
from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import GBM as JGBM, GLM as JGLM
from h2o3_tpu_torch import convert, explanation as pex, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.rapids.munge import gather_rows
from jax_reference import _jax_compile_cache  # noqa: F401

N = 512


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def bin_cols(n=N, seed=0):
    """tests/test_explanation.py's binfr, with a weight column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.choice(["u", "v"], size=n)
    logit = 2.0 * X[:, 0] - X[:, 1] + (cat == "u")
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    return {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "cat": cat, "y": y,
            "w": rng.uniform(0.5, 2.0, n).astype(np.float32)}


def carried_gbm(jm):
    o = jm.output
    trees = []
    for t in o["trees"]:
        d = {k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
        if getattr(t, "left_mask", None) is not None:
            d["left_mask"] = np.asarray(t.left_mask)
        trees.append(d)
    out = dict(trees=trees, edges=np.asarray(o["edges"]), f0=o["f0"],
               learn_rate=o["learn_rate"], distribution=o["distribution"],
               x_cols=o["x_cols"], feat_domains=o["feat_domains"],
               ntrees=o["ntrees"])
    if o.get("cat_card") is not None:
        out.update(cat_card=np.asarray(o["cat_card"]), cat_bins=o["cat_bins"])
    return convert.gbm_model(out, response_column=jm.response_column,
                             response_domain=jm.response_domain)


def carried_glm(jm):
    out = {k: (np.asarray(v) if k == "beta" else v)
           for k, v in jm.output.items()}
    return convert.glm_model(out, dataclasses.asdict(jm.data_info),
                             jm.response_column, jm.response_domain,
                             dict(jm.params))


@pytest.fixture(scope="module")
def models():
    cols = bin_cols()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    x = ["x0", "x1", "x2", "cat"]
    jg = JGBM(ntrees=10, max_depth=3, seed=1).train(x=x, y="y",
                                                     training_frame=jf)
    jl = JGLM(family="binomial", lambda_=0.0).train(x=x, y="y",
                                                     training_frame=jf)
    return jf, pf, jg, jl, carried_gbm(jg), carried_glm(jl)


def _pd_close(pt, jt, n):
    assert pt.names == jt.names and pt.nrows == jt.nrows
    pv, jv = pt.vec(pt.names[0]), jt.vec(jt.names[0])
    if jv.type is VecType.STR:
        assert pv.type is VecType.STR
        assert list(pv.to_numpy()) == list(jv.to_numpy()[: jt.nrows])
    else:
        np.testing.assert_array_equal(pv.to_numpy(),
                                      jv.to_numpy()[: jt.nrows])
    for c in pt.names[1:]:
        np.testing.assert_allclose(pt.vec(c).to_numpy(),
                                   jt.vec(c).to_numpy()[: jt.nrows],
                                   rtol=1e-5, atol=1e-7, err_msg=c)


@pytest.mark.parametrize("which", ["gbm", "glm"])
@pytest.mark.parametrize("weighted", [False, True])
def test_partial_dependence(models, which, weighted):
    jf, pf, jg, jl, pg, pl = models
    jm, pm = (jg, pg) if which == "gbm" else (jl, pl)
    wc = "w" if weighted else None
    jt = jex.partial_dependence(jm, jf, ["x0", "cat"], nbins=8,
                                weight_column=wc)
    pt = pex.partial_dependence(pm, pf, ["x0", "cat"], nbins=8,
                                weight_column=wc)
    for a, b in zip(pt, jt):
        _pd_close(a, b, N)
    resp = pt[0].vec("mean_response").to_numpy()
    assert resp[-1] > resp[0] + 0.1
    assert pt[1].nrows == 2 and pt[1].vec("cat").type is VecType.STR


def test_ice(models):
    jf, pf, jg, _, pg, _ = models
    for col in ("x0", "cat"):
        jt = jex.ice(jg, jf, col, nbins=5, max_rows=10)
        pt = pex.ice(pg, pf, col, nbins=5, max_rows=10)
        assert pt.nrows == jt.nrows and set(pt.names) == {"row", col,
                                                           "response"}
        _pd_close(Frame(["row", "response"], [pt.vec("row"),
                                              pt.vec("response")]),
                  JFrame(["row", "response"], [jt.vec("row"),
                                               jt.vec("response")]), N)
        pv, jv = pt.vec(col).to_numpy(), jt.vec(col).to_numpy()[: jt.nrows]
        assert list(pv) == list(jv)


def test_shap_summary(models):
    jf, pf, jg, jl, pg, pl = models
    jr, pr = jex.shap_summary(jg, jf), pex.shap_summary(pg, pf)
    assert [r[0] for r in pr] == [r[0] for r in jr]
    np.testing.assert_allclose([r[1:] for r in pr], [r[1:] for r in jr],
                               rtol=1e-5, atol=1e-7)
    assert pr[0][0] in ("x0", "x1", "cat")
    with pytest.raises(ValueError):
        pex.shap_summary(pl, pf)


def test_varimp_heatmap_and_model_correlation(models):
    jf, pf, jg, jl, pg, pl = models
    jh, ph = jex.varimp_heatmap([jg, jl]), pex.varimp_heatmap([pg, pl])
    assert ph["columns"] == jh["columns"]
    assert set(ph["columns"]) == {"x0", "x1", "x2", "cat"}
    np.testing.assert_array_equal(ph["matrix"], jh["matrix"])
    assert ph["models"] == [pg.key, pl.key]
    jc = jex.model_correlation([jg, jl], jf)
    pc = pex.model_correlation([pg, pl], pf)
    np.testing.assert_allclose(pc["matrix"], jc["matrix"], atol=1e-6)
    assert pc["matrix"][0][1] > 0.7


def test_explain(models):
    jf, pf, jg, jl, pg, pl = models
    jb, pb = jex.explain([jg, jl], jf), pex.explain([pg, pl], pf)
    assert set(pb) == set(jb)
    np.testing.assert_allclose(pb["model_correlation"]["matrix"],
                               jb["model_correlation"]["matrix"], atol=1e-6)
    for (pk, pe), (jk, je) in zip(pb["models"].items(), jb["models"].items()):
        assert set(pe) == set(je)
        assert [r[0] for r in pe["varimp"]] == [r[0] for r in je["varimp"]]
        assert list(pe["partial_dependence"]) == list(je["partial_dependence"])
        for c, t in pe["partial_dependence"].items():
            _pd_close(t, je["partial_dependence"][c], N)
    assert "shap_summary" in pb["models"][pg.key]
    assert "shap_summary" not in pb["models"][pl.key]


def _regression(seed=1):
    rng = np.random.default_rng(seed)
    x1, x2, x3 = (rng.normal(size=640).astype(np.float32) for _ in range(3))
    y = (3 * x1 + 0.5 * x2 + 0.1 * rng.normal(size=640)).astype(np.float32)
    return {"x1": x1, "x2": x2, "x3": x3, "y": y}


def _pvi_close(pr, jr):
    assert [r["variable"] for r in pr] == [r["variable"] for r in jr]
    for a, b in zip(pr, jr):
        assert set(a) == set(b)
        for k in a:
            if k != "variable":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(metric="rmse", seed=2),
    dict(metric="mae", seed=5, n_repeats=3),
    dict(seed=7, n_samples=300, features=["x1", "x3"]),
])
def test_permutation_varimp_regression(kw):
    cols = _regression()
    jm = JGBM(ntrees=20, max_depth=4, seed=1).train(
        y="y", training_frame=JFrame.from_arrays(cols))
    pm = carried_gbm(jm)
    jr = jex.permutation_varimp(jm, JFrame.from_arrays(cols), **kw)
    pr = pex.permutation_varimp(pm, Frame.from_arrays(cols), **kw)
    _pvi_close(pr, jr)
    if "n_repeats" not in kw:
        assert pr[0]["variable"] == "x1"
        assert sum(r["percentage"] for r in pr) == pytest.approx(1.0)


def test_permutation_varimp_classifier(models):
    jf, pf, jg, _, pg, _ = models
    for kw in (dict(seed=42), dict(metric="AUC", seed=3)):
        _pvi_close(pex.permutation_varimp(pg, pf, **kw),
                   jex.permutation_varimp(jg, jf, **kw))


def test_the_shuffle_is_numpys_shuffle_of_the_values():
    """The port shuffles an index with the generator the reference
    shuffles the values with: the same permutation."""
    vals = np.random.default_rng(0).normal(size=777).astype(np.float32)
    a, idx = vals.copy(), np.arange(777)
    np.random.default_rng(9).shuffle(a)
    np.random.default_rng(9).shuffle(idx)
    np.testing.assert_array_equal(a, vals[idx])


def test_port_trained_models_explain_as_the_reference_tests_ask():
    """tests/test_explanation.py's assertions on models the port trains."""
    cols = bin_cols(400)
    fr = Frame.from_arrays(cols)
    x = ["x0", "x1", "x2", "cat"]
    m1 = GBM(ntrees=10, max_depth=3, seed=1).train(x=x, y="y",
                                                    training_frame=fr)
    m2 = GLM(family="binomial", lambda_=0.0).train(x=x, y="y",
                                                    training_frame=fr)
    t0 = pex.partial_dependence(m1, fr, "x0", nbins=8)[0]
    resp = t0.vec("mean_response").to_numpy()
    assert t0.nrows == 8 and resp[-1] > resp[0] + 0.1
    assert pex.ice(m1, fr, "x0", nbins=5, max_rows=10).nrows == 50
    assert pex.shap_summary(m1, fr)[0][0] in ("x0", "x1", "cat")
    bundle = pex.explain([m1, m2], fr)
    assert np.array(bundle["model_correlation"]["matrix"])[0, 1] > 0.7
    assert "shap_summary" in bundle["models"][m1.key]


# -- the data plane: string vecs and row gathers ----------------------------

def test_string_vec_and_labels():
    v = Vec.from_numpy(np.array(["a", None, "c"], dtype=object), VecType.STR)
    assert v.data is None and v.device is None and v.nrows == 3
    assert list(v.to_numpy()) == ["a", None, "c"]
    fr = Frame(["s", "n"], [v, Vec.from_numpy(np.float32([1, 2, 3]))])
    assert fr.nrows == 3 and fr.device == torch.device("cpu")
    c = Frame.from_arrays({"c": np.array(["q", None, "p"], dtype=object)})
    assert c.vec("c").is_categorical
    assert list(c.vec("c").labels()) == ["q", None, "p"]
    with pytest.raises(ValueError):
        v.labels()


def test_gather_rows_with_missing_rows():
    from h2o3_tpu.frame.types import VecType as JVecType
    from h2o3_tpu.frame.vec import Vec as JVec
    from h2o3_tpu.rapids.munge import gather_rows as jgather
    num = np.float32([1.5, np.nan, 3.0, 4.0, -2.0])
    cat = np.array(["b", "a", None, "c", "a"], dtype=object)
    strs = np.array(["s0", "s1", None, "s3", "s4"], dtype=object)
    idx = np.array([4, -1, 0, 2, 2, -1, 3])
    pf = Frame(["n", "c", "s"], [Vec.from_numpy(num),
                                 Frame.from_arrays({"c": cat}).vec("c"),
                                 Vec.from_numpy(strs, VecType.STR)])
    jf = JFrame(["n", "c", "s"], [JVec.from_numpy(num),
                                  JFrame.from_arrays({"c": cat}).vec("c"),
                                  JVec.from_numpy(strs, JVecType.STR)])
    pg, jg = gather_rows(pf, idx), jgather(jf, idx)
    assert pg.nrows == jg.nrows == len(idx)
    np.testing.assert_array_equal(pg.vec("n").to_numpy(),
                                  jg.vec("n").to_numpy()[: len(idx)])
    assert list(pg.vec("c").labels()) == list(jg.vec("c").labels())
    assert pg.vec("c").domain == tuple(jg.vec("c").domain)
    assert list(pg.vec("s").to_numpy()) == list(jg.vec("s").to_numpy())
    assert list(pg.vec("s").to_numpy()) == ["s4", None, "s0", None, None,
                                            None, "s3"]
    same = gather_rows(pf, torch.as_tensor(idx))
    assert list(same.vec("s").to_numpy()) == list(pg.vec("s").to_numpy())
