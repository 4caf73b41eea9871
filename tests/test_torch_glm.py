"""The port's dense GLM (h2o3_tpu_torch/models/glm.py) against the JAX
reference ``h2o3_tpu.models.glm.GLM``: every family of IRLS with weights
and an offset, the missing-value modes, interactions, validation metrics,
the scoring history, varimp and the refusals.

The reference runs on tests/conftest.py's 8 virtual devices: its columns
are padded (per-row outputs are cut to ``nrows``) and its Gram is a sum of
per-device partials, while the port sums row blocks; so the float32 sums
differ in their last bits. Stated tolerances: per-iteration and final
deviances rtol 1e-5; coefficients (``coef`` and ``coef_norm``) rtol 1e-4
with an atol of 1e-5 × max|beta|; predictions rtol 1e-5 with an atol of
1e-6 × max(1, max|prediction|), for predictions near 0; iteration counts
equal.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import GLM

ROWS = 4000
NUM = [f"x{i}" for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def glm_cols(rows=ROWS, seed=0):
    """Six numeric columns (x1 5% NaN), two categoricals (c1: 4 levels,
    c2: 3 levels with 3% missing), a weight and an offset column, and a
    response per family from one linear predictor."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 6)).astype(np.float32)
    cols = {f"x{i}": X[:, i].copy() for i in range(6)}
    cols["x1"][rng.random(rows) < 0.05] = np.nan
    c1 = rng.integers(0, 4, rows)
    c2 = rng.integers(0, 3, rows)
    cols["c1"] = np.array(["a", "b", "c", "d"])[c1]
    c2s = np.array(["u", "v", "w"], dtype=object)[c2]
    c2s[rng.random(rows) < 0.03] = None
    cols["c2"] = c2s
    eta = (0.8 * X[:, 0] - 0.5 * X[:, 1] + 0.3 * X[:, 2] + 0.1 * X[:, 3]
           + np.array([0.0, 0.5, -0.3, 0.2])[c1])
    cols["w"] = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    cols["off"] = (0.1 * rng.normal(size=rows)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-eta))
    cols["yb"] = np.where(rng.random(rows) < p, "Y", "N")
    cols["yg"] = (eta + rng.normal(size=rows)).astype(np.float32)
    mu = np.exp(0.3 * eta)
    cols["yp"] = rng.poisson(mu).astype(np.float32)
    cols["ygam"] = rng.gamma(2.0, mu / 2.0).astype(np.float32)
    cols["yt"] = (rng.gamma(2.0, mu / 2.0)
                  * (rng.random(rows) < 0.7)).astype(np.float32)
    cols["yq"] = np.clip(p + 0.1 * rng.normal(size=rows), 0, 1).astype(
        np.float32)
    return cols


@pytest.fixture(scope="module")
def cols():
    return glm_cols()


def fit_both(cols, x, y, **params):
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jb, pb = JGLM(**params), GLM(**params)
    jm = jb.train(x=x, y=y, training_frame=jf)
    pm = pb.train(x=x, y=y, training_frame=pf)
    return jm, pm, jf, pf


def _beta(m):
    return np.asarray(m.output["beta"].cpu() if isinstance(
        m.output["beta"], torch.Tensor) else m.output["beta"])


def assert_same_fit(jm, pm, jf, pf, coef_rtol=1e-4, pred_rtol=1e-5):
    n = pf.nrows
    assert pm.output["iterations"] == jm.output["iterations"]
    assert pm.output["coef_names"] == jm.output["coef_names"]
    np.testing.assert_allclose(pm.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=1e-5)
    jbeta = _beta(jm)
    atol = 1e-5 * np.abs(jbeta).max()
    np.testing.assert_allclose(_beta(pm), jbeta, rtol=coef_rtol, atol=atol)
    jcoef = np.asarray(jm.output["coef"])
    np.testing.assert_allclose(pm.output["coef"], jcoef, rtol=coef_rtol,
                               atol=1e-5 * np.abs(jcoef).max())
    for d, jd in ((pm.coef(), jm.coef()), (pm.coef_norm(), jm.coef_norm())):
        assert list(d) == list(jd)
        if jm.params["family"] not in ("multinomial", "ordinal"):
            assert list(d) == jm.output["coef_names"] + ["Intercept"]
    jr = np.asarray(jm._score_raw(jf))[:n]
    pr = pm._score_raw(pf).numpy()
    np.testing.assert_allclose(pr, jr, rtol=pred_rtol,
                               atol=1e-6 * max(1.0, np.abs(jr).max()))


def _history(m):
    cols, rows = m.scoring_history
    return [c[0] for c in cols], np.array([r[2:] for r in rows], np.float64)


FAMILIES = [("gaussian", "yg"), ("binomial", "yb"), ("poisson", "yp"),
            ("gamma", "ygam"), ("tweedie", "yt"),
            ("negativebinomial", "yp"), ("quasibinomial", "yq")]


@pytest.mark.parametrize("family,y", FAMILIES)
def test_family_with_weights_and_offset(cols, family, y):
    extra = dict(theta=0.5) if family == "negativebinomial" else {}
    jm, pm, jf, pf = fit_both(cols, NUM + ["c1", "c2"], y, family=family,
                              weights_column="w", offset_column="off",
                              **extra)
    assert_same_fit(jm, pm, jf, pf)
    # the per-iteration deviances (scoring history) step for step
    jn, jh = _history(jm)
    pn, ph = _history(pm)
    assert pn == jn
    np.testing.assert_allclose(ph, jh, rtol=1e-5)
    np.testing.assert_allclose(pm.output["null_deviance"],
                               jm.output["null_deviance"], rtol=1e-5)


@pytest.mark.parametrize("mode,extra", [
    ("MeanImputation", {}), ("Skip", {}),
    ("PlugValues", dict(plug_values={"x1": 0.7}))])
def test_missing_value_modes(cols, mode, extra):
    jm, pm, jf, pf = fit_both(cols, NUM + ["c1", "c2"], "yb",
                              family="binomial",
                              missing_values_handling=mode, **extra)
    assert_same_fit(jm, pm, jf, pf)
    assert pm.training_metrics.nobs == jm.training_metrics.nobs
    np.testing.assert_allclose(pm.training_metrics.auc,
                               jm.training_metrics.auc, rtol=1e-6)


@pytest.mark.parametrize("kind,x,inter", [
    # the source columns left out of x, so that the design has full rank
    ("cat_x_cat", NUM, ["c1", "c2"]),
    ("cat_x_num", NUM[:3] + ["c2"], ["c1", "x3"]),
    ("num_x_num", NUM[:3] + ["c1"], ["x3", "x4"]),
])
def test_interactions(cols, kind, x, inter):
    jm, pm, jf, pf = fit_both(cols, x, "yg", family="gaussian",
                              interactions=inter)
    assert_same_fit(jm, pm, jf, pf)
    assert pm.output["interaction_domains"] == {
        c: tuple(d) for c, d in jm.output["interaction_domains"].items()}


def test_collinear_interactions_predict_alike(cols):
    """Main effects beside their cross span the same space: the jitter
    picks the coefficients, which differ with the last bits of the Gram,
    while the predictions do not."""
    jm, pm, jf, pf = fit_both(cols, NUM + ["c1", "c2"], "yb",
                              family="binomial",
                              interactions=["c1", "c2", "x3"])
    assert pm.output["iterations"] == jm.output["iterations"]
    assert pm.output["coef_names"] == jm.output["coef_names"]
    np.testing.assert_allclose(pm._score_raw(pf).numpy(),
                               np.asarray(jm._score_raw(jf))[:pf.nrows],
                               rtol=1e-5, atol=1e-6)


def test_validation_history_and_varimp(cols):
    vcols = glm_cols(1500, seed=9)
    jb, pb = JGLM(family="binomial"), GLM(family="binomial")
    jm = jb.train(x=NUM + ["c1", "c2"], y="yb",
                  training_frame=JFrame.from_arrays(cols),
                  validation_frame=JFrame.from_arrays(vcols))
    pm = pb.train(x=NUM + ["c1", "c2"], y="yb",
                  training_frame=Frame.from_arrays(cols),
                  validation_frame=Frame.from_arrays(vcols))
    for a, b in ((pm.training_metrics, jm.training_metrics),
                 (pm.validation_metrics, jm.validation_metrics)):
        assert a.nobs == b.nobs
        np.testing.assert_allclose([a.auc, a.logloss, a.mse],
                                   [b.auc, b.logloss, b.mse], rtol=1e-5)
    jn, jh = _history(jm)
    pn, ph = _history(pm)
    assert pn == jn == ["timestamp", "duration", "iterations",
                        "negative_log_likelihood", "objective"]
    np.testing.assert_allclose(ph, jh, rtol=1e-5)
    jv, pv = jm.varimp(), pm.varimp()
    assert [r[0] for r in pv] == [r[0] for r in jv]
    np.testing.assert_allclose([r[1:] for r in pv], [r[1:] for r in jv],
                               rtol=1e-4)
    assert {r[0] for r in pv} == set(NUM + ["c1", "c2"])


def test_train_weights_argument(cols):
    wts = np.random.default_rng(4).uniform(0, 2, ROWS).astype(np.float32)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    import jax.numpy as jnp
    jpad = np.zeros(jf.plen, np.float32)
    jpad[:ROWS] = wts
    jm = JGLM(family="poisson").train(x=NUM, y="yp", training_frame=jf,
                                      weights=jnp.asarray(jpad))
    pm = GLM(family="poisson").train(x=NUM, y="yp", training_frame=pf,
                                     weights=torch.from_numpy(wts))
    assert_same_fit(jm, pm, jf, pf)


@pytest.mark.parametrize("family,y,resolved", [("AUTO", "yb", "binomial"),
                                               ("AUTO", "yg", "gaussian"),
                                               ("gaussian", "yb", "binomial")])
def test_family_resolution(cols, family, y, resolved):
    jm, pm, jf, pf = fit_both(cols, NUM[:3], y, family=family)
    assert pm.params["family"] == jm.params["family"] == resolved
    assert_same_fit(jm, pm, jf, pf)


def test_max_iterations_rules(cols):
    jm, pm, jf, pf = fit_both(cols, NUM, "yb", family="binomial",
                              max_iterations=-1)
    assert pm.params["max_iterations"] == 50
    assert_same_fit(jm, pm, jf, pf)
    jm, pm, jf, pf = fit_both(cols, NUM, "yb", family="binomial",
                              max_iterations=2, beta_epsilon=0.0)
    assert pm.output["iterations"] == jm.output["iterations"] == 2
    with pytest.raises(ValueError, match="max_iterations"):
        GLM(max_iterations=0).train(x=NUM, y="yg",
                                    training_frame=Frame.from_arrays(cols))


@pytest.mark.parametrize("params,exc,match", [
    (dict(nfolds=1), ValueError, "nfolds"),
    (dict(fold_column="c1", nfolds=3), ValueError, "fold_column"),
    (dict(nfolds=3, keep_cross_validation_predictions=True,
          checkpoint="glm_1"), NotImplementedError, "checkpoint"),
    (dict(max_runtime_secs=10.0), ValueError, "max_runtime_secs"),
    (dict(custom_metric_func="python:k=m.C"), ValueError,
     "custom_metric_func"),
    (dict(solver="L_BFGS"), NotImplementedError, "L_BFGS"),
    (dict(checkpoint="glm_1"), NotImplementedError, "checkpoint"),
    (dict(missing_values_handling="PlugValues", plug_values="key"),
     KeyError, "key"),
])
def test_refused_parameters_raise_by_name(cols, params, exc, match):
    with pytest.raises(exc, match=match):
        GLM(family="gaussian", **params).train(
            x=NUM, y="yg", training_frame=Frame.from_arrays(cols))


@pytest.mark.parametrize("family,y,match", [
    ("binomial", "yg", "categorical"), ("multinomial", "yg", "categorical"),
    ("poisson", "c1", "binary or numeric")])
def test_family_errors_match_reference(cols, family, y, match):
    with pytest.raises(ValueError, match=match):
        JGLM(family=family).train(x=NUM, y=y,
                                  training_frame=JFrame.from_arrays(cols))
    with pytest.raises(ValueError, match=match):
        GLM(family=family).train(x=NUM, y=y,
                                 training_frame=Frame.from_arrays(cols))


def test_full_fp32_restores_the_callers_setting():
    from h2o3_tpu_torch.models.glm import full_fp32
    m = torch.backends.cuda.matmul
    m.allow_tf32 = True
    try:
        with full_fp32():
            if hasattr(m, "fp32_precision"):
                assert m.fp32_precision == "ieee"
            else:
                assert torch.get_float32_matmul_precision() == "highest"
        assert m.allow_tf32
    finally:
        m.allow_tf32 = False
    assert not m.allow_tf32


@pytest.fixture
def cuda_device():
    """The card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (TF32 exists only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gram_ignores_tf32_on_the_card(cuda_device, cols):
    """The coefficients are the same bit for bit with TF32 allowed (by the
    caller, through either API) and with it off."""
    fr = Frame.from_arrays(cols, device=cuda_device)
    m = torch.backends.cuda.matmul

    def fit():
        return GLM(family="binomial").train(
            x=NUM + ["c1", "c2"], y="yb", training_frame=fr
        ).output["beta"].cpu()

    off = fit()
    m.allow_tf32 = True
    try:
        legacy = fit()
    finally:
        m.allow_tf32 = False
    assert torch.equal(off, legacy)
