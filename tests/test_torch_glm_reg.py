"""The port's GLM regularisation and inference against the JAX reference:
ridge, lasso and elastic net through the proximal (ADMM) pass,
``non_negative`` by projected coordinate descent, ``beta_constraints`` as
a dict and as rows, ``lambda_search`` and Wald p-values.

Tolerances as in test_torch_glm.py (the two packages' float32 sums differ
in their last bits): coefficients rtol 1e-4 with an atol of 1e-5 ×
max|beta|, deviances rtol 1e-5, the lambda grid rtol 1e-6, path
deviances rtol 1e-4, standard errors, z and p rtol 1e-4; zero patterns
and iteration counts equal.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import GLM

from test_torch_glm import NUM, assert_same_fit, fit_both, glm_cols
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cols():
    cols = glm_cols(3000, seed=1)
    # four pure-noise columns, so that the lasso has something to drop
    rng = np.random.default_rng(2)
    for i in range(6, 10):
        cols[f"x{i}"] = rng.normal(size=3000).astype(np.float32)
    return cols


X_COLS = NUM + [f"x{i}" for i in range(6, 10)] + ["c1"]


@pytest.mark.parametrize("family,y,alpha,lam", [
    ("gaussian", "yg", 0.0, 1e-2),      # ridge
    ("binomial", "yb", 0.0, 1e-3),      # ridge
    ("binomial", "yb", 1.0, 5e-3),      # lasso
    ("binomial", "yb", 0.5, 1e-2),      # elastic net
    ("poisson", "yp", 0.5, 5e-3),       # elastic net
])
def test_penalties(cols, family, y, alpha, lam):
    jm, pm, jf, pf = fit_both(cols, X_COLS, y, family=family, alpha=alpha,
                              lambda_=lam)
    assert_same_fit(jm, pm, jf, pf)
    jz = np.asarray(jm.output["beta"]) == 0
    pz = pm.output["beta"].numpy() == 0
    np.testing.assert_array_equal(pz, jz)
    if alpha == 1.0:
        assert pz.sum() >= 2            # the lasso dropped noise columns


@pytest.mark.parametrize("family,y", [("binomial", "yb"), ("gaussian", "yg")])
def test_non_negative(cols, family, y):
    jm, pm, jf, pf = fit_both(cols, X_COLS, y, family=family,
                              non_negative=True)
    assert_same_fit(jm, pm, jf, pf)
    assert (pm.output["beta"][:-1] >= 0).all()
    np.testing.assert_array_equal(pm.output["beta"].numpy() == 0,
                                  np.asarray(jm.output["beta"]) == 0)


@pytest.mark.parametrize("form", ["dict", "rows"])
@pytest.mark.parametrize("standardize", [True, False])
def test_beta_constraints(cols, form, standardize):
    bounds = {"x0": (-1.0, 0.5), "x2": (0.0, 0.1), "c1.b": (None, 0.2)}
    if not standardize:
        bounds["Intercept"] = (-0.3, 0.3)
    bc = bounds if form == "dict" else [
        dict(names=k, lower_bounds=lo, upper_bounds=hi)
        for k, (lo, hi) in bounds.items()]
    jm, pm, jf, pf = fit_both(cols, X_COLS, "yb", family="binomial",
                              beta_constraints=bc, standardize=standardize)
    assert_same_fit(jm, pm, jf, pf)
    coef = pm.coef()
    assert coef["x0"] <= 0.5 + 1e-6 and 0.0 <= coef["x2"] <= 0.1 + 1e-6


def test_intercept_bound_under_standardization_raises(cols):
    bc = {"Intercept": (-0.1, 0.1)}
    with pytest.raises(ValueError, match="Intercept"):
        JGLM(family="binomial", beta_constraints=bc).train(
            x=X_COLS, y="yb", training_frame=JFrame.from_arrays(cols))
    with pytest.raises(ValueError, match="Intercept"):
        GLM(family="binomial", beta_constraints=bc).train(
            x=X_COLS, y="yb", training_frame=Frame.from_arrays(cols))
    with pytest.raises(ValueError, match="unknown coefficients"):
        GLM(family="binomial", beta_constraints={"nope": (0, 1)}).train(
            x=X_COLS, y="yb", training_frame=Frame.from_arrays(cols))


@pytest.mark.parametrize("family,y,alpha", [("binomial", "yb", 0.5),
                                            ("gaussian", "yg", 1.0)])
def test_lambda_search(cols, family, y, alpha):
    jm, pm, jf, pf = fit_both(cols, X_COLS, y, family=family, alpha=alpha,
                              lambda_search=True, nlambdas=15,
                              lambda_min_ratio=1e-3)
    jp, pp = jm.get_regularization_path(), pm.get_regularization_path()
    assert len(pp) == len(jp)
    np.testing.assert_allclose([e["lambda_"] for e in pp],
                               [e["lambda_"] for e in jp], rtol=1e-6)
    np.testing.assert_allclose([e["deviance"] for e in pp],
                               [e["deviance"] for e in jp], rtol=1e-4)
    assert [e["nonzero"] for e in pp] == [e["nonzero"] for e in jp]
    assert pm.output["lambda_best"] == pytest.approx(
        jm.output["lambda_best"], rel=1e-6)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a["beta"], np.asarray(b["beta"]),
                                   rtol=1e-4,
                                   atol=1e-5 * np.abs(b["beta"]).max())
    assert_same_fit(jm, pm, jf, pf)
    # the scoring history holds every IRLS iteration of the path
    assert len(pm.scoring_history[1]) == len(jm.scoring_history[1])


@pytest.mark.parametrize("family,y,standardize", [
    ("gaussian", "yg", True), ("binomial", "yb", True),
    ("poisson", "yp", False), ("gamma", "ygam", True)])
def test_p_values(cols, family, y, standardize):
    jm, pm, jf, pf = fit_both(cols, NUM + ["c1"], y, family=family,
                              compute_p_values=True, standardize=standardize)
    assert_same_fit(jm, pm, jf, pf)
    for k in ("std_errs", "z_values", "p_values"):
        np.testing.assert_allclose(pm.output[k], np.asarray(jm.output[k]),
                                   rtol=1e-4, atol=1e-12, err_msg=k)
    jt, pt = jm.coef_table(), pm.coef_table()
    assert [r["name"] for r in pt] == [r["name"] for r in jt]
    for a, b in zip(pt, jt):
        np.testing.assert_allclose(
            [a[k] for k in ("coefficient", "std_error", "z_value")],
            [b[k] for k in ("coefficient", "std_error", "z_value")],
            rtol=1e-4, atol=1e-6)


def test_p_values_refuse_regularization(cols):
    with pytest.raises(ValueError, match="lambda=0"):
        GLM(family="binomial", compute_p_values=True, lambda_=1e-3).train(
            x=NUM, y="yb", training_frame=Frame.from_arrays(cols))
    with pytest.raises(ValueError, match="compute_p_values"):
        GLM(family="binomial").train(
            x=NUM, y="yb", training_frame=Frame.from_arrays(cols)
        ).coef_table()
