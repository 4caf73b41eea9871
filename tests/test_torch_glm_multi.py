"""The port's multinomial and ordinal GLMs against the JAX reference, and
``convert.glm_model``: reference-trained binomial (categoricals and
interactions), multinomial and ordinal GLMs scored by the port.

Multinomial: iterations equal, deviance rtol 1e-5, coefficients rtol 1e-4
with an atol of 1e-5 × max|beta|, probabilities rtol 1e-5 (atol 1e-6).
Ordinal: nll rtol 1e-4, class probabilities and thresholds atol 1e-4
over 200 Adam steps (max_iterations 10). Past a few hundred steps Adam at
lr 0.5 (the reference's solver) no longer settles but bounces around the
optimum, and the last bits of the float32 sums decide where it stops:
scaling one input column by 1 + 2^-23 moves the port's own probabilities
by up to 9e-3 at the default 1000 steps, and the two packages were
measured 6.5e-2 apart in probability and 1.7e-3 in nll on this frame. So
at the default the check is that both land near the same optimum: nll
rtol 5e-3, probabilities atol 0.1 (the thresholds, which trade against
the coefficients there, are compared at 10 only).
Converted models score at rtol 1e-5 (atol 1e-6) on the probabilities.
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import convert, set_device
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
    cols = glm_cols(3000, seed=3)
    rng = np.random.default_rng(4)
    x0 = np.nan_to_num(cols["x0"])
    x1 = np.nan_to_num(cols["x1"])
    score3 = np.stack([0.9 * x0, -0.7 * x1, 0.8 * cols["x2"]], 1) \
        + rng.gumbel(size=(3000, 3))
    cols["y3"] = np.array(["k0", "k1", "k2"])[score3.argmax(1)]
    score4 = np.concatenate([score3, (0.6 * cols["x3"])[:, None]
                             + rng.gumbel(size=(3000, 1))], 1)
    cols["y4"] = np.array(["k0", "k1", "k2", "k3"])[score4.argmax(1)]
    lat = 1.1 * x0 - 0.6 * cols["x2"] + rng.logistic(size=3000)
    cols["yo"] = np.array(["1lo", "2mid", "3hi", "4top"])[
        np.digitize(lat, [-1.0, 0.2, 1.3])]
    return cols


@pytest.mark.parametrize("y,alpha,lam", [("y3", 0.0, 0.0), ("y3", 1.0, 2e-3),
                                         ("y4", 0.0, 1e-3),
                                         ("y4", 0.5, 2e-3)])
def test_multinomial(cols, y, alpha, lam):
    jm, pm, jf, pf = fit_both(cols, NUM + ["c1"], y, family="multinomial",
                              alpha=alpha, lambda_=lam)
    assert_same_fit(jm, pm, jf, pf)
    np.testing.assert_array_equal(pm.output["beta"].numpy() == 0,
                                  np.asarray(jm.output["beta"]) == 0)
    jc, pc = jm.coef(), pm.coef()
    assert list(pc) == list(jc) == [f"coefs_class_{k}" for k in
                                    range(int(y[1]))]
    np.testing.assert_allclose(pm.training_metrics.logloss,
                               jm.training_metrics.logloss, rtol=1e-5)
    assert [r[0] for r in pm.varimp()] == [r[0] for r in jm.varimp()]


@pytest.mark.parametrize("max_iterations,atol,nll_rtol", [(10, 1e-4, 1e-4),
                                                          (50, 0.1, 5e-3)])
def test_ordinal(cols, max_iterations, atol, nll_rtol):
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = JGLM(family="ordinal", max_iterations=max_iterations).train(
        x=NUM + ["c1"], y="yo", training_frame=jf)
    pm = GLM(family="ordinal", max_iterations=max_iterations).train(
        x=NUM + ["c1"], y="yo", training_frame=pf)
    assert pm.output["iterations"] == jm.output["iterations"]
    np.testing.assert_allclose(pm.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=nll_rtol)
    probs = pm._score_raw(pf).numpy()
    np.testing.assert_allclose(probs, np.asarray(jm._score_raw(jf))[:3000],
                               atol=atol)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    if max_iterations == 10:
        np.testing.assert_allclose(pm.output["ordinal_theta_orig"],
                                   jm.output["ordinal_theta_orig"],
                                   atol=atol)
    assert pm.nclasses == 4


def _data_info(jm) -> dict:
    return dataclasses.asdict(jm.data_info)


def _carried(jm):
    out = {k: (np.asarray(v) if k in ("beta", "ordinal_theta") else v)
           for k, v in jm.output.items()}
    return convert.glm_model(out, _data_info(jm), jm.response_column,
                             jm.response_domain, dict(jm.params))


@pytest.mark.parametrize("case", ["binomial", "multinomial", "ordinal"])
def test_convert_scores_alike(cols, case):
    jf = JFrame.from_arrays(cols)
    if case == "binomial":
        jm = JGLM(family="binomial", interactions=["c1", "x3"],
                  offset_column="off").train(x=NUM[:3] + ["c1", "c2"],
                                             y="yb", training_frame=jf)
    elif case == "multinomial":
        jm = JGLM(family="multinomial").train(x=NUM + ["c1"], y="y3",
                                              training_frame=jf)
    else:
        jm = JGLM(family="ordinal", max_iterations=5).train(
            x=NUM + ["c1"], y="yo", training_frame=jf)
    pm = _carried(jm)
    # a scoring frame of another seed, with c2's level "w" missing
    test = glm_cols(1200, seed=8)
    test["c2"] = np.where(test["c2"] == "w", None, test["c2"])
    test.update({k: cols[k][:1200] for k in ("y3", "yo")})
    jt, pt = JFrame.from_arrays(test), Frame.from_arrays(test)
    np.testing.assert_allclose(pm._score_raw(pt).numpy(),
                               np.asarray(jm._score_raw(jt))[:1200],
                               rtol=1e-5, atol=1e-6)
    assert pm.coef().keys() == jm.coef().keys()
    pred = pm.predict(pt)
    assert pred.names[0] == "predict" and pred.nrows == 1200
