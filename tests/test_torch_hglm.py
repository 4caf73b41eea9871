"""HGLM in the port (h2o3_tpu_torch/models/hglm.py) against the JAX
reference (``h2o3_tpu/models/hglm.py``) on the same numpy-seeded frames: a
random intercept and a random slope per group, a categorical fixed effect,
missing values, and a scoring frame with a group never seen in training.
Row counts are multiples of 64 (the reference's pad rows enter weighted
sums, ROADMAP queue C).

Tolerances: one EM step (fixed effects, random effects, their covariances
and both variances) at rtol 1e-5 with an absolute floor of 1e-6 x each
output's largest entry; the whole fit's coefficients, random effects,
variances and predictions at rtol 1e-4 with the same kind of floor (EM
iterates a few dozen float32 steps, each within 1e-5 of the other's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import hglm as jhglm
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.models import hglm as phglm
from jax_reference import _jax_compile_cache  # noqa: F401

N, G = 640, 12


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def hglm_cols(n=N, seed=0, groups=G, names=None):
    """y = 1 + 2 x1 - x2 + 0.5 [c = v] + u0_g + u1_g x1 + noise."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n)
    u0, u1 = rng.normal(scale=1.0, size=groups), rng.normal(scale=0.5,
                                                            size=groups)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    c = rng.choice(np.array(["u", "v"]), n)
    y = 1 + 2 * x1 - x2 + 0.5 * (c == "v") + u0[g] + u1[g] * x1 \
        + rng.normal(scale=0.3, size=n)
    x2 = x2.astype(np.float32)
    x2[rng.random(n) < 0.03] = np.nan
    y = y.astype(np.float32)
    y[rng.random(n) < 0.02] = np.nan
    names = names or [f"g{i:02d}" for i in range(groups)]
    return dict(x1=x1.astype(np.float32), x2=x2, c=c,
                grp=np.array(names)[g], y=y)


def test_em_step_matches_reference():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    Zr = np.stack([np.ones(N), rng.normal(size=N)], 1).astype(np.float32)
    gid = rng.integers(0, G, N).astype(np.int32)
    y = rng.normal(size=N).astype(np.float32)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    beta = np.float32([0.5, -0.3, 0.2, 1.0])
    want = jhglm._em_step(*(jnp.asarray(a) for a in (X, Zr, gid, y, w,
                                                     beta)),
                          jnp.float32(0.7), jnp.float32(1.3), G, 2)
    got = phglm._em_step(*(torch.from_numpy(a) for a in (X, Zr)),
                         torch.from_numpy(gid).long(),
                         *(torch.from_numpy(a) for a in (y, w, beta)),
                         torch.tensor(0.7), torch.tensor(1.3), G, 2)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_z_design_matches_reference():
    cols = hglm_cols()
    got = phglm._z_design(Frame.from_arrays(cols), ["x2", "x1"]).numpy()
    want = np.asarray(jhglm._z_design(JFrame.from_arrays(cols),
                                      ["x2", "x1"]))[:N]
    np.testing.assert_array_equal(got, want)


def fit_pair(**kw):
    cols = hglm_cols()
    jm = jhglm.HGLM(group_column="grp", **kw).train(
        x=["x1", "x2", "c"], y="y", training_frame=JFrame.from_arrays(cols))
    pm = phglm.HGLM(group_column="grp", **kw).train(
        x=["x1", "x2", "c"], y="y", training_frame=Frame.from_arrays(cols))
    return jm, pm


def _close(a, b, rtol=1e-4):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                               atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("random_columns", [None, ["x1"]])
def test_fit_matches_reference(random_columns):
    jm, pm = fit_pair(random_columns=random_columns)
    jo, po = jm.output, pm.output
    assert po["coef_names"] == jo["coef_names"]
    assert po["group_domain"] == tuple(jo["group_domain"])
    assert po["iterations"] == jo["iterations"]
    _close(po["coef"], jo["coef"])
    _close(po["u"].numpy(), jo["u"])
    _close([po["sig_u"], po["sig_e"]], [jo["sig_u"], jo["sig_e"]])
    for lvl, d in pm.ranef().items():
        _close(list(d.values()), list(jm.ranef()[lvl].values()))
    # a frame with an unseen group and the levels in another order
    test = hglm_cols(n=64, seed=9, groups=3, names=["g03", "g00", "zz"])
    got = pm.predict(Frame.from_arrays(test)).vec("predict").to_numpy()
    want = jm.predict(JFrame.from_arrays(test)).vec("predict").to_numpy()[:64]
    _close(got, want)


def test_reference_model_scores_alike_through_convert():
    jm, _ = fit_pair(random_columns=["x1"])
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    pm = convert.hglm_model(out, dataclasses.asdict(jm.data_info), "y",
                            dict(jm.params), device="cpu")
    cols = hglm_cols(seed=4)
    _close(pm.predict(Frame.from_arrays(cols)).vec("predict").to_numpy(),
           jm.predict(JFrame.from_arrays(cols)).vec("predict").to_numpy()[:N],
           rtol=1e-5)


def test_refusals():
    fr = Frame.from_arrays(hglm_cols())
    with pytest.raises(ValueError, match="group_column is required"):
        phglm.HGLM().train(x=["x1"], y="y", training_frame=fr)
    with pytest.raises(ValueError, match="must be categorical"):
        phglm.HGLM(group_column="x2").train(x=["x1"], y="y",
                                            training_frame=fr)
    with pytest.raises(ValueError, match="must be numeric"):
        phglm.HGLM(group_column="grp", random_columns=["c"]).train(
            x=["x1"], y="y", training_frame=fr)
    with pytest.raises(ValueError, match="max_iterations"):
        phglm.HGLM(group_column="grp", max_iterations=0).train(
            x=["x1"], y="y", training_frame=fr)
    assert fr.vec("grp").type is VecType.CAT
