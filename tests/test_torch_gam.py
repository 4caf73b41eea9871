"""GAM in the port (h2o3_tpu_torch/models/gam.py) against the JAX reference
(``h2o3_tpu/models/gam.py``) on the same numpy-seeded frames: a cubic
regression spline, a 1-D and a 2-D thin plate and a monotone I-spline,
with missing values in the smoothed columns.

Tolerances: the four bases and the quantile knots at rtol 1e-6 (float32
elementwise maps; XLA on the CPU may fuse a multiply-add that torch rounds
twice), with an absolute floor of 1e-6 x a basis' largest entry (cubes of
|x - knot| near 30 cancel against each other). The fitted coefficients
at rtol 1e-4 with a floor of 1e-3 x their largest, predictions at rtol
1e-4 with a floor of 1e-4 x their largest: the cubic and thin-plate
columns make the Gram ill-conditioned (condition number 2.6e5 on the
gaussian case's design), so each package's float32 Cholesky leaves
differences of 1e-4 in the coefficients (4e-4 of the largest seen) and
2.6e-5 of the largest prediction.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import gam as jgam
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import gam as pgam

N = 640
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def gam_cols(n=N, seed=0, binomial=False):
    """y = sin(x0) + (x1/2)^2 + exp(-(x2^2 + x3^2)) + 0.3 x4 + log1p(x5)
    (monotone in x5) + noise; a few missing values in x0, x2 and x5."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, size=(n, 5)).astype(np.float32)
    x5 = rng.uniform(0, 5, n).astype(np.float32)
    eta = np.sin(x[:, 0]) + (x[:, 1] / 2) ** 2 \
        + np.exp(-(x[:, 2] ** 2 + x[:, 3] ** 2)) + 0.3 * x[:, 4] + np.log1p(x5)
    cols = {f"x{i}": x[:, i].copy() for i in range(5)}
    cols["x5"] = x5
    for c in ("x0", "x2", "x5"):
        cols[c][rng.random(n) < 0.02] = np.nan
    if binomial:
        p = 1 / (1 + np.exp(-(eta - eta.mean())))
        cols["y"] = np.where(rng.random(n) < p, "1", "0")
    else:
        cols["y"] = (eta + rng.normal(scale=0.2, size=n)).astype(np.float32)
    return cols


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def basis_inputs():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-3, 3, 400),
                        [-3.0, -2.5, 0.0, 2.999, 3.0, 3.5, -4.0]]
                       ).astype(np.float32)
    knots = np.float32([-2.9, -1.2, 0.1, 1.7, 2.95])
    return x, knots


def test_ncs_and_thin_plate_bases_match_reference(basis_inputs):
    x, knots = basis_inputs
    tx, tk = torch.from_numpy(x), torch.from_numpy(knots)
    _close(pgam._ncs_basis(tx, tk).numpy(),
           jgam._ncs_basis(jnp.asarray(x), jnp.asarray(knots)))
    _close(pgam._tp_basis_1d(tx, tk).numpy(),
           jgam._tp_basis_1d(jnp.asarray(x), jnp.asarray(knots)))
    k2 = np.stack([knots, knots[::-1] * 0.7], 1)
    x2 = x[::-1].copy()
    _close(pgam._tp_basis_2d(tx, torch.from_numpy(x2), k2).numpy(),
           jgam._tp_basis_2d(jnp.asarray(x), jnp.asarray(x2), k2))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_b_and_i_spline_bases_match_reference(basis_inputs, degree):
    x, knots = basis_inputs
    tx = torch.from_numpy(x)
    got_b = pgam._bspline_basis(tx, knots, degree).numpy()
    _close(got_b, jgam._bspline_basis(jnp.asarray(x), knots, degree))
    # inside the knots the B-splines sum to 1; at and beyond the last knot
    # too (clipped to the float32 below it)
    np.testing.assert_allclose(got_b.sum(1), 1.0, atol=1e-6)
    _close(pgam._ispline_basis(tx, knots, degree).numpy(),
           jgam._ispline_basis(jnp.asarray(x), knots, degree))


def test_quantile_knots_match_reference(monkeypatch):
    """Knots from the port's sort-and-interpolate against the reference's
    ``jnp.nanquantile``, with missing values and repeated values; never
    through ``torch.quantile``, which refuses inputs over 2^24 values."""
    def refused(*args, **kwargs):
        raise AssertionError("torch.quantile called")

    monkeypatch.setattr(torch, "quantile", refused)
    monkeypatch.setattr(torch, "nanquantile", refused)
    rng = np.random.default_rng(2)
    v = np.round(rng.normal(size=5000), 2).astype(np.float32)
    v[rng.random(5000) < 0.1] = np.nan
    cols = dict(v=v, y=np.zeros(5000, np.float32))
    for k in (3, 5, 10):
        got = pgam.GAM()._select_knots(Frame.from_arrays(cols), "v", k, None)
        want = jgam.GAM()._select_knots(JFrame.from_arrays(cols), "v", k,
                                        None)
        _close(got, want)
    qs = np.linspace(0.02, 0.98, 7)
    _close(pgam._nanquantile(torch.from_numpy(v), qs).numpy(),
           jnp.nanquantile(jnp.asarray(v), jnp.linspace(0.02, 0.98, 7)))


def test_thin_plate_knots_are_the_reference_rows():
    cols = gam_cols()
    got = pgam.GAM()._select_knots(Frame.from_arrays(cols), ["x2", "x3"], 6,
                                   None)
    want = jgam.GAM()._select_knots(JFrame.from_arrays(cols), ["x2", "x3"],
                                    6, None)
    np.testing.assert_array_equal(got, want)


GAM_CASES = {
    "gaussian, cr / tp / 2-D tp / I-spline": dict(
        gam_columns=["x0", "x1", ["x2", "x3"], "x5"], bs=[0, 1, 1, 2]),
    "binomial, cr / I-spline, lambda": dict(
        gam_columns=["x0", "x5"], bs=[0, 2], num_knots=6, lambda_=1e-3),
}


@pytest.mark.parametrize("case", list(GAM_CASES))
def test_fit_matches_reference(case):
    params = GAM_CASES[case]
    cols = gam_cols(binomial=case.startswith("binomial"))
    x = [f"x{i}" for i in range(6)]
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = jgam.GAM(**params).train(x=x, y="y", training_frame=jf)
    pm = pgam.GAM(**params).train(x=x, y="y", training_frame=pf)
    jo, po = jm.output, pm.output
    assert po["gam_names"] == jo["gam_names"]
    for k in jo["knots"]:
        _close(po["knots"][k], jo["knots"][k])
    pc, jc = pm.coef(), jm.coef()
    assert list(pc) == list(jc)
    jv = np.asarray(list(jc.values()))
    np.testing.assert_allclose(list(pc.values()), jv, rtol=1e-4,
                               atol=1e-3 * np.abs(jv).max())
    ispl = [n for n in pc if n.startswith("x5_gam_")]
    assert min(pc[n] for n in ispl) >= 0.0          # monotone I-spline
    col = "p1" if case.startswith("binomial") else "predict"
    _close(pm.predict(pf).vec(col).to_numpy(),
           jm.predict(jf).vec(col).to_numpy()[:N], 1e-4)


def test_reference_model_scores_alike_through_convert():
    params = GAM_CASES["gaussian, cr / tp / 2-D tp / I-spline"]
    cols = gam_cols(seed=3)
    x = [f"x{i}" for i in range(6)]
    jf = JFrame.from_arrays(cols)
    jm = jgam.GAM(**params).train(x=x, y="y", training_frame=jf)
    g = jm.output["glm"]
    glm = dict(output={k: (np.asarray(v) if hasattr(v, "shape") else v)
                       for k, v in g.output.items()},
               data_info=dataclasses.asdict(g.data_info),
               response_column="y", params=dict(g.params))
    pm = convert.gam_model(dict(jm.output), glm, "y", None, dict(jm.params),
                           device="cpu")
    test = gam_cols(seed=4)
    _close(pm.predict(Frame.from_arrays(test)).vec("predict").to_numpy(),
           jm.predict(JFrame.from_arrays(test)).vec("predict").to_numpy()[:N])


def test_refusals():
    pf = Frame.from_arrays(dict(gam_cols(), c=np.array(["a", "b"] * (N // 2))))
    x = ["x0", "x1"]
    with pytest.raises(ValueError, match="gam_columns is required"):
        pgam.GAM().train(x=x, y="y", training_frame=pf)
    with pytest.raises(ValueError, match="one entry per gam column"):
        pgam.GAM(gam_columns=["x0"], bs=[0, 1]).train(x=x, y="y",
                                                      training_frame=pf)
    with pytest.raises(ValueError, match="require bs=1"):
        pgam.GAM(gam_columns=[["x0", "x1"]], bs=[0]).train(
            x=x, y="y", training_frame=pf)
    with pytest.raises(ValueError, match="must be numeric"):
        pgam.GAM(gam_columns=["c"]).train(x=x, y="y", training_frame=pf)
    with pytest.raises(ValueError, match="num_knots"):
        pgam.GAM(gam_columns=["x0"], num_knots=2).train(x=x, y="y",
                                                        training_frame=pf)
