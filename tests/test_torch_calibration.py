"""Probability calibration in the port (h2o3_tpu_torch/models/gbm.py:
``SharedTreeBuilder._maybe_calibrate``, ``fit_calibration``,
``calibrated_p1`` and the ``cal_p0``/``cal_p1`` columns of
``SharedTreeModel.predict``) against the JAX reference
(``SharedTreeBuilder._maybe_calibrate``, ``SharedTreeModel.predict``).

Both packages fit on the same numpy-made p1 and response (a stub model
hands each its p1): Platt's a and b and the isotonic steps are held at
rtol 1e-6. Calibrated predictions of one set of calibration parameters
are held at atol 1e-6 (float32 outputs; Platt runs in float32 in both) on
the same p1; the port's p1 (a float64 sigmoid rounded once) is within an
ulp of the reference's, and an isotonic fit's knots sit at tied scores,
where an ulp of p1 can cross a step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import gbm as pgbm
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.models.xgboost import XGBoost
from jax_reference import _jax_compile_cache  # noqa: F401

DOMAIN = ("n", "p")


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def scores(n=3000, seed=7, ties=False):
    """A miscalibrated p1 (too sharp) and a response drawn from the true
    probability; with ``ties`` p1 is rounded to two decimals, so that
    many rows tie (as a forest's averaged leaves do)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    y = rng.random(n) < 1 / (1 + np.exp(-z))
    p1 = 1 / (1 + np.exp(-2.5 * z))
    if ties:
        p1 = np.round(p1, 2)
    cols = {"x": z.astype(np.float32),
            "y": np.array(DOMAIN, dtype=object)[y.astype(int)]}
    return p1.astype(np.float32), cols


class _Stub:
    """A binomial model whose scores are a given p1."""

    nclasses = 2
    response_column = "y"
    response_domain = DOMAIN

    def __init__(self, p1):
        self.p1 = p1
        self.output = {}

    def _score_raw(self, frame):
        n = getattr(frame, "plen", frame.nrows)
        p = np.zeros(n, np.float32)
        p[: len(self.p1)] = self.p1
        if isinstance(frame, JFrame):
            return jnp.stack([1 - jnp.asarray(p), jnp.asarray(p)], axis=1)
        p = torch.from_numpy(p)
        return torch.stack([1 - p, p], dim=1)


def _fit_both(method, p1, cols):
    kw = dict(calibrate_model=True, calibration_method=method)
    jm, pm = _Stub(p1), _Stub(p1)
    JGBM(calibration_frame=JFrame.from_arrays(cols), **kw) \
        ._maybe_calibrate(jm)
    GBM(calibration_frame=Frame.from_arrays(cols), **kw)._maybe_calibrate(pm)
    return jm.output["calibration"], pm.output["calibration"]


def test_platt_scaling_matches_reference():
    want, got = _fit_both("PlattScaling", *scores())
    assert got["method"] == want["method"] == "PlattScaling"
    np.testing.assert_allclose([got["a"], got["b"]], [want["a"], want["b"]],
                               rtol=1e-6)
    # too sharp scores are flattened
    assert 0.2 < got["a"] < 0.6


@pytest.mark.parametrize("ties", [False, True])
def test_isotonic_steps_match_reference(ties):
    want, got = _fit_both("IsotonicRegression", *scores(ties=ties))
    assert len(got["xs"]) == len(want["xs"]) > 5
    np.testing.assert_allclose(got["xs"], want["xs"], rtol=1e-6)
    np.testing.assert_allclose(got["ys"], want["ys"], rtol=1e-6)
    assert np.all(np.diff(got["ys"]) >= 0)


def _reference_calibrated(cal, p1):
    """The reference's ``SharedTreeModel.predict`` arithmetic on p1."""
    p1 = np.clip(p1, 1e-15, 1 - 1e-15)
    if cal["method"] == "PlattScaling":
        return (1.0 / (1.0 + np.exp(-(cal["a"] * np.log(p1 / (1 - p1))
                                      + cal["b"])))).astype(np.float32)
    return np.interp(p1, cal["xs"], cal["ys"]).astype(np.float32)


@pytest.mark.parametrize("method", ["PlattScaling", "IsotonicRegression"])
def test_calibrated_p1_is_the_references_arithmetic(method):
    p1, cols = scores(ties=method == "IsotonicRegression")
    cal = _fit_both(method, p1, cols)[1]
    assert np.isfinite(cal.get("a", 0.0))
    # knots, values between and beyond them, the clip's ends
    probe = np.concatenate([p1, np.asarray(cal.get("xs", []), np.float32),
                            np.linspace(0, 1, 1001, dtype=np.float32),
                            np.float32([0.0, 1.0, 1e-20])])
    got = pgbm.calibrated_p1(cal, torch.from_numpy(probe)).numpy()
    np.testing.assert_allclose(got, _reference_calibrated(cal, probe),
                               rtol=0, atol=1e-6)


def train_cols(n=2000, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = np.array(DOMAIN, dtype=object)[
        (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)]
    return cols


@pytest.mark.parametrize("method", ["PlattScaling", "IsotonicRegression"])
def test_reference_calibrated_model_scores_alike_through_convert(method):
    """A calibrated GBM trained by the JAX package, carried into the port,
    gives the reference's cal_p0 and cal_p1."""
    cols, ccols = train_cols(), train_cols(1500, seed=22)
    jm = JGBM(ntrees=5, max_depth=3, seed=1, calibrate_model=True,
              calibration_frame=JFrame.from_arrays(ccols),
              calibration_method=method).train(
        y="y", training_frame=JFrame.from_arrays(cols))
    o = jm.output
    cm = convert.gbm_model(
        dict(o, trees=[{k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
                       for t in o["trees"]]),
        response_column="y", response_domain=jm.response_domain,
        device="cpu")
    assert cm.output["calibration"] == o["calibration"]
    want = jm.predict(JFrame.from_arrays(ccols))
    got = cm.predict(Frame.from_arrays(ccols))
    assert got.names == want.names[: len(got.names)] and \
        got.names[-2:] == ["cal_p0", "cal_p1"]
    n = got.nrows
    p1, p1_ref = got.vec("pp").to_numpy(), want.vec("pp").to_numpy()[:n]
    # the port's sigmoid runs in float64 and rounds once: within an ulp of
    # the reference's float32 sigmoid
    np.testing.assert_allclose(p1, p1_ref, rtol=0, atol=2.0 ** -24)
    # isotonic steps sit at tied scores, so an ulp of p1 can cross a knot:
    # the calibration is held on the port's own p1, and to the reference's
    # output wherever the two p1 are the same bits
    np.testing.assert_allclose(got.vec("cal_p1").to_numpy(),
                               _reference_calibrated(o["calibration"], p1),
                               rtol=0, atol=1e-6)
    same = p1 == p1_ref
    assert same.mean() > 0.5
    for c in ("cal_p0", "cal_p1"):
        np.testing.assert_allclose(got.vec(c).to_numpy()[same],
                                   want.vec(c).to_numpy()[:n][same],
                                   atol=1e-6)


@pytest.mark.parametrize("builder", ["gbm", "drf", "xgboost", "dart"])
def test_every_binomial_tree_builder_calibrates(builder):
    cols, ccols = train_cols(seed=23), train_cols(1500, seed=24)
    cf = Frame.from_arrays(ccols)
    kw = dict(ntrees=4, max_depth=3, seed=3, calibrate_model=True,
              calibration_frame=cf, calibration_method="PlattScaling")
    make = {"gbm": lambda: GBM(**kw), "drf": lambda: DRF(**kw),
            "xgboost": lambda: XGBoost(**kw),
            "dart": lambda: XGBoost(booster="dart", rate_drop=0.5, **kw)}
    m = make[builder]().train(y="y", training_frame=Frame.from_arrays(cols))
    cal = m.output["calibration"]
    assert np.isfinite([cal["a"], cal["b"]]).all()
    pred = m.predict(cf)
    torch.testing.assert_close(
        pred.vec("cal_p1").data,
        pgbm.calibrated_p1(cal, pred.vec("pp").data), rtol=0, atol=0)
    torch.testing.assert_close(pred.vec("cal_p0").data,
                               1 - pred.vec("cal_p1").data)


def test_calibration_refusals():
    cols = train_cols(300, seed=25)
    fr = Frame.from_arrays(cols)
    with pytest.raises(ValueError, match="requires calibration_frame"):
        GBM(ntrees=1, calibrate_model=True).train(y="y", training_frame=fr)
    # a key the DKV does not hold: the reference's KeyError
    with pytest.raises(KeyError, match="calib.hex"):
        GBM(ntrees=1, calibrate_model=True,
            calibration_frame="calib.hex").train(y="y", training_frame=fr)
    with pytest.raises(ValueError, match="unknown calibration_method"):
        GBM(ntrees=1, calibrate_model=True, calibration_frame=fr,
            calibration_method="Beta").train(y="y", training_frame=fr)
    multi = dict(cols, y=np.array(["a", "b", "c"])[
        np.random.default_rng(1).integers(0, 3, 300)])
    with pytest.raises(ValueError, match="binomial"):
        GBM(ntrees=1, calibrate_model=True, calibration_frame=fr).train(
            y="y", training_frame=Frame.from_arrays(multi))
