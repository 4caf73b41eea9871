"""IsotonicRegression in the port (h2o3_tpu_torch/models/isotonic.py)
against the JAX reference (``h2o3_tpu/models/isotonic.py``) on the same
numpy-seeded frames: repeated x values, missing x and y, and weights.

Tolerances: ``_pav`` in float64 at rtol 1e-12 (the same arithmetic in the
same order); the unique-x sums at rtol 1e-12 (float64 sums of float32
products, in another order); the thresholds at rtol 1e-6 (float32);
interpolation and predictions at rtol 1e-6 with an absolute floor of
1e-6 (float32 lerps of values near 1).
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import isotonic as jiso
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import isotonic as piso

RTOL = 1e-6
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


def iso_cols(n=N, seed=0, weights=False):
    """x on a grid of 97 values (repeats), y a noisy monotone curve, a few
    missing x and y."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 97, n) / 9.0).astype(np.float32)
    y = (np.log1p(x) + rng.normal(scale=0.4, size=n)).astype(np.float32)
    x[rng.random(n) < 0.03] = np.nan
    y[rng.random(n) < 0.03] = np.nan
    cols = dict(x=x, y=y)
    if weights:
        cols["w"] = rng.uniform(0.2, 3.0, n).astype(np.float32)
    return cols


def test_pav_matches_reference():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 300):
        ys = rng.normal(size=n).cumsum() * rng.choice([-1.0, 1.0], n)
        ws = rng.uniform(0.1, 5.0, n)
        np.testing.assert_allclose(piso._pav(ys, ws), jiso._pav(ys, ws),
                                   rtol=1e-12, atol=0)


def test_interp_matches_reference():
    rng = np.random.default_rng(4)
    tx = np.sort(rng.uniform(0, 10, 20)).astype(np.float32)
    ty = np.sort(rng.normal(size=20)).astype(np.float32)
    x = rng.uniform(-1, 11, 500).astype(np.float32)
    got = piso._interp(torch.from_numpy(x), torch.from_numpy(tx),
                       torch.from_numpy(ty)).numpy()
    want = np.asarray(jiso._interp(x, tx, ty))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("oob", ["NA", "clip"])
def test_fit_and_predictions_match_reference(weights, oob):
    cols = iso_cols(weights=weights)
    kw = dict(out_of_bounds=oob, weights_column="w" if weights else None)
    jm = jiso.IsotonicRegression(**kw).train(x=["x"], y="y",
                                             training_frame=JFrame.from_arrays(cols))
    pm = piso.IsotonicRegression(**kw).train(x=["x"], y="y",
                                             training_frame=Frame.from_arrays(cols))
    jo, po = jm.output, pm.output
    np.testing.assert_allclose(po["thresholds_x"].numpy(),
                               np.asarray(jo["thresholds_x"]), rtol=RTOL)
    np.testing.assert_allclose(po["thresholds_y"].numpy(),
                               np.asarray(jo["thresholds_y"]), rtol=RTOL,
                               atol=1e-6)
    assert (po["min_x"], po["max_x"], po["nobs"]) == \
        (jo["min_x"], jo["max_x"], jo["nobs"])
    # scoring x beyond the training range on both sides
    test = dict(x=np.float32([-1.0, 0.0, 0.05, 3.3, 10.7, 11.0, np.nan, 99]),
                y=np.zeros(8, np.float32))
    got = pm.predict(Frame.from_arrays(test)).vec("predict").to_numpy()
    want = jm.predict(JFrame.from_arrays(test)).vec("predict").to_numpy()[:8]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pm.training_metrics.mse,
                               jm.training_metrics.mse, rtol=1e-5)


def test_unique_x_sums_match_the_reference_host_sums():
    """The per-unique-x sums the port forms on the device equal the
    reference's host ``np.unique``/``bincount`` sums."""
    cols = iso_cols(weights=True)
    x, y, w = cols["x"], cols["y"], cols["w"]
    ok = ~np.isnan(x) & ~np.isnan(y)
    ux, inv = np.unique(x[ok], return_inverse=True)
    want = (np.bincount(inv, weights=w[ok]),
            np.bincount(inv, weights=w[ok] * y[ok]))
    fr = Frame.from_arrays(cols)
    captured = {}
    pav = piso._pav

    def spy(ys, ws):
        captured["ys"], captured["ws"] = ys, ws
        return pav(ys, ws)

    piso._pav = spy
    try:
        piso.IsotonicRegression(weights_column="w").train(
            x=["x"], y="y", training_frame=fr)
    finally:
        piso._pav = pav
    np.testing.assert_allclose(captured["ws"], want[0], rtol=1e-12)
    np.testing.assert_allclose(captured["ys"],
                               want[1] / np.maximum(want[0], 1e-300),
                               rtol=1e-12)


def test_reference_model_scores_alike_through_convert():
    cols = iso_cols(seed=2)
    jm = jiso.IsotonicRegression().train(
        x=["x"], y="y", training_frame=JFrame.from_arrays(cols))
    out = {k: (np.asarray(v) if k.startswith("thresholds") else v)
           for k, v in jm.output.items()}
    pm = convert.isotonic_model(out, "y", dict(jm.params), device="cpu")
    fr = Frame.from_arrays(cols)
    np.testing.assert_allclose(
        pm.predict(fr).vec("predict").to_numpy(),
        jm.predict(JFrame.from_arrays(cols)).vec("predict").to_numpy()[:N],
        rtol=RTOL, atol=1e-6)


def test_refusals():
    fr = Frame.from_arrays(dict(iso_cols(), z=np.zeros(N, np.float32)))
    with pytest.raises(ValueError, match="exactly one"):
        piso.IsotonicRegression().train(x=["x", "z"], y="y",
                                        training_frame=fr)
    cat = Frame.from_arrays(dict(x=np.arange(4, dtype=np.float32),
                                 y=np.array(["a", "b", "a", "b"])))
    with pytest.raises(ValueError, match="categorical response"):
        piso.IsotonicRegression().train(x=["x"], y="y", training_frame=cat)
