"""Segment models in the port (``h2o3_tpu_torch/orchestration/
segments.py``) against the JAX package's (``h2o3_tpu/orchestration/
segments.py``): the same segments in the same order, each segment's GBM
(sampling off) equal to the reference's at its splits with leaves and
probabilities at atol 1e-5 (tests/test_torch_gbm.py's tolerance: the
reference's histograms are per-device partial sums), NA segments left
out, a failing segment FAILED with its error in both, and ``as_frame``,
``get_model`` and the DKV; a numeric segment column too. Row counts are
multiples of 64 (no pad rows in the reference's segment weights)."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.orchestration.segments import (SegmentModels,
                                                   train_segments)
from h2o3_tpu_torch.utils.registry import DKV

N = 448
SPLITS = ("feat", "thresh_bin", "na_left", "is_split")


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _clear_port_dkv():
    """The module starts and ends with an empty port DKV (other files'
    models may share this process; the module's fixtures train models
    that its tests share)."""
    DKV.clear()
    yield
    DKV.clear()


def seg_cols(n=N, seed=2):
    """Three segments (and some rows in none) with opposite signs of x0;
    a numeric segment column of two values."""
    rng = np.random.default_rng(seed)
    seg = rng.choice(np.array(["s1", "s2", "s3"], dtype=object), size=n)
    seg[rng.random(n) < 0.05] = None
    X = rng.normal(size=(n, 3)).astype(np.float32)
    sign = np.where(seg == "s2", -2.0, 2.0)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-sign * X[:, 0])),
                 "yes", "no")
    return {"seg": seg, "num": rng.choice(np.float32([1.5, 4.0]), n),
            "x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "y": y}


@pytest.fixture(scope="module")
def segmented():
    cols = seg_cols()
    kw = dict(ntrees=4, max_depth=3, nbins=16, seed=1)
    jsm = JGBM(**kw).train_segments(segments=["seg"], y="y",
                                    training_frame=JFrame.from_arrays(cols),
                                    segment_models_id="jsm")
    pf = Frame.from_arrays(cols)
    psm = GBM(**kw).train_segments(segments=["seg"], y="y",
                                   training_frame=pf,
                                   segment_models_id="psm")
    return cols, pf, jsm, psm


def test_segments_match_the_reference_at_their_splits(segmented):
    cols, pf, jsm, psm = segmented
    assert [r["segment"] for r in psm.rows] == \
        [r["segment"] for r in jsm.rows] == \
        [{"seg": "s1"}, {"seg": "s2"}, {"seg": "s3"}]
    jf = JFrame.from_arrays(cols)
    for jr, pr in zip(jsm.rows, psm.rows):
        assert pr["status"] == jr["status"] == "SUCCEEDED"
        jm, pm = jsm.get_model(**jr["segment"]), psm.get_model(
            **pr["segment"])
        for jt, pt in zip(jm.output["trees"], pm.output["trees"]):
            for f in SPLITS:
                np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                              np.asarray(getattr(jt, f)))
            np.testing.assert_allclose(pt.leaf.numpy(), np.asarray(jt.leaf),
                                       atol=1e-5)
        np.testing.assert_allclose(pm._score_raw(pf).numpy(),
                                   np.asarray(jm._score_raw(jf))[:N],
                                   atol=1e-5)
    # the segments learned opposite signs of x0
    probe = Frame.from_arrays({"num": np.float32([1.5]),
                               "x0": np.float32([2.0]),
                               "x1": np.float32([0.0]),
                               "x2": np.float32([0.0])})
    p = {s: float(psm.get_model(seg=s).predict(probe).vec("pyes")
                  .to_numpy()[0]) for s in ("s1", "s2")}
    assert p["s1"] > 0.5 > p["s2"]


def test_as_frame_get_model_and_the_dkv(segmented):
    _, _, jsm, psm = segmented
    DKV.put(psm.key, psm)    # a module fixture's put may predate a clear
    assert isinstance(DKV["psm"], SegmentModels) and len(psm) == 3
    pf, jf = psm.as_frame(), jsm.as_frame()
    assert pf.names == jf.names == ["seg", "model_id", "status", "errors"]
    assert list(pf.vec("seg").to_numpy()) == ["s1", "s2", "s3"]
    assert list(pf.vec("status").to_numpy()) == \
        list(jf.vec("status").to_numpy()[:3])
    for r in psm.rows:
        m = psm.get_model(**r["segment"])
        assert m.key == r["model_id"]
        DKV.put(m.key, m)
        assert DKV[m.key] is m
    with pytest.raises(KeyError, match="no segment"):
        psm.get_model(seg="s9")


def _failing(cls):
    """``cls`` whose fit raises on a segment of fewer than 20 rows."""
    class Failing(cls):
        def _fit(self, job, frame, x, y, weights):
            if float((weights > 0).sum()) < 20:
                raise ValueError("too few rows in the segment")
            return super()._fit(job, frame, x, y, weights)
    return Failing


def test_a_failing_segment_is_recorded_as_the_reference(segmented):
    rng = np.random.default_rng(4)
    cols = {"seg": np.array(["ok"] * 48 + ["tiny"] * 16),
            "x0": rng.normal(size=64).astype(np.float32),
            "y": rng.choice(["a", "b"], size=64)}
    jsm = _failing(JGBM)(ntrees=2, max_depth=2).train_segments(
        segments=["seg"], y="y", training_frame=JFrame.from_arrays(cols))
    psm = _failing(GBM)(ntrees=2, max_depth=2).train_segments(
        segments=["seg"], y="y", training_frame=Frame.from_arrays(cols))
    for sm in (jsm, psm):
        by = {r["segment"]["seg"]: r for r in sm.rows}
        assert by["ok"]["status"] == "SUCCEEDED"
        assert by["tiny"]["status"] == "FAILED"
        assert by["tiny"]["errors"] == \
            "ValueError: too few rows in the segment"
        assert by["tiny"]["model_id"] is None and "traceback" in by["tiny"]
        assert sm.get_model(seg="tiny") is None


def test_a_numeric_segment_column(segmented):
    cols, pf, _, _ = segmented
    kw = dict(ntrees=2, max_depth=2, nbins=16, seed=1)
    jsm = JGBM(**kw).train_segments(segments=["num"], y="y",
                                    training_frame=JFrame.from_arrays(cols),
                                    x=["x0", "x1"])
    psm = train_segments(GBM(**kw), ["num"], pf, "y", x=["x0", "x1"])
    assert [str(r["segment"]["num"]) for r in psm.rows] == \
        [str(r["segment"]["num"]) for r in jsm.rows] == ["1.5", "4.0"]
    for jr, pr in zip(jsm.rows, psm.rows):
        jm, pm = jsm.get_model(**jr["segment"]), psm.get_model(
            **pr["segment"])
        assert pm.training_metrics.nobs == jm.training_metrics.nobs
        assert pm.output["x_cols"] == ["x0", "x1"]
    with pytest.raises(ValueError, match="at least one column"):
        train_segments(GBM(**kw), [], pf, "y")
