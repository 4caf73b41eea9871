"""Monotone and interaction constraints in the port (h2o3_tpu_torch/models/
tree.py: ``_find_splits`` ``mono``/``allowed``, the bound propagation and
leaf clamp of ``_grow_batched``; models/gbm.py: ``_constraint_arrays``)
against the JAX reference on the same numpy-seeded data (mirrors
tests/test_tree_constraints.py:33-103).

Splits are held exactly, leaves within rtol 1e-4 (sums of float32 in
another order), predictions within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.xgboost import XGBoost as JXGBoost
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.xgboost import XGBoost

SPLIT_KEYS = ("feat", "thresh_bin", "na_left", "is_split")


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def mono_cols(seed=0, n=800, sign=1.0):
    """y rises with x0 on average, with wiggles an unconstrained tree
    follows (tests/test_tree_constraints.py's data)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2, 2, n).astype(np.float32)
    x1 = rng.normal(size=n).astype(np.float32)
    y = (x0 + 1.5 * np.sin(3 * x0) + 0.5 * x1
         + rng.normal(scale=0.5, size=n)).astype(np.float32)
    return {"x0": x0, "x1": x1, "y": sign * y}


def curve(model, frame_cls, k=41):
    """Predictions along an x0 grid with x1 held at 0."""
    grid = np.linspace(-2, 2, k, dtype=np.float32)
    fr = frame_cls.from_arrays({"x0": grid, "x1": np.zeros(k, np.float32)})
    return np.asarray(model.predict(fr).vec("predict").to_numpy())[:k]


def _alike(jtrees, ptrees):
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        for k in SPLIT_KEYS:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(b.leaf.numpy(), np.asarray(a.leaf),
                                   rtol=1e-4, atol=1e-5, err_msg=f"tree {i}")


@pytest.mark.parametrize("sign", [1, -1])
def test_monotone_constraint_matches_reference(sign):
    cols = mono_cols(sign=float(sign))
    kw = dict(ntrees=30, max_depth=4, seed=1,
              monotone_constraints={"x0": sign})
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    _alike(jm.output["trees"], pm.output["trees"])
    got, want = curve(pm, Frame), curve(jm, JFrame)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # predictions never move against the constraint along x0
    assert (sign * np.diff(got) >= -1e-5).all(), np.diff(got)
    assert sign * (got[-1] - got[0]) > 1.0
    un = GBM(ntrees=30, max_depth=4, seed=1).train(
        y="y", training_frame=Frame.from_arrays(cols))
    assert (sign * np.diff(curve(un, Frame)) < -1e-4).any()


def test_interaction_constraints_match_reference():
    rng = np.random.default_rng(2)
    n = 600
    a, b, c = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    y = (a * b + 0.3 * c + rng.normal(scale=0.1, size=n)).astype(np.float32)
    cols = {"a": a, "b": b, "c": c, "y": y}
    kw = dict(ntrees=10, max_depth=4, seed=2,
              interaction_constraints=[["a", "b"]])
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    _alike(jm.output["trees"], pm.output["trees"])
    # under a or b only {a, b}; under c (a singleton) only c
    groups = {0: {0, 1}, 1: {0, 1}, 2: {2}}
    for tree in pm.output["trees"]:
        feat, is_sp = tree.feat.numpy(), tree.is_split.numpy()

        def walk(i, allowed):
            if i >= len(feat) or not is_sp[i]:
                return
            f = int(feat[i])
            assert allowed is None or f in allowed, (i, f, allowed)
            nxt = groups[f] if allowed is None else allowed & groups[f]
            walk(2 * i + 1, nxt)
            walk(2 * i + 2, nxt)

        walk(0, None)


def test_constraints_in_xgboost_and_a_class_batch_match_reference():
    """XGBoost takes both constraints; a multinomial GBM's class batch
    carries an allowed set per class tree."""
    cols = mono_cols(seed=4, n=900)
    kw = dict(ntrees=4, max_depth=3, seed=4, max_bin=32,
              monotone_constraints={"x0": 1},
              interaction_constraints=[["x0"], ["x1"]])
    jm = JXGBoost(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = XGBoost(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    _alike(jm.output["trees"], pm.output["trees"])
    rng = np.random.default_rng(5)
    cls = np.array(["k0", "k1", "k2"], dtype=object)[
        np.digitize(cols["x0"] + 0.5 * cols["x1"]
                    + rng.normal(scale=0.5, size=900), [-0.7, 0.7])]
    mc = dict(cols, y=cls)
    kw = dict(ntrees=3, max_depth=3, seed=5, nbins=16,
              interaction_constraints=[["x0"], ["x1"]])
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(mc))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(mc))
    for jt, pt in zip(jm.output["trees_multi"], pm.output["trees_multi"]):
        _alike(jt, pt)


def test_constraint_validation_errors():
    rng = np.random.default_rng(6)
    cols = {"x": rng.normal(size=50).astype(np.float32),
            "c": rng.choice(["a", "b"], size=50),
            "y": rng.normal(size=50).astype(np.float32)}
    fr = Frame.from_arrays(cols)
    with pytest.raises(ValueError, match="categorical"):
        GBM(ntrees=2, monotone_constraints={"c": 1}).train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match="non-feature"):
        GBM(ntrees=2, monotone_constraints={"zzz": 1}).train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match="-1, 0 or 1"):
        GBM(ntrees=2, monotone_constraints={"x": 2}).train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match="non-feature"):
        GBM(ntrees=2, interaction_constraints=[["x", "zzz"]]).train(
            y="y", training_frame=fr)
    mc = dict(cols, y=rng.choice(["p", "q", "r"], size=50))
    with pytest.raises(ValueError, match="multinomial"):
        GBM(ntrees=2, monotone_constraints={"x": 1}).train(
            y="y", training_frame=Frame.from_arrays(mc))
    # the reference's DRF leaves them unapplied: the port refuses them
    with pytest.raises(ValueError, match="DRF does not take"):
        DRF(ntrees=2, monotone_constraints={"x": 1}).train(
            y="y", training_frame=fr)
    # calibration is ported: on a numeric response it raises as the
    # reference's does
    with pytest.raises(ValueError, match="calibrate_model requires a "
                                         "binomial"):
        GBM(ntrees=2, calibrate_model=True).train(y="y", training_frame=fr)
