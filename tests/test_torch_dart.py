"""DART in the port (h2o3_tpu_torch/models/xgboost.py: ``XGBoost._fit_dart``)
against the JAX reference (``h2o3_tpu/models/xgboost.py:_fit_dart``) on the
same numpy-seeded frames, sampling off.

The drops come from ``np.random.default_rng(seed)`` in both packages, so
the dropped sets are equal (held against a replay of the reference's draws
and through the tree weights, equal to rtol 1e-12: Python floats from the
same sets). Trees are equal in structure (``na_left`` at the nodes that
rows with a missing value reach: elsewhere both directions gain alike, and
the last bits a sibling subtraction leaves in the empty NA bin pick one);
leaves (the weights baked in) within rtol 1e-5, since each round's gradients are float32 sums in another
order; training metrics within rtol 1e-5 and probabilities within atol
1e-5.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import xgboost as jxgb
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import xgboost as pxgb
from h2o3_tpu_torch.models.tree import HEAP_FIELDS

BASE = dict(booster="dart", ntrees=10, max_depth=4, max_bin=64, eta=0.3,
            seed=7)
CASES = {
    "tree": dict(rate_drop=0.3, skip_drop=0.3),
    "forest_one_drop": dict(rate_drop=0.1, skip_drop=0.5, one_drop=True,
                            normalize_type="forest"),
}


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def dart_cols(n=3000, F=6, seed=31):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.03] = np.nan
    Z = np.nan_to_num(X)
    logit = Z[:, 0] - 0.7 * Z[:, 1] + 0.4 * Z[:, 2] * Z[:, 3]
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "s", "b")
    cols["t"] = (logit + 0.5 * rng.normal(size=n)).astype(np.float32)
    return cols


def reference_drops(seed, ntrees, rate_drop=0.0, skip_drop=0.0,
                    one_drop=False, **_):
    """The reference's draws of the dropped trees, round by round."""
    rng = np.random.default_rng(seed)
    out = []
    for m in range(ntrees):
        drop = np.zeros(m, bool)
        if m and rng.random() >= skip_drop:
            drop = rng.random(m) < rate_drop
            if one_drop and not drop.any():
                drop[rng.integers(0, m)] = True
        out.append(np.nonzero(drop)[0].tolist())
    return out


def na_reached(tree, X: np.ndarray) -> np.ndarray:
    """[heap] True at the split nodes that a row of X with its split
    feature missing reaches (raw traversal of the reference's tree)."""
    feat, tv, nal, isp = (np.asarray(getattr(tree, k)) for k in
                          ("feat", "thresh_val", "na_left", "is_split"))
    out = np.zeros(feat.shape[0], bool)
    idx = np.zeros(X.shape[0], np.int64)
    while True:
        sp = isp[idx]
        if not sp.any():
            return out
        xv = X[np.arange(X.shape[0]), np.maximum(feat[idx], 0)]
        out[idx[sp & np.isnan(xv)]] = True
        left = np.where(np.isnan(xv), nal[idx], xv < tv[idx])
        idx = np.where(sp, idx * 2 + np.where(left, 1, 2), idx)


@pytest.fixture(scope="module")
def fits():
    cols = dart_cols()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    x = [c for c in cols if c.startswith("x")]
    out = {}
    for name, extra in CASES.items():
        for y in ("y", "t"):
            if y == "t" and name != "tree":
                continue
            kw = dict(BASE, **extra)
            b = pxgb.XGBoost(**kw)
            pm = b.train(x=x, y=y, training_frame=pf)
            jm = jxgb.XGBoost(**kw).train(x=x, y=y, training_frame=jf)
            out[name, y] = (kw, b, jm, pm)
    return cols, jf, pf, out


@pytest.mark.parametrize("case", [("tree", "y"), ("forest_one_drop", "y"),
                                  ("tree", "t")])
def test_dart_matches_reference(fits, case):
    cols, jf, pf, out = fits
    kw, builder, jm, pm = out[case]
    assert isinstance(pm, pxgb.XGBoostModel)
    drops = reference_drops(**kw)
    assert builder.dart_drops == drops
    assert sum(map(len, drops)) > 0
    np.testing.assert_allclose(pm.output["dart_weights"],
                               jm.output["dart_weights"], rtol=1e-12)
    assert pm.output["learn_rate"] == 1.0 and \
        pm.output["f0"] == pytest.approx(jm.output["f0"], rel=1e-6)
    assert len(pm.output["trees"]) == len(jm.output["trees"]) == kw["ntrees"]
    X = np.column_stack([cols[c] for c in pm.output["x_cols"]])
    for jt, pt in zip(jm.output["trees"], pm.output["trees"]):
        for k in ("feat", "thresh_bin", "is_split"):
            np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                          np.asarray(getattr(jt, k)),
                                          err_msg=k)
        na = na_reached(jt, X)
        np.testing.assert_array_equal(pt.na_left.numpy()[na],
                                      np.asarray(jt.na_left)[na])
        np.testing.assert_allclose(pt.leaf.numpy(), np.asarray(jt.leaf),
                                   rtol=1e-5, atol=1e-6)
    n = pf.nrows
    if case[1] == "y":
        assert pm.training_metrics.auc == pytest.approx(
            jm.training_metrics.auc, rel=1e-5)
        np.testing.assert_allclose(
            pm.predict(pf).vec("ps").to_numpy(),
            jm.predict(jf).vec("ps").to_numpy()[:n], atol=1e-5)
        assert pm.model_performance(pf).auc == pytest.approx(
            pm.training_metrics.auc, abs=1e-6)
    else:
        assert pm.training_metrics.mse == pytest.approx(
            jm.training_metrics.mse, rel=1e-5)


def test_reference_dart_model_scores_through_convert(fits):
    cols, jf, pf, out = fits
    _, _, jm, _ = out["tree", "y"]
    o = dict(jm.output, trees=[{k: np.asarray(getattr(t, k))
                                for k in HEAP_FIELDS}
                               for t in jm.output["trees"]])
    cm = convert.xgboost_model(o, response_column="y",
                               response_domain=jm.response_domain,
                               device="cpu")
    assert cm.output["dart_weights"] == jm.output["dart_weights"]
    np.testing.assert_allclose(cm.predict(pf).vec("ps").to_numpy(),
                               jm.predict(jf).vec("ps").to_numpy()[:pf.nrows],
                               atol=1e-6)


def test_dart_early_stopping_keeps_the_references_trees():
    cols = dart_cols(1500, seed=32)
    kw = dict(BASE, ntrees=40, eta=0.6, rate_drop=0.2, stopping_rounds=2,
              stopping_tolerance=0.02)
    jm = jxgb.XGBoost(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = pxgb.XGBoost(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    assert len(pm.output["trees"]) == len(jm.output["trees"]) < 40


def test_dart_refuses_what_the_reference_refuses():
    cols = dart_cols(300, seed=33)
    fr = Frame.from_arrays(dict(cols, y=np.array(["a", "b", "c"])[
        np.random.default_rng(3).integers(0, 3, 300)]))
    with pytest.raises(ValueError, match="binomial and regression"):
        pxgb.XGBoost(booster="dart", ntrees=2).train(y="y", training_frame=fr)
    with pytest.raises(ValueError, match="requires a categorical"):
        pxgb.XGBoost(booster="dart", ntrees=2, distribution="bernoulli") \
            .train(y="t", training_frame=fr)
    with pytest.raises(NotImplementedError, match="DKV"):
        pxgb.XGBoost(booster="dart", ntrees=2, distribution="custom") \
            .train(y="t", training_frame=fr)
