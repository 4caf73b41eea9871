"""Scoring and early stopping in the port (h2o3_tpu_torch/models/gbm.py:
``_metric_device``, ``_grow_with_stopping``, ``_valid_stop_data``,
``_scoring_history``; models/model_base.py: ``validation_frame``,
``_history_table``) against the JAX reference on the same numpy-seeded
inputs (mirrors tests/test_trees.py::test_gbm_early_stopping); the cases
with a validation frame are in tests/test_torch_stopping_valid.py.

Metric values are held within rtol 1e-5 (float32 reductions in another
order; 1e-3 for a model's AUC history, where tied leaf groups share half
credit and a leaf value's last ulp decides a tie), the stop point, the
kept trees' splits and the history's shape exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM, _metric_device as jmetric
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM, _metric_device as pmetric
from jax_reference import _jax_compile_cache  # noqa: F401

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


CASES = [("bernoulli", m, 0) for m in
         ("AUTO", "logloss", "MSE", "RMSE", "misclassification", "AUC")] + \
    [("gaussian", m, 0) for m in ("AUTO", "deviance", "MSE", "RMSE")] + \
    [("poisson", "AUTO", 0), ("drf_prob", "AUTO", 0), ("drf_prob", "AUC", 0)] + \
    [("multinomial", m, 3) for m in
     ("AUTO", "logloss", "MSE", "RMSE", "misclassification")] + \
    [("drf_prob", "logloss", 3)]


@pytest.mark.parametrize("dist,metric,nclass", CASES)
def test_metric_matches_reference_metric_device(dist, metric, nclass):
    """Every stopping metric on the same margins, labels and weights; the
    margins are rounded to a few values so that AUC meets tied scores."""
    rng = np.random.default_rng(len(dist) * 7 + len(metric))
    n = 3000
    w = rng.uniform(0, 2, n).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0
    if nclass > 1:
        F = rng.normal(size=(n, nclass)).astype(np.float32)
        if dist == "drf_prob":
            F = np.abs(F) / np.abs(F).sum(1, keepdims=True)
        y = rng.integers(0, nclass, n).astype(np.float32)
    else:
        F = np.round(rng.normal(size=n) * 4) / 4   # ties
        if dist == "drf_prob":
            F = 1 / (1 + np.exp(-F))
        F = F.astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32) if dist in (
            "bernoulli", "drf_prob") else rng.poisson(2, n).astype(np.float32)
    want = float(jmetric(metric, dist, jnp.asarray(F), jnp.asarray(y),
                         jnp.asarray(w), nclass))
    got = float(pmetric(metric, dist, torch.from_numpy(F),
                        torch.from_numpy(y), torch.from_numpy(w), nclass))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if dist != "drf_prob":
        # the host-side score is the same computation
        assert GBM()._stop_score(metric.lower(), dist, torch.from_numpy(F),
                                 torch.from_numpy(y), torch.from_numpy(w),
                                 nclass) == got


def stop_cols(seed=1, n=400):
    """tests/test_trees.py's early-stopping data: a noisy signal on x0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-2.0 * X[:, 0])), "a", "b")
    return {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "y": y}


def _alike(jtrees, ptrees):
    assert len(jtrees) == len(ptrees)
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        for k in SPLIT_KEYS:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"tree {i} {k}")


def test_early_stopping_on_training_deviance_matches_reference():
    cols = stop_cols()
    kw = dict(ntrees=100, max_depth=3, stopping_rounds=3,
              stopping_tolerance=0.02, seed=1)
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    assert pm.output["ntrees"] < 100
    assert pm.output["ntrees"] == jm.output["ntrees"]
    _alike(jm.output["trees"], pm.output["trees"])
    assert pm.training_metrics.auc > 0.85
    np.testing.assert_allclose(pm.training_metrics.logloss,
                               jm.training_metrics.logloss, rtol=1e-5)
    # without stopping every tree grows
    assert GBM(ntrees=12, max_depth=3, seed=1).train(
        y="y", training_frame=Frame.from_arrays(cols)).output["ntrees"] == 12


def test_kept_trees_equal_per_tree_stopping_tree_for_tree():
    """A stop inside a chunk of rounds: the kept trees and the training
    metrics are those of a run of exactly that many trees (the margins are
    refolded over the kept trees)."""
    cols, vcols = stop_cols(5, 1500), stop_cols(6, 500)
    kw = dict(max_depth=3, learn_rate=0.5, seed=5)
    stopped = GBM(ntrees=80, stopping_rounds=1, stopping_tolerance=1e-2,
                  **kw).train(y="y", training_frame=Frame.from_arrays(cols),
                              validation_frame=Frame.from_arrays(vcols))
    k = stopped.output["ntrees"]
    assert 1 < k < 16          # inside the first chunk of 16 rounds
    straight = GBM(ntrees=k, **kw).train(
        y="y", training_frame=Frame.from_arrays(cols))
    for a, b in zip(straight.output["trees"], stopped.output["trees"]):
        for f in ("feat", "thresh_bin", "leaf"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert stopped.training_metrics.logloss == \
        straight.training_metrics.logloss


def test_multinomial_stopping_matches_reference():
    rng = np.random.default_rng(8)
    n = 900
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.array(["p", "q", "r"], dtype=object)[np.digitize(
        X[:, 0] + rng.normal(scale=0.8, size=n), [-0.5, 0.5])]
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "y": y}
    kw = dict(ntrees=40, max_depth=3, learn_rate=0.3, stopping_rounds=2,
              stopping_tolerance=0.01, seed=8, nbins=16)
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    kept = len(pm.output["trees_multi"][0])
    assert kept == len(jm.output["trees_multi"][0]) < 40
    for jt, pt in zip(jm.output["trees_multi"], pm.output["trees_multi"]):
        _alike(jt, pt)


def test_history_thins_by_score_tree_interval_and_keeps_the_last():
    cols = stop_cols(9, 600)
    fr = Frame.from_arrays(cols)
    m = GBM(ntrees=7, max_depth=2, seed=9, score_tree_interval=3).train(
        y="y", training_frame=fr)
    cols_, rows = m.scoring_history
    assert [c[0] for c in cols_] == ["timestamp", "duration",
                                     "number_of_trees", "training_deviance"]
    assert [r[2] for r in rows] == [3, 6, 7]
    every = GBM(ntrees=3, max_depth=2, seed=9,
                score_each_iteration=True).train(y="y", training_frame=fr)
    assert [r[2] for r in every.scoring_history[1]] == [1, 2, 3]
    # the last row's training deviance is the model's training logloss
    np.testing.assert_allclose(every.scoring_history[1][-1][3],
                               every.training_metrics.logloss, rtol=1e-5)


def test_stopping_metric_errors():
    cols = stop_cols(10, 200)
    reg = dict(cols, y=np.random.default_rng(0).normal(size=200)
               .astype(np.float32))
    with pytest.raises(ValueError, match="classification"):
        GBM(ntrees=3, stopping_rounds=2, stopping_metric="AUC").train(
            y="y", training_frame=Frame.from_arrays(reg))
    with pytest.raises(ValueError, match="unsupported stopping_metric"):
        GBM(ntrees=3, stopping_rounds=2, stopping_metric="lift").train(
            y="y", training_frame=Frame.from_arrays(cols))
    # h2o-py sends enum values lowercase
    m = GBM(ntrees=3, stopping_rounds=2, stopping_metric="auc").train(
        y="y", training_frame=Frame.from_arrays(cols))
    assert m.scoring_history[0][-1][0] == "training_auc"
