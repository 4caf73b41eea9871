"""The port's XGBoost (h2o3_tpu_torch/models/xgboost.py, gbtree booster)
against the JAX reference ``h2o3_tpu.models.xgboost.XGBoost``: h2o-py's
parameter aliases, a 256-bin (int16) model with L1, L2 and a minimum split
loss, the boosters that wait or refuse, and the carry-over of a reference
model through h2o3_tpu_torch/convert.py.

Trees must be equal in structure; leaves within rtol 1e-4 (ratios of sums
in another order: the reference sums per-device partials under
tests/conftest.py's 8 virtual devices) and probabilities within atol 1e-5.
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
from h2o3_tpu_torch.ops import hist
from jax_reference import _jax_compile_cache  # noqa: F401

INT_FIELDS = ("feat", "thresh_bin", "na_left", "is_split")
ROWS = 20_000
PARAMS = dict(ntrees=5, max_depth=5, max_bin=256, eta=0.3, reg_lambda=1.0,
              reg_alpha=0.5, gamma=0.1, seed=42)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def higgs_cols(rows, seed=51, F=16):
    """bench.py's _higgs_frame generator at a small size and width."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = X[:, :4] @ np.array([1.2, -0.8, 0.5, 0.3], np.float32) \
        + 0.2 * X[:, 4] * X[:, 5]
    y = rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["y"] = np.where(y, "s", "b")
    return cols


ALIASED = dict(eta=0.2, max_bin=128, subsample=0.8, colsample_bytree=0.7,
               colsample_bylevel=0.6, colsample_bynode=0.5,
               min_child_weight=3.0, min_split_loss=0.2, max_delta_step=1.0,
               tree_method="hist", grow_policy="depthwise")


def test_aliases_map_as_the_reference_maps_them():
    j, p = jxgb.XGBoost(**ALIASED), pxgb.XGBoost(**ALIASED)
    for k in ("learn_rate", "nbins", "sample_rate", "col_sample_rate_per_tree",
              "col_sample_rate", "col_sample_by_node", "min_rows", "gamma"):
        assert p.params[k] == j.params[k], k
    assert not {"eta", "max_bin", "tree_method", "max_delta_step"} & set(
        p.params)
    assert p._effective_col_rate() == pytest.approx(j._effective_col_rate())
    # an explicit engine name wins over its alias, as in the reference
    both = dict(learn_rate=0.05, eta=0.2)
    assert pxgb.XGBoost(**both).params["learn_rate"] == \
        jxgb.XGBoost(**both).params["learn_rate"] == 0.05


def test_defaults_match_the_reference():
    j, p = jxgb.XGBoost.defaults(), pxgb.XGBoost.defaults()
    for k in ("ntrees", "max_depth", "learn_rate", "reg_lambda", "reg_alpha",
              "gamma", "min_rows", "nbins", "sample_rate", "col_sample_rate",
              "col_sample_rate_per_tree", "col_sample_by_node", "booster"):
        assert p[k] == j[k], k


@pytest.fixture(scope="module")
def models():
    cols = higgs_cols(ROWS)
    jm = jxgb.XGBoost(**PARAMS).train(y="y",
                                      training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    before = hist.launch_count()
    pm = pxgb.XGBoost(**PARAMS).train(y="y", training_frame=fr)
    assert hist.launch_count() == before   # the CPU launches none
    return cols, jm, pm, fr


def test_256_bin_trees_equal_reference(models):
    _, jm, pm, _ = models
    assert type(pm).__name__ == type(jm).__name__ == "XGBoostModel"
    assert pm.output["distribution"] == "bernoulli"
    assert pm.output["edges"].shape == (16, 255)
    np.testing.assert_array_equal(pm.output["edges"].numpy(),
                                  np.asarray(jm.output["edges"]))
    assert len(pm.output["trees"]) == len(jm.output["trees"]) == 5
    for i, (a, b) in enumerate(zip(jm.output["trees"], pm.output["trees"])):
        for k in INT_FIELDS:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(b.leaf.numpy(), np.asarray(a.leaf),
                                   rtol=1e-4, atol=1e-5, err_msg=f"tree {i}")
    # reg_alpha soft-thresholds G and gamma raises the split bar: both bite
    assert any(bool((~t.is_split).any()) for t in pm.output["trees"])


def test_256_bin_predictions_match_reference(models):
    cols, jm, pm, fr = models
    np.testing.assert_allclose(
        pm.predict(fr).vec("ps").to_numpy(),
        jm.predict(JFrame.from_arrays(cols)).vec("ps").to_numpy()[:ROWS],
        atol=1e-5)
    assert abs(pm.training_metrics.auc - jm.training_metrics.auc) < 1e-4
    assert abs(pm.training_metrics.logloss - jm.training_metrics.logloss) \
        < 1e-5


def test_binned_with_int16_and_257_bins_per_level(models):
    _, _, pm, fr = models
    b = pxgb.XGBoost(**PARAMS)
    binned = b._bin_frame(fr, pm.output["x_cols"], pm.output["edges"])
    assert binned.dtype == torch.int16 and int(binned.max()) <= 256


@pytest.mark.parametrize("booster,exc", [("dart", ValueError),
                                         ("gblinear", ValueError),
                                         ("nope", ValueError)])
def test_boosters_other_than_gbtree_raise(booster, exc):
    """gblinear and unknown boosters raise; DART trains, and raises only on
    a checkpoint, as the reference's does."""
    fr = Frame.from_arrays(higgs_cols(500, seed=52))
    params = dict(ntrees=1, booster=booster)
    if booster == "dart":
        params["checkpoint"] = pxgb.XGBoost(ntrees=1).train(
            y="y", training_frame=fr)
    with pytest.raises(exc, match=booster):
        pxgb.XGBoost(**params).train(y="y", training_frame=fr)


def test_convert_scores_a_reference_xgboost(models):
    cols, jm, _, fr = models
    out = dict(jm.output, trees=[{k: np.asarray(getattr(t, k))
                                  for k in HEAP_FIELDS}
                                 for t in jm.output["trees"]])
    cm = convert.xgboost_model(out, response_column="y",
                               response_domain=jm.response_domain)
    assert isinstance(cm, pxgb.XGBoostModel)
    np.testing.assert_allclose(
        cm.predict(fr).vec("ps").to_numpy(),
        jm.predict(JFrame.from_arrays(cols)).vec("ps").to_numpy()[:ROWS],
        atol=1e-6)
