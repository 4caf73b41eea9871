"""The single decision tree in the port
(h2o3_tpu_torch/models/decision_tree.py) against the JAX reference
(``h2o3_tpu/models/decision_tree.py``) on the same numpy-seeded frames.

One tree, no sampling, at the defaults (depth 10, min_rows 10): split
features and split nodes equal to the reference's, and every training row
reaches the same leaf in both trees. Thresholds and missing-value
directions are held through the rows: at a deep node of few rows, the
thresholds on either side of empty bins split the rows alike and gain
exactly alike, and the last bits a sibling subtraction leaves in those
empty bins pick one. Leaves within rtol 1e-5 and atol 1e-6 (float32 node
sums in another order), predictions within atol 1e-6 and training metrics
within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import decision_tree as jdt
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import decision_tree as pdt
from h2o3_tpu_torch.models.gbm import tree_matrix
from h2o3_tpu_torch.models.tree import HEAP_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def dt_cols(n=4000, F=6, seed=51):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.04] = np.nan
    Z = np.nan_to_num(X)
    logit = 1.2 * Z[:, 0] - Z[:, 1] + 0.8 * Z[:, 2] * Z[:, 3]
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["c"] = np.array(["u", "v", "w", "z"], dtype=object)[
        rng.integers(0, 4, n)]
    cols["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    cols["t"] = (logit + 0.4 * rng.normal(size=n)
                 + (cols["c"] == "w")).astype(np.float32)
    return cols


def leaf_of_rows(tree, X: np.ndarray, cat_card) -> np.ndarray:
    """The heap leaf each row of X (raw features, categorical codes as
    floats) reaches, by thresholds or, at a categorical feature of a
    group-split tree, by the left mask of the code's bin."""
    feat, tv, nal, isp = (np.asarray(getattr(tree, k)) for k in
                          ("feat", "thresh_val", "na_left", "is_split"))
    mask = np.asarray(tree.left_mask)
    idx = np.zeros(X.shape[0], np.int64)
    while isp[idx].any():
        f = np.maximum(feat[idx], 0)
        xv = X[np.arange(X.shape[0]), f]
        code = np.clip(np.nan_to_num(xv).astype(np.int64), 0,
                       mask.shape[1] - 1)
        left = np.where(cat_card[f] > 0, mask[idx, code], xv < tv[idx])
        left = np.where(np.isnan(xv), nal[idx], left)
        idx = np.where(isp[idx], idx * 2 + np.where(left, 1, 2), idx)
    return idx


@pytest.fixture(scope="module")
def trees():
    cols = dt_cols()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    x = [f"x{i}" for i in range(6)] + ["c"]
    out = {}
    for y in ("y", "t"):
        out[y] = (jdt.DecisionTree().train(x=x, y=y, training_frame=jf),
                  pdt.DecisionTree().train(x=x, y=y, training_frame=pf))
    return cols, jf, pf, out


def test_defaults_match_the_reference():
    j, p = jdt.DecisionTree().params, pdt.DecisionTree().params
    for k in ("max_depth", "min_rows", "nbins", "ntrees",
              "min_split_improvement", "nbins_cats", "categorical_encoding"):
        assert p[k] == j[k], k
    assert (p["max_depth"], p["min_rows"], p["nbins"]) == (10, 10.0, 64)


@pytest.mark.parametrize("y", ["y", "t"])
def test_tree_equals_reference(trees, y):
    cols, jf, pf, out = trees
    jm, pm = out[y]
    jt, pt = jm.output["trees"][0], pm.output["trees"][0]
    assert pt.left_mask is not None and int(pm.output["cat_bins"]) == 64
    for k in ("feat", "is_split"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    X = tree_matrix(pf, pm.output["x_cols"], pm.output["feat_domains"]) \
        .numpy()
    cc = pm.output["cat_card"].numpy()
    np.testing.assert_array_equal(leaf_of_rows(pt, X, cc),
                                  leaf_of_rows(jt, X, cc))
    same = (pt.thresh_bin.numpy() == np.asarray(jt.thresh_bin)).mean()
    assert same > 0.99
    np.testing.assert_allclose(pt.leaf.numpy(), np.asarray(jt.leaf),
                               rtol=1e-5, atol=1e-6)
    # depth 10 at min_rows 10: deep levels of many nodes
    assert int(pt.is_split.sum()) > 60
    col = "pyes" if y == "y" else "predict"
    n = pf.nrows
    np.testing.assert_allclose(pm.predict(pf).vec(col).to_numpy(),
                               jm.predict(jf).vec(col).to_numpy()[:n],
                               atol=1e-6)
    metric = "auc" if y == "y" else "mse"
    assert getattr(pm.training_metrics, metric) == pytest.approx(
        getattr(jm.training_metrics, metric), rel=1e-6)
    # the training predictions are the growth's own leaves: scoring the
    # frame gives the same metric
    assert getattr(pm.model_performance(pf), metric) == pytest.approx(
        getattr(pm.training_metrics, metric), rel=1e-9)


def test_reference_tree_scores_through_convert(trees):
    cols, jf, pf, out = trees
    jm = out["y"][0]
    o = dict(jm.output, cat_card=np.asarray(jm.output["cat_card"]),
             trees=[dict({k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS},
                         left_mask=np.asarray(t.left_mask))
                    for t in jm.output["trees"]])
    cm = convert.decision_tree_model(o, response_column="y",
                                     response_domain=jm.response_domain,
                                     device="cpu")
    assert isinstance(cm, pdt.DecisionTreeModel)
    np.testing.assert_allclose(cm.predict(pf).vec("pyes").to_numpy(),
                               jm.predict(jf).vec("pyes").to_numpy()[:pf.nrows],
                               atol=1e-6)
    # varimp and contributions of the carried tree are the reference's
    want = jm.varimp()
    assert [r[0] for r in cm.varimp()] == [r[0] for r in want]
    got = cm.predict_contributions(pf)
    ref = jm.predict_contributions(jf)
    for name in got.names:
        np.testing.assert_allclose(got.vec(name).to_numpy(),
                                   ref.vec(name).to_numpy()[:pf.nrows],
                                   atol=1e-6)


def test_decision_tree_refuses_what_it_does_not_apply():
    cols = dt_cols(300, seed=52)
    fr = Frame.from_arrays(cols)
    with pytest.raises(ValueError, match="binary or numeric"):
        pdt.DecisionTree().train(y="c", training_frame=fr)
    for bad in (dict(ntrees=5), dict(sample_rate=0.5),
                dict(calibrate_model=True), dict(stopping_rounds=2)):
        with pytest.raises(ValueError, match="does not take"):
            pdt.DecisionTree(**bad).train(y="y", training_frame=fr)
