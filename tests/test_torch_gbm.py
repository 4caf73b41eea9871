"""The port's GBM end to end (h2o3_tpu_torch/models/gbm.py) against the JAX
reference ``h2o3_tpu.models.gbm.GBM`` on a small HIGGS-shaped frame, plus
the weight carry-over of ``h2o3_tpu_torch/convert.py`` and the data plane
under them.

The reference runs on tests/conftest.py's 8 virtual devices: its columns
are padded to a multiple of 64 rows (per-row outputs are cut to ``nrows``)
and its level histograms are per-device partials summed by one psum
(``tree.py:_level_histograms_fused``), so its float32 sums differ from the
port's in the last bits. Trees must still be equal in structure; leaves,
gains and predictions are held to the tolerances stated at each check.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame import vec as jvec
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame import vec as pvec
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.tree import HEAP_FIELDS, fold_binned
from h2o3_tpu_torch.ops import hist
from jax_reference import _jax_compile_cache  # noqa: F401

ROWS = 20_000
PARAMS = dict(ntrees=5, max_depth=5, nbins=32, learn_rate=0.1, seed=42)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def higgs_cols(rows, seed=11):
    """bench.py's _higgs_frame generator at a small size."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    logit = X[:, :4] @ np.array([1.2, -0.8, 0.5, 0.3], np.float32) \
        + 0.2 * X[:, 4] * X[:, 5]
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    cols = {f"x{i}": X[:, i] for i in range(28)}
    cols["y"] = np.where(y == 1, "s", "b")
    return cols, logit.astype(np.float32)


@pytest.fixture(scope="module")
def binomial():
    cols, _ = higgs_cols(ROWS)
    jm = JGBM(**PARAMS).train(y="y", training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    pm = GBM(**PARAMS).train(y="y", training_frame=fr)
    return cols, jm, pm, fr


def _heaps_equal(jtrees, ptrees):
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        for k in ("feat", "thresh_bin", "na_left", "is_split"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"tree {i} {k}")
        # leaves are -G/H over as few as min_rows rows: rtol 1e-4; gains are
        # differences of large terms: 1e-5 of the tree's largest gain
        np.testing.assert_allclose(b.leaf.numpy(), np.asarray(a.leaf),
                                   rtol=1e-4, atol=1e-4, err_msg=f"tree {i}")
        ga = np.asarray(a.gain)
        np.testing.assert_allclose(b.gain.numpy(), ga, rtol=1e-4,
                                   atol=1e-5 * np.abs(ga).max(),
                                   err_msg=f"tree {i}")
        np.testing.assert_allclose(b.cover.numpy(), np.asarray(a.cover),
                                   rtol=1e-6, err_msg=f"tree {i}")
        np.testing.assert_array_equal(b.thresh_val.numpy(),
                                      np.asarray(a.thresh_val))


def test_binomial_trees_equal_reference(binomial):
    _, jm, pm, _ = binomial
    assert pm.output["distribution"] == jm.output["distribution"] == "bernoulli"
    assert pm.output["f0"] == jm.output["f0"]
    np.testing.assert_array_equal(pm.output["edges"].numpy(),
                                  np.asarray(jm.output["edges"]))
    assert len(pm.output["trees"]) == len(jm.output["trees"]) == 5
    _heaps_equal(jm.output["trees"], pm.output["trees"])


def test_binomial_predictions_and_auc_match_reference(binomial):
    cols, jm, pm, fr = binomial
    # training AUC from the 400-bin histogram: within 1e-4
    assert abs(pm.training_metrics.auc - jm.training_metrics.auc) < 1e-4
    assert abs(pm.training_metrics.logloss - jm.training_metrics.logloss) < 1e-5
    assert pm.training_metrics.nobs == jm.training_metrics.nobs == ROWS
    jp = jm.predict(JFrame.from_arrays(cols))
    pp = pm.predict(fr)
    assert pp.names == jp.names == ["predict", "pb", "ps"]
    # probabilities through leaves that differ by ~1e-5: atol 1e-5
    np.testing.assert_allclose(pp.vec("ps").to_numpy(),
                               jp.vec("ps").to_numpy(), atol=1e-5)
    agree = (pp.vec("predict").to_numpy() == jp.vec("predict").to_numpy()).mean()
    assert agree > 0.999
    assert pp.vec("predict").domain == ("b", "s")


def test_convert_scores_a_reference_model_like_the_reference(binomial):
    cols, jm, _, fr = binomial
    out = dict(jm.output, trees=[{k: np.asarray(getattr(t, k))
                                  for k in HEAP_FIELDS}
                                 for t in jm.output["trees"]])
    cm = convert.gbm_model(out, response_column="y",
                           response_domain=jm.response_domain)
    # the same trees: only float32 rounding of the margin sums differs
    np.testing.assert_allclose(cm.predict(fr).vec("ps").to_numpy(),
                               jm.predict(JFrame.from_arrays(cols))
                               .vec("ps").to_numpy(), atol=1e-6)
    mm = cm.model_performance(fr)
    assert abs(mm.auc - jm.training_metrics.auc) < 1e-4


def test_gaussian_trees_and_predictions_match_reference():
    cols, logit = higgs_cols(6000, seed=3)
    cols = {k: v for k, v in cols.items() if k != "y"}
    cols["t"] = logit
    params = dict(ntrees=3, max_depth=4, nbins=64, learn_rate=0.1, seed=42)
    jm = JGBM(**params).train(y="t", training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    pm = GBM(**params).train(y="t", training_frame=fr)
    assert pm.output["distribution"] == jm.output["distribution"] == "gaussian"
    assert abs(pm.output["f0"] - jm.output["f0"]) < 1e-6
    _heaps_equal(jm.output["trees"], pm.output["trees"])
    np.testing.assert_allclose(
        pm.predict(fr).vec("predict").to_numpy(),
        jm.predict(JFrame.from_arrays(cols)).vec("predict").to_numpy(),
        atol=1e-5)
    assert abs(pm.training_metrics.mse - jm.training_metrics.mse) < 1e-5
    assert abs(pm.training_metrics.r2 - jm.training_metrics.r2) < 1e-5
    assert abs(pm.training_metrics.mean_residual_deviance
               - jm.training_metrics.mean_residual_deviance) < 1e-5


def test_fold_binned_reproduces_the_boosting_margins_exactly():
    """The port's own contract: folding its trees over the training bins
    reproduces the boosting loop's final margins bit for bit."""
    cols, logit = higgs_cols(3000, seed=5)
    cols = {k: v for k, v in cols.items() if k != "y"}
    cols["t"] = logit
    fr = Frame.from_arrays(cols)
    b = GBM(ntrees=4, max_depth=3, nbins=16)
    x = [c for c in fr.names if c != "t"]
    m = b._fit(Job("fold"), fr, x, "t", fr.row_mask().float())
    binned = b._bin_frame(fr, x, m.output["edges"])
    F0 = torch.full((fr.nrows,), m.output["f0"], dtype=torch.float32)
    got = fold_binned(binned, m.output["trees"], 16, m.output["learn_rate"], F0)
    assert torch.equal(got, b._last_train_raw)


def test_training_on_cpu_launches_no_kernel():
    before = hist.launch_count()
    cols, _ = higgs_cols(2000, seed=7)
    m = GBM(ntrees=2, max_depth=3, nbins=16).train(
        y="y", training_frame=Frame.from_arrays(cols))
    assert hist.launch_count() == before
    assert m.training_metrics.auc > 0.5


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    set_device(None)
    try:
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Frame.from_arrays({"a": np.zeros(3, np.float32)})
        fr = Frame.from_arrays({"a": np.zeros(3, np.float32)}, device="cpu")
        assert fr.device.type == "cpu"
    finally:
        set_device("cpu")


def test_frame_columns_match_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=500).astype(np.float32)
    x[::7] = np.nan
    x[3], x[5] = np.inf, 0.0
    labels = rng.choice(["b", "a", "c"], size=500)
    pf = Frame.from_arrays({"x": x, "c": labels})
    jf = JFrame.from_arrays({"x": x, "c": labels})
    assert pf.types == jf.types
    assert pf.vec("c").domain == jf.vec("c").domain == ("a", "b", "c")
    np.testing.assert_array_equal(pf.vec("c").to_numpy(), jf.vec("c").to_numpy())
    np.testing.assert_array_equal(pf.vec("x").as_float().numpy(),
                                  np.asarray(jf.vec("x").as_float())[:500])
    for v in ("x", "c"):
        a, b = pf.vec(v).rollups(), jf.vec(v).rollups()
        for k in ("nrows", "na_cnt", "min", "max", "nzero", "is_int",
                  "pinfs", "ninfs"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), nan_ok=True), k
        assert a.mean == pytest.approx(b.mean, rel=1e-6, nan_ok=True)
        assert a.sigma == pytest.approx(b.sigma, rel=1e-5, nan_ok=True)


@pytest.mark.parametrize("values", [
    np.array(["s", "b", "s", "a"]),
    np.array(["x", None, "y", float("nan"), "x"], dtype=object),
])
def test_factorize_matches_reference(values):
    pc, pd = pvec._factorize(values)
    jc, jd = jvec._factorize(values)
    np.testing.assert_array_equal(pc, jc)
    assert list(pd) == list(jd)
