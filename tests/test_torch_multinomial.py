"""The port's class-batched tree growth and multinomial GBM
(h2o3_tpu_torch/models/tree.py:grow_trees_batched, models/gbm.py,
models/metrics.py:multinomial_metrics) against the JAX reference, on the
same numpy inputs, and the carry-over of a reference multinomial GBM
through h2o3_tpu_torch/convert.py.

Tree growth builds its histograms in another summation order than the
reference (which, under tests/conftest.py's 8 virtual devices, sums
per-device partials in GBM training): integer and bool heap arrays must be
equal, float ones allclose at rtol 1e-5, atol 1e-5. Sampling is off (rates
1.0): the two packages' random streams differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import metrics as jmetrics
from h2o3_tpu.models import tree as jtree
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.ops import quantile as jquantile
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as pmetrics
from h2o3_tpu_torch.models import tree as ptree
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from jax_reference import _jax_compile_cache  # noqa: F401

INT_FIELDS = ("feat", "thresh_bin", "na_left", "is_split")
ROWS = 12_000
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


def multi_cols(rows, seed=21, F=10):
    """A 3-class frame: the argmax of three linear scores plus Gumbel noise
    (a draw from their softmax), as chip_smoke.py builds at full width."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    scores = np.stack([0.9 * X[:, 0], -0.7 * X[:, 1], 0.8 * X[:, 2]], 1)
    y = (scores + rng.gumbel(size=(rows, 3))).argmax(1)
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["y"] = np.array([f"c{v}" for v in y])
    return cols


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


@pytest.mark.parametrize("w_per_class", [False, True])
def test_grow_trees_batched_matches_reference(w_per_class):
    rng = np.random.default_rng(22)
    R, F, K, nbins, depth = 4000, 6, 3, 16, 4
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    edges = jquantile.compute_bin_edges(X, nbins)
    binned = np.asarray(jquantile.bin_features(jnp.asarray(X),
                                               jnp.asarray(edges)))
    # the first multinomial round's softmax gradients at equal priors
    scores = np.nan_to_num(X[:, :K]) * np.array([0.9, -0.7, 0.8], np.float32)
    y = (scores + rng.gumbel(size=(R, K))).argmax(1)
    p = np.float32(1 / 3)
    g = (p - (y[None, :] == np.arange(K)[:, None])).astype(np.float32)
    h = np.full((K, R), p * (1 - p), np.float32)
    w = (rng.random((K, R)) + 0.5).astype(np.float32) if w_per_class \
        else np.ones(R, np.float32)
    params = dict(max_depth=depth, nbins=nbins, min_rows=5.0, reg_lambda=0.5)
    jt, jpred = jtree.grow_trees_batched(
        jnp.asarray(binned), jnp.asarray(edges), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(np.broadcast_to(w, (K, R))),
        jtree.TreeParams(**params), jnp.ones(F, bool), 1.0,
        jax.random.PRNGKey(0))
    pt, ppred = ptree.grow_trees_batched(
        _t(binned), _t(binned.T), _t(edges), _t(g), _t(h), _t(w),
        ptree.TreeParams(**params), torch.ones(F, dtype=torch.bool))
    assert len(pt) == K and ppred.shape == (K, R)
    for k in range(K):
        for name in HEAP_FIELDS:
            a, b = np.asarray(getattr(jt[k], name)), getattr(pt[k], name).numpy()
            if name in INT_FIELDS:
                np.testing.assert_array_equal(b, a, err_msg=f"class {k} {name}")
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                           err_msg=f"class {k} {name}")
        assert pt[k].is_split.sum() >= 3
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-5)


def test_one_class_batch_is_grow_tree():
    """``grow_tree`` is the K = 1 case of the batched growth."""
    rng = np.random.default_rng(23)
    R, F = 2000, 5
    binned = rng.integers(0, 17, size=(R, F)).astype(np.int8)
    edges = np.sort(rng.normal(size=(F, 15)), 1).astype(np.float32)
    g = rng.normal(size=R).astype(np.float32)
    h = np.ones(R, np.float32)
    params = ptree.TreeParams(max_depth=3, nbins=16)
    fm = torch.ones(F, dtype=torch.bool)
    one, leaf1 = ptree.grow_tree(_t(binned), _t(binned.T), _t(edges), _t(g),
                                 _t(h), _t(h), params, fm)
    batch, leafk = ptree.grow_trees_batched(
        _t(binned), _t(binned.T), _t(edges), _t(g)[None], _t(h)[None],
        _t(h), params, fm)
    for name in HEAP_FIELDS:
        assert torch.equal(getattr(one, name), getattr(batch[0], name)), name
    assert torch.equal(leaf1, leafk[0])


@pytest.fixture(scope="module")
def multinomial():
    cols = multi_cols(ROWS)
    jm = JGBM(**PARAMS).train(y="y", training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    pm = GBM(**PARAMS).train(y="y", training_frame=fr)
    return cols, jm, pm, fr


def test_multinomial_trees_equal_reference(multinomial):
    _, jm, pm, _ = multinomial
    assert pm.output["distribution"] == jm.output["distribution"] == \
        "multinomial"
    np.testing.assert_allclose(pm.output["f0_multi"].numpy(),
                               np.asarray(jm.output["f0_multi"]), rtol=1e-6)
    jtm, ptm = jm.output["trees_multi"], pm.output["trees_multi"]
    assert len(ptm) == len(jtm) == 3
    for k, (jts, pts) in enumerate(zip(jtm, ptm)):
        assert len(pts) == len(jts) == 5
        for i, (a, b) in enumerate(zip(jts, pts)):
            for name in INT_FIELDS:
                np.testing.assert_array_equal(
                    getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                    err_msg=f"class {k} tree {i} {name}")
            # leaves are -G/H over as few as min_rows rows: rtol 1e-4
            np.testing.assert_allclose(b.leaf.numpy(), np.asarray(a.leaf),
                                       rtol=1e-4, atol=1e-4)


def test_multinomial_predictions_and_metrics_match_reference(multinomial):
    cols, jm, pm, fr = multinomial
    jp = jm.predict(JFrame.from_arrays(cols))
    pp = pm.predict(fr)
    assert pp.names == jp.names == ["predict", "pc0", "pc1", "pc2"]
    for c in ("pc0", "pc1", "pc2"):
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   jp.vec(c).to_numpy()[:ROWS], atol=1e-5)
    jt, pt = jm.training_metrics, pm.training_metrics
    assert pt.nobs == jt.nobs == ROWS
    assert abs(pt.logloss - jt.logloss) < 1e-5
    np.testing.assert_array_equal(pt.confusion_matrix, jt.confusion_matrix)
    assert abs(pt.mean_per_class_error - jt.mean_per_class_error) < 1e-9
    # scoring the frame again gives the training metrics
    again = pm.model_performance(fr)
    assert abs(again.logloss - pt.logloss) < 1e-5
    np.testing.assert_array_equal(again.confusion_matrix, pt.confusion_matrix)


def test_multinomial_metrics_match_reference():
    rng = np.random.default_rng(24)
    n, K = 3000, 4
    logits = rng.normal(size=(n, K)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    y = rng.integers(0, K, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    want = jmetrics.multinomial_metrics(jnp.asarray(probs), jnp.asarray(y),
                                        jnp.asarray(mask), K)
    got = pmetrics.multinomial_metrics(_t(probs), _t(y), _t(mask), K)
    assert got.nobs == want.nobs
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    for k in ("logloss", "mse", "mean_per_class_error", "accuracy"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-6), k


def test_convert_scores_a_reference_multinomial_gbm(multinomial):
    cols, jm, _, fr = multinomial
    out = dict(jm.output, trees_multi=[
        [{k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS} for t in ts]
        for ts in jm.output["trees_multi"]])
    cm = convert.gbm_model(out, response_column="y",
                           response_domain=jm.response_domain)
    jp = jm.predict(JFrame.from_arrays(cols))
    pp = cm.predict(fr)
    for c in ("pc0", "pc1", "pc2"):
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   jp.vec(c).to_numpy()[:ROWS], atol=1e-6)
    np.testing.assert_array_equal(pp.vec("predict").to_numpy(),
                                  jp.vec("predict").to_numpy()[:ROWS])
