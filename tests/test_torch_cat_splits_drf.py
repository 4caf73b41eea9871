"""Categorical group splits of the port's DRF and of class batches, and the
range grouping above ``nbins_cats``, against the JAX reference (the cases
of tests/test_torch_cat_splits.py that train a DRF or a class batch, at
its tolerances: split choices, masks and integer heap fields exactly,
floats within rtol 1e-5): a file of its own so that pytest-xdist's
``--dist loadfile`` spreads the group-split cases over its workers."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import tree as jtree
from h2o3_tpu.models.gbm import DRF as JDRF, GBM as JGBM
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import tree as ptree
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_cat_splits import (SPLIT_KEYS, _cpu_port,  # noqa: F401
                                   _heaps_alike, _t, interleaved)


def test_range_grouping_above_nbins_cats_matches_reference():
    """40 levels, nbins_cats 8: codes range-group into 8 bins."""
    rng = np.random.default_rng(7)
    n = 1500
    codes = rng.integers(0, 40, size=n)
    y = rng.random(n) < np.where(codes < 20, 0.85, 0.15)
    cols = {"c": np.array([f"lv{i:02d}" for i in range(40)],
                          dtype=object)[codes],
            "y": np.array(["no", "yes"], dtype=object)[y.astype(int)]}
    kw = dict(ntrees=3, max_depth=2, nbins=16, nbins_cats=8, seed=3)
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    assert pm.output["cat_bins"] == 8
    _heaps_alike(jm.output["trees"], pm.output["trees"])
    assert pm.training_metrics.auc > 0.8


def test_one_drf_group_split_tree_matches_reference():
    """One DRF tree with group splits on the same bootstrap weights (the
    packages' random numbers differ, so whole forests compare by metric):
    the reference's ``_grow_tree_device`` with ``cat_feats``."""
    rng = np.random.default_rng(11)
    R, nbins, depth = 4000, 16, 4
    codes = rng.integers(0, 12, R)
    xnum = rng.normal(size=R).astype(np.float32)
    edges = np.full((2, nbins - 1), np.inf, np.float32)
    edges[1] = np.quantile(xnum, np.linspace(0, 1, nbins + 1)[1:-1])
    binned = np.stack([codes, np.searchsorted(edges[1], xnum, side="right")],
                      1).astype(np.int8)
    y = (rng.random(R) < np.where(codes % 3 == 0, 0.8, 0.2)).astype(np.float32)
    wt = rng.poisson(0.632, R).astype(np.float32)
    g, h = (-y * wt).astype(np.float32), wt
    cat = np.array([True, False])
    hp = (1.0, 0.0, 0.0, 0.0, 1e-5)
    want = jax.jit(jtree._grow_tree_device,
                   static_argnames=("depth", "n_bins", "do_col_sample",
                                    "mesh"))(
        jnp.asarray(binned), jnp.asarray(binned.T), jnp.asarray(edges),
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(wt),
        jnp.ones(2, bool), jax.random.PRNGKey(0), depth, nbins, *hp, 1.0,
        do_col_sample=False, cat_feats=jnp.asarray(cat), mesh=None)
    got = ptree._grow_tree_device(
        _t(binned), _t(binned.T), _t(edges), _t(g), _t(h), _t(wt),
        torch.ones(2, dtype=torch.bool), depth, nbins, *hp,
        cat_feats=_t(cat))
    names = HEAP_FIELDS + ("left_mask", "row_leaf")
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert got[HEAP_FIELDS.index("is_split")].sum() >= 5


def test_class_batch_with_group_splits_matches_reference():
    """K = 3 class trees grown as one batch, a mask per class tree."""
    rng = np.random.default_rng(13)
    R, nbins, depth, K = 3000, 16, 3, 3
    codes = rng.integers(0, 9, R)
    xnum = rng.normal(size=R).astype(np.float32)
    edges = np.full((2, nbins - 1), np.inf, np.float32)
    edges[1] = np.quantile(xnum, np.linspace(0, 1, nbins + 1)[1:-1])
    binned = np.stack([codes, np.searchsorted(edges[1], xnum, side="right")],
                      1).astype(np.int8)
    g = rng.normal(size=(K, R)).astype(np.float32) + (codes % 3 == 0)
    h = np.ones((K, R), np.float32)
    w = np.ones(R, np.float32)
    params = ptree.TreeParams(max_depth=depth, nbins=nbins, min_rows=5.0,
                              reg_lambda=0.0)
    cat = np.array([True, False])
    jt, jpred = jtree.grow_trees_batched(
        jnp.asarray(binned), jnp.asarray(edges), jnp.asarray(g),
        jnp.asarray(h), jnp.broadcast_to(jnp.asarray(w), (K, R)), params,
        jnp.ones(2, bool), cat_feats=jnp.asarray(cat))
    pt, ppred = ptree.grow_trees_batched(
        _t(binned), _t(binned.T), _t(edges), _t(g), _t(h), _t(w), params,
        torch.ones(2, dtype=torch.bool), cat_feats=_t(cat))
    _heaps_alike(jt, pt)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-6)


def test_drf_group_splits_learn_the_interleaved_levels():
    cols = interleaved(np.random.default_rng(17), n=1500)
    jm = JDRF(ntrees=10, max_depth=4, seed=5).train(
        y="y", training_frame=JFrame.from_arrays(cols))
    pm = DRF(ntrees=10, max_depth=4, seed=5).train(
        y="y", training_frame=Frame.from_arrays(cols))
    assert pm.output["trees"][0].left_mask is not None
    assert pm.training_metrics.auc > 0.8
    assert abs(pm.training_metrics.auc - jm.training_metrics.auc) < 0.03
