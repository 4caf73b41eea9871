"""The port's tree engine and binning (h2o3_tpu_torch/models/tree.py,
ops/quantile.py) against the JAX reference, fed the same numpy arrays.

Split search gets identical histograms in both packages, so its outputs
must agree to float32 rounding. Tree growth builds its own histograms, in
another summation order: integer heap arrays (feature, threshold bin, NA
direction, split flags) must be equal and float ones allclose at rtol 1e-5,
atol 1e-5 (leaves are ratios of sums differing in the last bits). The seeds
were checked to have no near-tie gains.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.models import tree as jtree
from h2o3_tpu.ops import quantile as jquantile
from h2o3_tpu_torch.models import tree as ptree
from h2o3_tpu_torch.ops import quantile as pquantile
from jax_reference import _jax_compile_cache  # noqa: F401

INT_FIELDS = ("feat", "thresh_bin", "na_left", "is_split")
FLOAT_FIELDS = ("thresh_val", "leaf", "gain", "cover")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frame_data(seed, R=3000, F=6, nbins=16, na_frac=0.05):
    """Raw features with NaNs, their edges and bins (reference binning),
    and bernoulli-like (g, h, w) at a zero margin."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < na_frac] = np.nan
    edges = jquantile.compute_bin_edges(X, nbins)
    binned = np.asarray(jquantile.bin_features(jnp.asarray(X),
                                               jnp.asarray(edges)))
    logit = X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) + 0.5 * np.nan_to_num(X[:, 2])
    y = (rng.random(R) < 1 / (1 + np.exp(-np.nan_to_num(logit)))).astype(np.float32)
    p = np.float32(0.5)
    g = (p - y).astype(np.float32)
    h = np.full(R, p * (1 - p), np.float32)
    w = np.ones(R, np.float32)
    return X, edges, binned, g, h, w


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


#: the reference grower compiled once per (depth, bins): op-by-op it is slow
_jax_grow = jax.jit(jtree._grow_tree_device,
                    static_argnames=("depth", "n_bins", "do_col_sample",
                                     "mesh"))


def test_bin_edges_are_the_reference_copy():
    X = _frame_data(0)[0]
    w = np.random.default_rng(1).random(X.shape[0])
    for nbins in (16, 64):
        for wt in (None, w):
            np.testing.assert_array_equal(
                pquantile.compute_bin_edges(X, nbins, wt),
                jquantile.compute_bin_edges(X, nbins, wt))


@pytest.mark.parametrize("nbins,dtype", [(16, torch.int8), (64, torch.int8),
                                         (200, torch.int16)])
def test_bin_features_equal_reference_with_nan_to_na_bin(nbins, dtype):
    X = _frame_data(2, nbins=nbins)[0]
    edges = jquantile.compute_bin_edges(X, nbins)
    want = np.asarray(jquantile.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    got = pquantile.bin_features(_t(X), _t(edges))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[np.isnan(X)] == nbins).all()


@pytest.mark.parametrize("masked", [False, True])
def test_find_splits_matches_reference(masked):
    X, edges, binned, g, h, w = _frame_data(3)
    N, B = 4, 16
    node = np.random.default_rng(4).integers(-1, N, binned.shape[0]).astype(np.int32)
    hists = np.asarray(jtree._level_histograms(
        jnp.asarray(binned), jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(w), N, B + 1))
    fmask = np.ones(binned.shape[1], bool)
    if masked:
        fmask[0] = False
    hp = (10.0, 1.0, 0.0, 0.0)
    want = jtree._find_splits(jnp.asarray(hists), B, *hp, jnp.asarray(fmask))
    got = ptree._find_splits(_t(hists), B, *hp, _t(fmask))
    names = ("gain", "feat", "t", "na_left", "G", "H", "W", "vl", "vr", "wl",
             "wr", "member")
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)


def test_route_rows_matches_reference():
    X, edges, binned, g, h, w = _frame_data(5)
    N, B, R = 4, 16, binned.shape[0]
    rng = np.random.default_rng(6)
    node = rng.integers(-1, N, R).astype(np.int32)
    feat = rng.integers(0, binned.shape[1], N).astype(np.int32)
    t = rng.integers(1, B, N)
    member = np.arange(B)[None, :] < t[:, None]
    na_left = rng.random(N) < 0.5
    do = np.array([True, False, True, True])
    want = jtree._route_rows(jnp.asarray(binned), jnp.asarray(node),
                             jnp.asarray(np.where(do, feat, -1)),
                             jnp.asarray(member), jnp.asarray(na_left),
                             jnp.asarray(do), B)
    got = ptree._route_rows(_t(binned), _t(node), _t(np.where(do, feat, -1)),
                            _t(member), _t(na_left), _t(do), B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grow_both(seed, depth, nbins, min_rows=10.0, reg_lambda=1.0):
    X, edges, binned, g, h, w = _frame_data(seed, nbins=nbins)
    fmask = np.ones(binned.shape[1], bool)
    hp = (min_rows, reg_lambda, 0.0, 0.0, 1e-5)
    want = _jax_grow(
        jnp.asarray(binned), jnp.asarray(binned.T), jnp.asarray(edges),
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), jnp.asarray(fmask),
        jax.random.PRNGKey(0), depth, nbins, *hp, 1.0, do_col_sample=False,
        mesh=None)
    got = ptree._grow_tree_device(
        _t(binned), _t(binned.T), _t(edges), _t(g), _t(h), _t(w), _t(fmask),
        depth, nbins, *hp)
    return X, binned, [np.asarray(a) for a in want], [b.numpy() for b in got]


@pytest.mark.parametrize("seed,depth,nbins", [(7, 3, 16), (8, 5, 64)])
def test_grow_tree_matches_reference(seed, depth, nbins):
    _, _, want, got = _grow_both(seed, depth, nbins)
    for name, a, b in zip(ptree.HEAP_FIELDS + ("row_leaf",), want, got):
        if name in INT_FIELDS:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)
    assert got[ptree.HEAP_FIELDS.index("is_split")].sum() >= 3


def _trees_from(heaps):
    """The same heaps as reference Tree objects and port Tree objects."""
    jt = [jtree.Tree(**{k: jnp.asarray(a) for k, a in
                        zip(ptree.HEAP_FIELDS, h)}) for h in heaps]
    pt = [ptree.Tree(**{k: _t(a) for k, a in zip(ptree.HEAP_FIELDS, h)})
          for h in heaps]
    return jt, pt


@pytest.fixture(scope="module")
def ensemble():
    """Three reference-grown depth-4 trees on one frame, shared by both
    packages' scoring functions (so scoring alone is compared)."""
    X, edges, binned, g, h, w = _frame_data(9, nbins=32)
    heaps = []
    for k in range(3):
        gk = (g * (1.0 + 0.3 * k) + 0.05 * k).astype(np.float32)
        out = _jax_grow(
            jnp.asarray(binned), jnp.asarray(binned.T), jnp.asarray(edges),
            jnp.asarray(gk), jnp.asarray(h), jnp.asarray(w),
            jnp.ones(binned.shape[1], bool), jax.random.PRNGKey(k), 4, 32,
            10.0, 1.0, 0.0, 0.0, 1e-5, 1.0, do_col_sample=False, mesh=None)
        heaps.append([np.asarray(a) for a in out[:-1]])
    return X, binned, _trees_from(heaps)


def test_predict_binned_matches_reference(ensemble):
    X, binned, (jt, pt) = ensemble
    want = np.asarray(jtree.predict_binned(jnp.asarray(binned), jt, 32))
    got = ptree.predict_binned(_t(binned), pt, 32).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold_binned_matches_reference(ensemble):
    X, binned, (jt, pt) = ensemble
    F0 = np.full(binned.shape[0], -0.25, np.float32)
    want = np.asarray(jtree.fold_binned(jnp.asarray(binned), jt, 32, 0.1,
                                        jnp.asarray(F0)))
    got = ptree.fold_binned(_t(binned), pt, 32, 0.1, _t(F0)).numpy()
    # XLA may fuse each `acc + lr * leaf` into one multiply-add (one
    # rounding) where torch rounds twice: a float32 ulp of the operands
    # (|margin| < 2) per tree
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * len(pt))


def test_predict_raw_matches_reference_with_nan(ensemble):
    X, binned, (jt, pt) = ensemble
    assert np.isnan(X).any()
    want = np.asarray(jtree.predict_raw(jnp.asarray(X), jt))
    got = ptree.predict_raw(_t(X), pt).numpy()
    np.testing.assert_array_equal(got, want)
    # raw traversal by edge values reaches the leaves binned traversal does
    np.testing.assert_array_equal(
        got, ptree.predict_binned(_t(binned), pt, 32).numpy())
