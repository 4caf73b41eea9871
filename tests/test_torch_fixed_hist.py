"""The fixed-point histogram kernel's plan and scale rule
(h2o3_tpu_torch/ops/hist.py: ``_fixed_plan``, ``fixed_qbits``,
``fixed_exponents``, ``level_histograms_fixed_plain``) on the CPU.

``level_histograms_fixed_plain`` is what ``fixed_hist_kernel`` computes, bit
for bit (the card-only cases in tests/test_torch_hist.py hold the kernel to
it). Here it is held to float64 sums within the kernel's stated bound, n x
max|x_s| x 2^-qbits per entry of n rows plus float32 rounding of the result,
and to the JAX reference's ``_level_histograms`` within the port's usual
tolerance (rtol 1e-5 with a floor of 1e-5 x max|hist|) at the shapes of
tests/test_pallas_interpret.py, where qbits is 22.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.models.tree import _level_histograms
from h2o3_tpu_torch.ops import hist
from jax_reference import _jax_compile_cache  # noqa: F401

#: (rows, features, bins incl. NA, nodes)
SHAPES = [(4096, 7, 17, 8), (2048, 3, 257, 128), (3001, 5, 1025, 2)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed, R, F, Bt, N, K=None, w_scale=None):
    """Bins in [0, Bt), nodes in [-1, N), g normal, h in [0.1, 1.1), w ones
    (or uniform in [0, w_scale)); node/g/h [K, R] for a class batch."""
    rng = np.random.default_rng(seed)
    shape = (R,) if K is None else (K, R)
    binned_T = torch.from_numpy(
        rng.integers(0, Bt, size=(F, R)).astype(np.int16))
    node = torch.from_numpy(rng.integers(-1, N, size=shape).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    h = torch.from_numpy((rng.random(shape) + 0.1).astype(np.float32))
    w = (torch.ones(R) if w_scale is None else
         torch.from_numpy((rng.random(R) * w_scale).astype(np.float32)))
    return binned_T, node, g, h, w


def _bound(args, N, Bt, qbits, exact):
    """The stated bound per entry: n rows x half a step (2^(E_s - qbits -
    1) <= max|x_s| x 2^-qbits) plus float32 rounding of the result."""
    binned_T, node, g, h, w = args
    ones = torch.ones(node.shape)
    rows = hist.level_histograms_plain(binned_T, node, ones, ones, ones, N,
                                       Bt).double()
    exps, _ = hist.fixed_exponents(node, g, h, w, N, qbits)
    step = torch.tensor([2.0 ** (-e - 1) for e in exps], dtype=torch.float64)
    quant = rows * step
    return quant + 2.0 ** -24 * (exact.abs() + quant)


def _exact(args, N, Bt):
    binned_T, node, g, h, w = args
    return hist.level_histograms_plain(binned_T, node, g.double(), h.double(),
                                       w.double(), N, Bt)


@pytest.mark.parametrize("N,Bt,bb,K", [
    (1, 257, 2, 1), (2, 257, 2, 1), (8, 257, 2, 1), (1, 1025, 2, 1),
    (2, 1025, 2, 1), (1, 65, 1, 1), (32, 65, 1, 3), (4, 129, 2, 1),
    (16, 129, 2, 1), (1, 257, 2, 3), (1, 1025, 2, 3),
])
def test_plan_takes_the_fixed_kernel_at_its_switch_entries(N, Bt, bb, K):
    """The switch's fixed entries plan the fixed kernel, whose slab and
    tile fit a block's 227 KB with room for its static shared memory; a
    class batch keeps the block shape of one class."""
    p = hist._plan(11_000_000, 28, N, Bt, bb, 132, 1, None, K)
    assert p["kernel"] == "fixed"
    assert p["smem_bytes"] == hist._fixed_smem_bytes(
        p["features_per_group"], p["nodes_per_block"], Bt, bb)
    assert p["smem_bytes"] + 1024 <= 227 * 1024
    assert p["groups"] * p["features_per_group"] >= 28
    assert p["node_blocks"] * p["nodes_per_block"] >= N
    assert p["blocks"] == p["groups"] * p["node_blocks"] * p["row_splits"] * K
    one = hist._plan(11_000_000, 28, N, Bt, bb, 132, 1, None, 1)
    for key in ("features_per_group", "nodes_per_block", "smem_bytes"):
        assert p[key] == one[key]


def test_one_node_of_257_bins_keeps_all_features_in_one_group():
    # XGBoost's levels 0-1: each row read once, 28 lanes of 32 on features
    p = hist._plan(11_000_000, 28, 1, 257, 2, 132, 1, "fixed")
    assert (p["groups"], p["node_blocks"], p["row_splits"]) == (1, 1, 132)
    assert p["slab_bytes"] == 3 * 257 * 32 * 4


@pytest.mark.parametrize("R", [100, 4099, 200_000, 11_000_000])
@pytest.mark.parametrize("N", [1, 2, 4])
@pytest.mark.parametrize("Bt,bb", [(65, 1), (257, 2), (1025, 2)])
@pytest.mark.parametrize("sms,blocks_per_sm,K", [(132, 1, 1), (132, 1, 3),
                                                 (8, 1, 1)])
def test_no_int32_entry_can_overflow(R, N, Bt, bb, sms, blocks_per_sm, K):
    """Rows a block adds between two flushes x the largest |q| (2^qbits)
    stays below 2^31 at every planned shape, and the flushes keep at least
    the bits the level's precision rule asks (15 to 22); a block walks its
    tiles in as few flushes as that allows."""
    p = hist._plan(R, 28, N, Bt, bb, sms, blocks_per_sm, "fixed", K)
    per_block = -(-p["tiles"] // p["row_splits"]) * p["tile_rows"]
    need = hist.fixed_needed_qbits(R, N, Bt)
    assert p["flush_rows"] == p["flush_tiles"] * p["tile_rows"]
    assert p["flush_rows"] << p["qbits"] <= 2 ** 31 - 1
    assert 15 <= need <= p["qbits"] <= 22
    assert p["flush_rows"] == min(per_block,
                                  ((2 ** 31 - 1) >> need) // 256 * 256)
    assert p["qbits"] == hist.fixed_qbits(p["flush_rows"])


@pytest.mark.parametrize("R,N,Bt,bb,qbits", [
    # the last fixed level of each bin count at 11M rows: 15 bits
    (11_000_000, 32, 65, 1, 15), (11_000_000, 16, 129, 2, 15),
    (11_000_000, 8, 257, 2, 15), (11_000_000, 2, 1025, 2, 15),
    (11_000_000, 1, 257, 2, 15),
    # the same levels at 1.5M rows, a few hundred rows an entry: 17
    (1_500_000, 32, 65, 1, 17), (1_500_000, 16, 129, 2, 17),
    (1_500_000, 8, 257, 2, 17), (1_500_000, 2, 1025, 2, 17),
    # phase 3's XGBoost at 4.5M rows, levels 0-3 at 15 bits, level 4 at 16
    (4_500_000, 1, 257, 2, 15), (4_500_000, 4, 257, 2, 15),
    (4_500_000, 8, 257, 2, 16),
])
def test_plan_keeps_the_precision_rule(R, N, Bt, bb, qbits):
    """2 x qbits + log2(R / (2 N Bt)) >= 41: the plan flushes more often
    where an entry holds fewer rows, and no more often than that."""
    p = hist._plan(R, 28, N, Bt, bb, 132, 1)
    assert p["kernel"] == "fixed" and p["qbits"] == qbits
    assert 2 * qbits + math.log2(R / (2 * N * Bt)) >= 41
    assert p["qbits"] == 15 or \
        2 * (qbits - 1) + math.log2(R / (2 * N * Bt)) < 41


def test_the_planned_qbits_meet_the_check_where_15_bits_do_not():
    """At a level whose entries hold about 50 rows (200k rows, 32 nodes of
    65 bins, half the rows active), 15 bits a value miss the kernels'
    check (rtol 1e-5 + 1e-5 x max|hist| against float64 sums); the plan's
    qbits (18) meet it."""
    rng = np.random.default_rng(8)
    R, N, Bt = 200_000, 32, 65
    binned_T = torch.from_numpy(rng.integers(0, Bt, size=(4, R))
                                .astype(np.int8))
    child = rng.integers(0, 2 * N, size=R)
    node = torch.from_numpy(np.where(child % 2 == 0, child // 2, -1)
                            .astype(np.int32))
    g = torch.from_numpy(rng.normal(size=R).astype(np.float32))
    h = torch.from_numpy((rng.random(R) + 0.1).astype(np.float32))
    w = torch.ones(R)
    args = (binned_T, node, g, h, w)
    exact = _exact(args, N, Bt)

    def within(got):
        tol = 1e-5 * exact.abs().max() + 1e-5 * exact.abs()
        return bool(((got.double() - exact).abs() <= tol).all())

    qbits = hist._plan(R, 28, N, Bt, 1, 132, 1)["qbits"]
    assert qbits == 18
    assert within(hist.level_histograms_fixed_plain(*args, N, Bt, qbits))
    assert not within(hist.level_histograms_fixed_plain(*args, N, Bt, 15))


def test_qbits_is_the_most_that_cannot_overflow():
    for rows in (1, 256, 511, 512, 41_728, 65_280):
        q = hist.fixed_qbits(rows)
        assert rows << q <= 2 ** 31 - 1
        assert q == 22 or rows << (q + 1) > 2 ** 31 - 1


@pytest.mark.parametrize("R,F,Bt,N", SHAPES)
@pytest.mark.parametrize("qbits", [15, 22])
def test_scale_rule_is_within_the_stated_bound_of_float64_sums(R, F, Bt, N,
                                                               qbits):
    args = _data(1, R, F, Bt, N)
    exact = _exact(args, N, Bt)
    got = hist.level_histograms_fixed_plain(*args, N, Bt, qbits)
    assert got.dtype == torch.float32
    assert bool(((got.double() - exact).abs()
                 <= _bound(args, N, Bt, qbits, exact)).all())


@pytest.mark.parametrize("w_per_class", [False, True])
def test_scale_rule_of_a_class_batch_is_one_scale_for_all_classes(
        w_per_class):
    binned_T, node, g, h, w = _data(2, 3000, 5, 257, 2, K=3)
    if w_per_class:
        w = torch.rand(3, 3000, generator=torch.Generator().manual_seed(0))
    args = (binned_T, node, g, h, w)
    exact = _exact(args, 2, 257)
    got = hist.level_histograms_fixed_plain(*args, 2, 257, 15)
    assert got.shape == (3, 5, 2 * 257, 3)
    assert bool(((got.double() - exact).abs()
                 <= _bound(args, 2, 257, 15, exact)).all())
    # the batch's exponent comes from the active values of all classes
    # together: the bulk bound 2^E lies at most at twice the largest, and
    # at most 64 of them lie at or above it
    exps, _ = hist.fixed_exponents(node, g, h, w, 2, 15)
    act = g[node >= 0].abs()
    E = 15 - exps[0]
    assert E <= math.frexp(float(act.max()))[1]
    assert int((act >= 2.0 ** E).sum()) <= 64 < int((act >= 2.0 ** (E - 1))
                                                    .sum())


def test_every_row_in_one_bin_at_the_largest_value_is_exact_in_int32():
    """The overflow bound's edge: every row in bin 0 of node 0 with g just
    below 2^0, so each value is quantised to 2^qbits and a block's int32
    entry reaches flush_rows x 2^qbits; the sum is exact in int64 and
    within the bound of the float64 sum."""
    R = 65_280
    qbits = hist.fixed_qbits(R)
    x = float(np.nextafter(np.float32(1), np.float32(0)))
    binned_T = torch.zeros((2, R), dtype=torch.int16)
    node = torch.zeros(R, dtype=torch.int32)
    g = torch.full((R,), x)
    ones = torch.ones(R)
    args = (binned_T, node, g, ones, ones)
    exps, _ = hist.fixed_exponents(node, g, ones, ones, 1, qbits)
    assert round(x * 2.0 ** exps[0]) == 2 ** qbits
    assert R * 2 ** qbits <= 2 ** 31 - 1
    got = hist.level_histograms_fixed_plain(*args, 1, 257, qbits)
    assert float(got[0, 0, 0]) == R   # R x 2^qbits x 2^-qbits
    exact = _exact(args, 1, 257)
    assert bool(((got.double() - exact).abs()
                 <= _bound(args, 1, 257, qbits, exact)).all())


def test_wide_weights_stay_within_the_bound():
    args = _data(3, 20_000, 4, 257, 1, w_scale=1e3)
    exact = _exact(args, 1, 257)
    got = hist.level_histograms_fixed_plain(*args, 1, 257, 15)
    assert bool(((got.double() - exact).abs()
                 <= _bound(args, 1, 257, 15, exact)).all())


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("stat", [0, 1, 2])
def test_a_non_finite_active_value_makes_its_stat_nan(bad, stat):
    """As the plain version gives a non-finite sum in the row's bins, the
    fixed rule gives NaN in the whole stat and never a finite result; the
    other stats keep their sums, and an inactive row's value is ignored."""
    binned_T, node, g, h, w = _data(4, 1000, 3, 17, 2)
    stats = [g, h, w.clone()]
    act = int((node >= 0).nonzero()[0])
    stats[stat][act] = bad
    got = hist.level_histograms_fixed_plain(binned_T, node, *stats, 2, 17,
                                            22)
    plain = hist.level_histograms_plain(binned_T, node, *stats, 2, 17)
    assert bool(torch.isnan(got[..., stat]).all())
    assert not bool(torch.isfinite(plain[..., stat]).all())
    others = [s for s in range(3) if s != stat]
    assert bool(torch.isfinite(got[..., others]).all())
    idle = int((node < 0).nonzero()[0])
    stats = [g.clone(), h.clone(), w.clone()]
    stats[stat][act] = 0.5
    stats[stat][idle] = bad
    assert bool(torch.isfinite(hist.level_histograms_fixed_plain(
        binned_T, node, *stats, 2, 17, 22)).all())


def test_sums_do_not_depend_on_the_order_of_the_rows():
    """Integer sums: any order of the rows gives the same bits (the
    kernel's two launches on the card are held to the same)."""
    binned_T, node, g, h, w = _data(5, 5000, 4, 65, 4)
    perm = torch.from_numpy(np.random.default_rng(6).permutation(5000))
    a = hist.level_histograms_fixed_plain(binned_T, node, g, h, w, 4, 65, 15)
    b = hist.level_histograms_fixed_plain(
        binned_T[:, perm].contiguous(), node[perm], g[perm], h[perm],
        w[perm], 4, 65, 15)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("R,F,Bt,N", SHAPES)
def test_scale_rule_matches_the_reference_segment_sum(R, F, Bt, N):
    binned_T, node, g, h, w = _data(7, R, F, Bt, N)
    want = np.asarray(_level_histograms(
        jnp.asarray(binned_T.T.numpy()), jnp.asarray(node.numpy()),
        jnp.asarray(g.numpy()), jnp.asarray(h.numpy()),
        jnp.asarray(w.numpy()), N, Bt))
    got = hist.level_histograms_fixed_plain(binned_T, node, g, h, w, N, Bt,
                                            22).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# -- skewed stats: a few outliers must not coarsen every row's step -------


def _skewed(R, case, F=28):
    """28 normal features from default_rng(11) in 64 quantile bins (int8,
    65 with the NA bin) and the stats of a case: (a) g normal with 5 rows
    at 1e4, h = w = 1; (b) g, h of a bernoulli logit of the first four
    features, weights uniform in [0.05, 1] with 5 rows at 1e3; (c) (a)
    without the outliers. Returns the bins, g, h, w and the generator."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((F, R), dtype=np.float32)   # feature-major
    edges = torch.from_numpy(np.quantile(X[:, :20_000], np.linspace(
        0, 1, 65)[1:-1], axis=1).T.astype(np.float32).copy())
    binned_T = torch.stack([torch.bucketize(torch.from_numpy(X[f]),
                                            edges[f], right=True)
                            for f in range(F)]).to(torch.int8)
    out = rng.choice(R, 5, replace=False)
    if case in "ac":
        g = rng.normal(size=R).astype(np.float32)
        if case == "a":
            g[out] = 1e4
        h = w = np.ones(R, np.float32)
    else:
        logit = np.array([1.2, -0.8, 0.5, 0.3], np.float32) @ X[:4]
        p = 1 / (1 + np.exp(-logit))
        y = (rng.random(R) < p).astype(np.float32)
        w = rng.uniform(0.05, 1, R).astype(np.float32)
        w[out] = 1e3
        g = (w * (p - y)).astype(np.float32)
        h = (w * p * (1 - p)).astype(np.float32)
    t = torch.from_numpy
    return binned_T, t(g), t(h), t(w), rng


def _layout(R, N, rng):
    """Node ids of a level of N histogrammed nodes: every row at node 0
    for N = 1; else rows spread over 2N children, those of the even child
    active at node child // 2 (the odd one comes by subtraction)."""
    if N == 1:
        return torch.zeros(R, dtype=torch.int32)
    child = torch.from_numpy(rng.integers(0, 2 * N, R))
    return torch.where(child % 2 == 0, child // 2, -1).to(torch.int32)


def _exact_fast(binned_T, node, g, h, w, N, Bt):
    """Float64 sums [F, N*Bt, 3] by bincount (the yardstick of
    ``_exact``, faster at millions of rows)."""
    act = node >= 0
    base = torch.where(act, node.long() * Bt, 0)
    stats = [torch.where(act, v.double(), 0.0) for v in (g, h, w)]
    return torch.stack([torch.stack(
        [torch.bincount(base + binned_T[f].long(), weights=s,
                        minlength=N * Bt) for s in stats], -1)
        for f in range(binned_T.shape[0])])


def _within_check(got, exact):
    """The kernels' check (chip_smoke.py:check_hist): rtol 1e-5 plus 1e-5 x
    max|hist| against float64 sums."""
    tol = 1e-5 * exact.abs().max() + 1e-5 * exact.abs()
    return bool(((got.double() - exact).abs() <= tol).all())


@pytest.mark.parametrize("R", [200_000, 2_000_000])
@pytest.mark.parametrize("case", ["a", "b", "c"])
def test_skewed_stats_stay_within_the_check(R, case):
    """Five outlier rows (g = 1e4, or weights of 1e3) among R: at 1, 8 and
    32 nodes of 65 int8 bins, at the plan's qbits, the fixed rule's sums
    are within the check of float64 sums. A single scale from max|x|
    missed it by up to 60-fold here; the bulk scale with the outliers
    added apart meets it, as the control (c) without outliers does."""
    binned_T, g, h, w, rng = _skewed(R, case)
    for N in (1, 8, 32):
        node = _layout(R, N, rng)
        qbits = hist._plan(R, 28, N, 65, 1, 132, 1)["qbits"]
        got = hist.level_histograms_fixed_plain(binned_T, node, g, h, w, N,
                                                65, qbits)
        exact = _exact_fast(binned_T, node, g, h, w, N, 65)
        assert _within_check(got, exact), (case, N, qbits)
        if case != "c":
            # the outliers are out of the bulk: its bound is far below them
            exps, _ = hist.fixed_exponents(node, g, h, w, N, qbits)
            s = 0 if case == "a" else 2
            assert qbits - exps[s] <= 3


def test_outliers_beyond_the_cap_leave_the_single_scale():
    """Where more than 64 values lie far above the rest, the bulk bucket is
    the top one again: the single scale of max|x|."""
    g = torch.from_numpy(np.random.default_rng(3).normal(size=5000)
                         .astype(np.float32))
    node = torch.zeros(5000, dtype=torch.int32)
    ones = torch.ones(5000)
    for n_out, top in ((64, False), (65, True)):
        gg = g.clone()
        gg[:n_out] = 1e4
        exps, _ = hist.fixed_exponents(node, gg, ones, ones, 1, 15)
        assert (15 - exps[0] == math.frexp(1e4)[1]) == top


def test_the_bulk_bound_is_clamped_so_no_int64_entry_can_overflow():
    """At most 2^56 a quantised outlier: the bulk lies at most 56 - qbits
    exponents below the top (64 outliers x 2^56 = 2^62)."""
    g = torch.full((1000,), 1e-6)
    g[:3] = 1e30
    node = torch.zeros(1000, dtype=torch.int32)
    ones = torch.ones(1000)
    for qbits in (15, 22):
        exps, _ = hist.fixed_exponents(node, g, ones, ones, 1, qbits)
        q = torch.round(g.double() * 2.0 ** exps[0]).abs().max()
        assert 2 ** 55 <= float(q) <= 2 ** 56


def test_node_totals_emulation_is_within_the_check_of_float64_sums():
    """The node-totals instance (F = 1, Bt = 1, 19 bits) against float64
    sums, for K = 3 class trees with shared and per-class weights and with
    the skewed stats of case (a)."""
    rng = np.random.default_rng(21)
    R, N = 50_000, 64
    node = torch.from_numpy(rng.integers(-1, N, size=(3, R)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(3, R)).astype(np.float32))
    g[1, :5] = 1e4
    h = torch.from_numpy((rng.random((3, R)) + 0.1).astype(np.float32))
    for w in (torch.ones(R),
              torch.from_numpy(rng.uniform(0.05, 1, (3, R))
                               .astype(np.float32))):
        got = hist.node_totals_fixed_plain(node, g, h, w, N)
        exact = hist.node_totals_plain(node, g.double(), h.double(),
                                       w.double(), N)
        assert got.shape == (3, N, 3)
        assert _within_check(got, exact)
        # the CPU path is the plain float version
        plain = hist.node_totals(node, g, h, w, N)
        assert _within_check(plain, exact)
