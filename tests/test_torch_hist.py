"""The port's level histograms (h2o3_tpu_torch/ops/hist.py) against the JAX
reference: the XLA segment-sum path ``models/tree.py:_level_histograms`` and
the Pallas kernel ``ops/pallas_hist.py:hist_pallas`` run in interpret mode,
as tests/test_pallas_interpret.py runs it off the TPU.

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x max|hist|. Every path
sums the same float32 terms exactly (the "hilo3" Pallas mode is f32-exact),
only in another order; sums of g near zero need the floor.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.models.tree import _level_histograms
from h2o3_tpu.ops import pallas_hist
from h2o3_tpu_torch.ops import hist

#: the shapes of tests/test_pallas_interpret.py: (rows, features, bins, nodes)
SHAPES = [(4096, 7, 16, 8), (2048, 3, 256, 128)]
#: SHAPES and a level of 4096 nodes (DRF's deepest at depth 14), which the
#: reference's Pallas path sends to its scatter fallback
PLAIN_SHAPES = SHAPES + [(20_000, 3, 64, 4096)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernel itself; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _data(seed, R, F, B, N, dtype=np.int16, hi=None):
    """Bins in [0, B] (B = the NA bin) or [0, hi), nodes in [-1, N): rows at
    node -1 must add nothing."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B + 1 if hi is None else hi,
                          size=(R, F)).astype(dtype)
    node = rng.integers(-1, N, size=R).astype(np.int32)
    g = rng.normal(size=R).astype(np.float32)
    h = (rng.random(R) + 0.1).astype(np.float32)
    w = np.ones(R, np.float32)
    return binned, node, g, h, w


def _batch(seed, R, F, B, N, K=3, w_per_class=False, dtype=np.int16):
    """A class batch on :func:`_data`'s bins: node [K, R] in [-1, N), g and
    h [K, R], w [K, R] in [0.5, 1.5) or one shared [R] row of ones."""
    binned = _data(seed, R, F, B, N, dtype=dtype)[0]
    rng = np.random.default_rng(seed + 100)
    node = rng.integers(-1, N, size=(K, R)).astype(np.int32)
    g = rng.normal(size=(K, R)).astype(np.float32)
    h = (rng.random((K, R)) + 0.1).astype(np.float32)
    w = ((rng.random((K, R)) + 0.5).astype(np.float32) if w_per_class
         else np.ones(R, np.float32))
    return binned, node, g, h, w


def _vmapped(fn, binned_arg, node, g, h, w, N, Bt):
    """A reference histogram function under jax.vmap over the class axis
    (w batched or shared), as ``_grow_batched`` runs it."""
    return np.asarray(jax.vmap(
        lambda nd, gg, hh, ww: fn(jnp.asarray(binned_arg), nd, gg, hh, ww, N,
                                  Bt),
        in_axes=(0, 0, 0, 0 if w.ndim == 2 else None))(
            jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(w)))


def _port(fn, binned, node, g, h, w, N, Bt, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device)
    out = fn(t(np.ascontiguousarray(binned.T)), t(node), t(g), t(h), t(w),
             N, Bt)
    return out.cpu().numpy()


def _plan(R, F, N, Bt, bin_bytes=1, kernel=None, K=1):
    """The launch plan on the H100's 132 SMs at one block per SM (on the
    card, CUDA's occupancy query gives the blocks per SM)."""
    return hist._plan(R, F, N, Bt, bin_bytes, 132, 1, kernel, K)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("R,F,B,N", PLAIN_SHAPES)
def test_plain_matches_reference_segment_sum(R, F, B, N):
    data = _data(0, R, F, B, N)
    want = np.asarray(_level_histograms(*map(jnp.asarray, data), N, B + 1))
    _close(_port(hist.level_histograms_plain, *data, N, B + 1), want)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The Pallas kernel in interpret mode, f32-exact ("hilo3")."""
    monkeypatch.setattr(pallas_hist, "_INTERPRET", True)
    monkeypatch.setattr(pallas_hist, "_MXU_MODE", "hilo3")
    pallas_hist.hist_pallas._clear_cache()
    yield
    pallas_hist.hist_pallas._clear_cache()


@pytest.mark.parametrize("R,F,B,N", SHAPES)
def test_plain_matches_pallas_kernel_interpret(pallas_interpret, R, F, B, N):
    binned, node, g, h, w = _data(1, R, F, B, N)
    want = np.asarray(pallas_hist.hist_pallas(
        jnp.asarray(binned.T), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(w), N, B + 1))
    _close(_port(hist.level_histograms_plain, binned, node, g, h, w, N, B + 1),
           want)


@pytest.mark.parametrize("w_per_class", [False, True])
@pytest.mark.parametrize("R,F,B,N", SHAPES)
def test_batched_plain_matches_reference_vmap_segment_sum(R, F, B, N,
                                                          w_per_class):
    data = _batch(10, R, F, B, N, w_per_class=w_per_class)
    want = _vmapped(_level_histograms, data[0], *data[1:], N, B + 1)
    got = _port(hist.level_histograms_plain, *data, N, B + 1)
    assert got.shape == (3, F, N * (B + 1), 3)
    _close(got, want)


@pytest.mark.parametrize("w_per_class", [False, True])
@pytest.mark.parametrize("R,F,B,N", SHAPES)
def test_batched_plain_matches_vmapped_pallas_kernel_interpret(
        pallas_interpret, R, F, B, N, w_per_class):
    data = _batch(11, R, F, B, N, w_per_class=w_per_class)
    want = _vmapped(pallas_hist.hist_pallas, np.ascontiguousarray(data[0].T),
                    *data[1:], N, B + 1)
    _close(_port(hist.level_histograms_plain, *data, N, B + 1), want)


@pytest.mark.parametrize("w_per_class", [False, True])
def test_one_class_batch_equals_the_2d_call_exactly(w_per_class):
    binned, node, g, h, w = _data(12, 3000, 5, 16, 4)
    bw = w[None] if w_per_class else w
    one = _port(hist.level_histograms_plain, binned, node[None], g[None],
                h[None], bw, 4, 17)
    assert one.shape == (1, 5, 4 * 17, 3)
    np.testing.assert_array_equal(
        one[0], _port(hist.level_histograms_plain, binned, node, g, h, w, 4,
                      17))


def test_batched_wrapper_on_cpu_launches_nothing():
    data = _batch(13, 2048, 3, 16, 8)
    before = hist.launch_count()
    np.testing.assert_array_equal(
        _port(hist.level_histograms, *data, 8, 17),
        _port(hist.level_histograms_plain, *data, 8, 17))
    assert hist.launch_count() == before


def test_out_of_range_bins_clamp_like_the_reference():
    """Bin ids >= Bt land in bin Bt-1, as _level_histograms clamps them."""
    R, F, B, N = 3000, 4, 16, 4
    data = _data(2, R, F, B, N, hi=B + 5)
    want = np.asarray(_level_histograms(*map(jnp.asarray, data), N, B + 1))
    _close(_port(hist.level_histograms_plain, *data, N, B + 1), want)


def test_int8_bins_equal_int16_bins():
    R, F, B, N = 2500, 5, 64, 4
    data = _data(3, R, F, B, N)
    b16 = _port(hist.level_histograms_plain, *data, N, B + 1)
    b8 = _port(hist.level_histograms_plain, data[0].astype(np.int8),
               *data[1:], N, B + 1)
    np.testing.assert_array_equal(b8, b16)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    data = _data(4, 2048, 3, 16, 8)
    before = hist.launch_count()
    got = _port(hist.level_histograms, *data, 8, 17)
    np.testing.assert_array_equal(
        got, _port(hist.level_histograms_plain, *data, 8, 17))
    assert hist.launch_count() == before


@pytest.mark.parametrize("bad,exc", [
    (lambda b, n, s: (b.to(torch.int32), n, s), TypeError),
    (lambda b, n, s: (b, n.long(), s), TypeError),
    (lambda b, n, s: (b, n, s.double()), TypeError),
    (lambda b, n, s: (b.T.contiguous().T, n, s), ValueError),
    (lambda b, n, s: (b, n[:-1], s), TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    binned, node, g, _, _ = _data(5, 64, 3, 16, 2)
    b, n, s = bad(torch.from_numpy(np.ascontiguousarray(binned.T)),
                  torch.from_numpy(node), torch.from_numpy(g))
    with pytest.raises(exc):
        hist.level_histograms(b, n, s, s, s, 2, 17)


@pytest.mark.parametrize("R,F,N,Bt", [
    (4096, 7, 8, 17), (2048, 3, 128, 257), (1 << 20, 4, 1 << 14, 65),
    (11_000_000, 28, 1, 65), (11_000_000, 28, 16, 65),
    (100_000, 28, 1 << 14, 257),
    (11_000_000, 28, 2, 65), (11_000_000, 28, 8, 65), (200_000, 28, 16, 65),
    (4099, 5, 1, 65),
])
def test_launch_plan_covers_rows_nodes_and_shared_memory(R, F, N, Bt):
    """Every depth up to 16 (2^14 nodes) and 257 bins plan within the grid
    and shared-memory limits: feature groups cover every feature once, node
    blocks every node, row tiles every row, and the slab fits the
    budget."""
    p = _plan(R, F, N, Bt)
    fb, nb = p["features_per_group"], p["nodes_per_block"]
    # each feature in exactly one group, each node in exactly one block
    assert p["groups"] * fb >= F and (p["groups"] - 1) * fb < F
    assert p["node_blocks"] * nb >= N and (p["node_blocks"] - 1) * nb < N
    assert p["tiles"] * p["tile_rows"] >= R
    assert (p["tiles"] - 1) * p["tile_rows"] < R
    assert 1 <= p["row_splits"] <= p["tiles"]   # no split without a tile
    if p["kernel"] == "global":
        # every node in one block's reach; the feature groups are passes
        # of about one L2 budget of v4 entries each
        assert p["node_blocks"] == 1 and fb <= 32 and p["slab_bytes"] == 0
        assert (fb - 1) * N * Bt * 16 <= hist._GLOBAL_L2_BYTES or fb == 1
        assert p["smem_bytes"] == hist._global_smem_bytes(fb, 1)
        assert p["tile_rows"] == 1024 and p["warps"] == 8
    else:
        # the fixed kernel: a slab [3, Nb, Bt, P] int32 (P = the group's
        # features rounded up to a power of two) beside two staged 256-row
        # tiles, no int32 entry can overflow between two flushes, and the
        # values keep the bits the level's precision rule asks
        P = hist._fixed_stride(fb)
        assert p["kernel"] == "fixed" and fb <= 32 and P >= fb
        assert p["slab_bytes"] == nb * Bt * 12 * P
        assert p["smem_bytes"] == hist._fixed_smem_bytes(fb, nb, Bt, 1)
        assert p["smem_bytes"] <= hist._FIXED_SMEM_BUDGET
        assert p["tile_rows"] == 256 and p["warps"] == 16
        assert p["flush_rows"] << p["qbits"] <= 2 ** 31 - 1
        assert p["qbits"] >= hist.fixed_needed_qbits(R, N, Bt)
    assert p["smem_bytes"] <= hist._SMEM_MAX
    # the global kernel's blocks walk its feature groups in time
    groups = 1 if p["kernel"] == "global" else p["groups"]
    assert p["blocks"] == groups * p["node_blocks"] * p["row_splits"]
    assert p["blocks"] <= hist._GRID_X_MAX


@pytest.mark.parametrize("N,groups,nodes_per_block", [
    (1, 1, 1), (2, 1, 2), (4, 1, 4), (8, 1, 8), (16, 2, 16),
])
def test_launch_plan_of_the_main_path_levels(N, groups, nodes_per_block):
    """At 11M x 28 int8 rows and 65 bins every level runs the fixed kernel
    (measured the faster there): all 28 features in one group and every
    node in one block up to 8 nodes, two groups of 14 at 16 nodes (the
    slab of a narrower group holds more nodes), one block per SM of the
    H100's 132, each flushing every 255 tiles at 15 bits a value."""
    p = _plan(11_000_000, 28, N, 65)
    assert p["kernel"] == "fixed"
    assert (p["groups"], p["nodes_per_block"], p["node_blocks"]) == \
        (groups, nodes_per_block, 1)
    assert p["blocks"] == 132
    assert (p["flush_tiles"], p["qbits"]) == (255, 15)


@pytest.mark.parametrize("R,F,N,Bt", [
    (1 << 20, 4, 1, 600), (2048, 3, 1, 1000),
])
def test_launch_plan_degrades_to_the_atomic_kernel(R, F, N, Bt):
    """At 600 and 1000 bins, below the global kernel's switch, the plan
    takes the kernel that replaced the atomic one there, the fixed kernel,
    with a slab that fits a block's shared memory."""
    p = _plan(R, F, N, Bt, 2)
    assert p["kernel"] == "fixed"
    assert p["smem_bytes"] <= hist._FIXED_SMEM_BUDGET


@pytest.mark.parametrize("N,Bt,kernel", [
    (16, 65, "fixed"), (32, 65, "fixed"), (512, 65, "global"),
    (1024, 65, "global"), (1 << 14, 65, "global"), (4, 129, "fixed"),
    (8, 129, "fixed"), (1, 257, "fixed"), (2, 257, "fixed"),
    (4, 257, "fixed"), (16, 257, "global"), (1, 17, "fixed"),
    (64, 17, "global"),
])
def test_launch_plan_takes_the_kernel_measured_faster(N, Bt, kernel):
    """The switch between the kernels where bench/hist_crossover.py found
    it on the H100 at 11M rows x 28 features (``_KERNEL_SWITCH``): the
    fixed kernel below 64 nodes at 65 bins, below 32 at 129, below 16 at
    257 and below 4 at 1025; the global kernel from there on. Fewer bins
    follow 65's entry."""
    assert _plan(11_000_000, 28, N, Bt, 1 if Bt < 128 else 2)["kernel"] == \
        kernel


def test_kernel_switch_is_one_table_by_bins():
    # the entries bench/hist_crossover.py measured: 65, 129, 257 and 1025
    # bins, each (kernel, below this node count)
    assert hist._KERNEL_SWITCH == {65: ("fixed", 64), 129: ("fixed", 32),
                                   257: ("fixed", 16), 1025: ("fixed", 4)}


@pytest.mark.parametrize("N,Bt,kernel", [
    (4, 100, "fixed"), (32, 100, "global"), (2, 200, "fixed"),
    (16, 200, "global"), (1, 600, "fixed"), (2, 1000, "fixed"),
    (4, 600, "global"), (16, 2, "fixed"),
])
def test_unmeasured_bins_take_the_next_measured_entry(N, Bt, kernel):
    """A bin count between the measured ones takes the entry of the least
    measured count at or above it, one beyond them the largest entry."""
    assert hist._kernel_plan(28, N, Bt, 1 if Bt < 128 else 2)["kernel"] == \
        kernel


def test_lane_entries_hold_a_lane_plan_below_their_switch():
    """Wherever the table takes a kernel below its node count (the fixed
    kernel at every entry), that kernel holds the level within a block's
    shared memory."""
    prev = 1
    for top, (kernel, below) in sorted(hist._KERNEL_SWITCH.items()):
        for Bt in sorted({prev, (prev + top) // 2, top}):
            for N in range(1, below):
                p = hist._kernel_plan(28, N, Bt, 2, kernel)
                assert p["kernel"] == kernel
                assert p["smem_bytes"] <= hist._FIXED_SMEM_BUDGET
        prev = top + 1


@pytest.mark.parametrize("Bt,bb,K,kernels", [
    # DRF at depth 14 (65 bins): levels 0-13
    (65, 1, 1, ["fixed"] * 7 + ["global"] * 7),
    # XGBoost at depth 6 (257 int16 bins) and multinomial GBM (K = 3)
    (257, 2, 1, ["fixed"] * 5 + ["global"]),
    (65, 1, 3, ["fixed"] * 6),
])
def test_launch_plan_of_each_level_of_the_paths(Bt, bb, K, kernels):
    """The kernel each level takes on the measured switch: level 0 and 1
    histogram one node, level d >= 1 the smaller children of 2^(d-1)
    parents. The binomial main path (depth 6) takes the DRF's first six."""
    nodes = [max(1, 2 ** (d - 1)) for d in range(len(kernels))]
    assert [_plan(11_000_000, 28, N, Bt, bb, K=K)["kernel"]
            for N in nodes] == kernels


@pytest.mark.parametrize("R,F,N,Bt,bb,K,passes", [
    (11_000_000, 28, 1024, 65, 1, 1, 4),    # DRF level 11: 4 passes of 7
    (11_000_000, 28, 4096, 65, 1, 1, 14),   # DRF level 13: 14 of 2
    (11_000_000, 28, 1024, 65, 1, 3, 10),   # three classes: 3x the entries
    (11_000_000, 28, 32, 65, 1, 1, 1),
    (1_000_000, 28, 1 << 14, 65, 1, 1, 28),
    (11_000_000, 28, 64, 257, 2, 1, 1),
    (4099, 5, 1024, 65, 1, 3, 2),
    (11_000_000, 100, 8, 65, 1, 1, 4),      # at most 32 features a pass
])
def test_global_plan_walks_features_in_passes_within_l2(R, F, N, Bt, bb, K,
                                                        passes):
    """The global kernel (forced, as phase 2 of chip_smoke.py forces it)
    splits the v4 entries of all K classes into as many parts of the L2
    budget as they fill (at least one per 32 features, at most one per
    feature) and spreads the features evenly over them, so that each pass
    of every block over its rows keeps about one budget of entries in use;
    every node is in one block's reach and no feature group is spread over
    blocks: the persistent grid is rows x classes."""
    p = _plan(R, F, N, Bt, bb, "global", K)
    fb = p["features_per_group"]
    parts = min(F, max(-(-F // 32),
                       -(-K * F * N * Bt * 16 // hist._GLOBAL_L2_BYTES)))
    assert p["kernel"] == "global" and p["groups"] == passes
    assert fb == -(-F // parts) and passes == -(-F // fb)
    assert p["smem_bytes"] == 16 * 1024 + 32 + fb * 1024 * bb
    assert p["node_blocks"] == 1 and p["nodes_per_block"] == N
    assert p["blocks"] == p["row_splits"] * K <= 132


def test_global_plan_refuses_more_nodes_than_an_entry_packs():
    with pytest.raises(ValueError):
        _plan(1000, 3, 2 ** 22, 65, 1, "global")


def test_plan_refuses_a_kernel_it_does_not_have():
    with pytest.raises(ValueError):
        _plan(1000, 3, 4, 65, 1, "lanes")


@pytest.mark.parametrize("kernel,N,Bt,node_blocks,groups", [
    ("fixed", 16, 65, 1, 2), ("fixed", 1 << 14, 65, 58, 28),
    ("fixed", 128, 257, 4, 14), ("global", 1, 65, 1, 1),
    ("global", 1 << 14, 65, 1, 28),
])
def test_launch_plan_takes_the_kernel_it_is_given(kernel, N, Bt, node_blocks,
                                                  groups):
    """A forced kernel (the crossover bench times each) gets its own plan
    at any shape it can hold."""
    p = _plan(1_000_000, 28, N, Bt, 2 if Bt > 126 else 1, kernel)
    assert p["kernel"] == kernel
    assert (p["node_blocks"], p["groups"]) == (node_blocks, groups)


@pytest.mark.parametrize("R,F,N,Bt,bb,K", [
    (11_000_000, 28, 1, 65, 1, 3), (11_000_000, 28, 16, 65, 1, 3),
    (11_000_000, 28, 1, 257, 2, 1), (11_000_000, 28, 16, 257, 2, 1),
    (11_000_000, 28, 1024, 65, 1, 1), (11_000_000, 28, 4096, 65, 1, 1),
    (100_000, 28, 8, 65, 1, 10),
])
def test_launch_plan_of_class_batches_and_the_new_paths(R, F, N, Bt, bb, K):
    """A batch of K classes keeps the kernel and block shape of one class
    (each class has its own slab) and splits the persistent grid over the
    classes: at most one block per SM of the H100's 132 in all. DRF's deep
    levels and the XGBoost levels (257 int16 bins) of 16 nodes or more run
    the global kernel, XGBoost's levels of fewer nodes the fixed kernel."""
    one = _plan(R, F, N, Bt, bb)
    p = hist._plan(R, F, N, Bt, bb, 132, 1, None, K)
    for key in ("kernel", "features_per_group", "nodes_per_block",
                "smem_bytes", "tiles"):
        assert p[key] == one[key], key
    assert p["classes"] == K
    groups = 1 if p["kernel"] == "global" else p["groups"]
    assert p["blocks"] == groups * p["node_blocks"] * p["row_splits"] * K
    assert p["blocks"] <= max(132, groups * p["node_blocks"] * K)
    if N >= 1024 or (Bt == 257 and N >= 16):
        assert p["kernel"] == "global"
    elif Bt == 257:
        assert p["kernel"] == "fixed"


def test_bound_counts_the_bins_once_for_a_class_batch():
    # the multinomial level at K = 3: bins once, node/g/h per class, one w
    assert hist.hist_bytes(11_000_000, 28, 1, 65, 1, K=3) == \
        11_000_000 * (28 + 3 * 12 + 4) + 3 * 28 * 65 * 3 * 4
    assert hist.hist_bytes(10, 2, 1, 5, 2, K=3, w_per_class=True) == \
        10 * (4 + 3 * 16) + 3 * 2 * 5 * 12


def test_launch_plan_refuses_a_slab_beyond_shared_memory():
    with pytest.raises(ValueError):
        _plan(1000, 1, 1, 20_000)


def test_bound_counts_each_input_once():
    # 11M rows x 28 int8 bins + node + g/h/w, plus the [28, 65, 3] output
    assert hist.hist_bytes(11_000_000, 28, 1, 65, 1) == \
        11_000_000 * (28 + 4 + 12) + 28 * 65 * 3 * 4
    assert hist.hist_flops(1000, 28) == 3 * 1000 * 28


@pytest.mark.parametrize("scan", [True, False])
def test_loads_only_instance_needs_the_card(scan):
    data = _data(7, 64, 3, 16, 2)
    t = lambda a: torch.from_numpy(a)
    with pytest.raises(ValueError):
        hist.level_histograms_loads_only(
            t(np.ascontiguousarray(data[0].T)), *map(t, data[1:]), 2, 17,
            scan=scan)


@pytest.mark.cuda
@pytest.mark.parametrize("R,F,B,N,dtype,node0", [
    (4096, 7, 16, 8, np.int16, False), (2048, 3, 256, 128, np.int16, False),
    (1 << 18, 4, 64, 1 << 14, np.int8, False),
    (4099, 5, 64, 4, np.int8, False),        # rows not a multiple of 4
    (4099, 5, 64, 1, np.int8, True),         # every row in one node
    (1 << 16, 28, 64, 16, np.int8, False),   # four feature groups
    (2048, 3, 256, 128, np.int16, True),
    # the global kernel: 1024 nodes, 257 bins at 64 nodes, rows not a
    # multiple of 4 (2^14 nodes is the third case above)
    (1 << 16, 28, 64, 1024, np.int8, False),
    (1 << 16, 28, 256, 64, np.int16, False),
    (4099, 5, 64, 64, np.int8, False),
])
def test_kernel_matches_plain_on_card(cuda_device, R, F, B, N, dtype, node0):
    data = _data(6, R, F, B, N, dtype=dtype)
    if node0:
        data[1][:] = 0
    before = hist.launch_count()
    by_kernel = dict(hist.level_histograms.kernel_launches)
    got = _port(hist.level_histograms, *data, N, B + 1, device=cuda_device)
    assert hist.launch_count() == before + 1
    planned = _plan(R, F, N, B + 1, np.dtype(dtype).itemsize)["kernel"]
    assert hist.level_histograms.kernel_launches[planned] == \
        by_kernel[planned] + 1
    _close(got, _port(hist.level_histograms_plain, *data, N, B + 1,
                      device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("R,F,B,N,dtype,w_per_class", [
    (4096, 7, 16, 8, np.int16, False), (4096, 7, 16, 8, np.int16, True),
    (4099, 5, 64, 4, np.int8, True),     # rows not a multiple of 4
    (2048, 3, 256, 1, np.int16, True),    # the fixed kernel
    (1 << 16, 28, 64, 16, np.int8, False),
    # the global kernel
    (2048, 3, 256, 128, np.int16, True), (4099, 5, 64, 1024, np.int8, True),
    (1 << 16, 28, 64, 1024, np.int8, False),
])
def test_batched_kernel_matches_plain_on_card(cuda_device, R, F, B, N, dtype,
                                              w_per_class):
    data = _batch(14, R, F, B, N, w_per_class=w_per_class, dtype=dtype)
    before = hist.launch_count()
    got = _port(hist.level_histograms, *data, N, B + 1, device=cuda_device)
    assert hist.launch_count() == before + 1   # one for all K
    _close(got, _port(hist.level_histograms_plain, *data, N, B + 1,
                      device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("R,F,B,N,K,w_per_class", [
    (4096, 7, 256, 1, None, False), (4096, 7, 256, 2, None, False),
    (4099, 5, 256, 1, None, False),      # rows not a multiple of 4
    (200_000, 28, 1024, 2, None, False),
    (4096, 7, 256, 2, 3, False), (4099, 7, 256, 2, 3, True),
    (1 << 16, 28, 64, 16, None, False),
])
def test_fixed_kernel_matches_plain_and_is_bit_identical_on_card(
        cuda_device, R, F, B, N, K, w_per_class):
    """The fixed kernel forced through the plan: within the tolerance of
    the plain version, bit for bit equal to its plain-PyTorch emulation at
    the plan's qbits, and bit for bit equal across two launches."""
    data = (_data(15, R, F, B, N) if K is None else
            _batch(15, R, F, B, N, K=K, w_per_class=w_per_class))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    binned_T = t(data[0].T)
    args = (binned_T, *map(t, data[1:]))
    p = hist.launch_plan(binned_T, N, B + 1, "fixed", K or 1)
    a = hist._launch(*args, N, B + 1, "fixed")
    b = hist._launch(*args, N, B + 1, "fixed")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    emu = hist.level_histograms_fixed_plain(*args, N, B + 1, p["qbits"])
    assert torch.equal(a.view(torch.int32), emu.view(torch.int32))
    _close(a.cpu().numpy(), hist.level_histograms_plain(
        *args, N, B + 1).cpu().numpy())


# -- uplift DRF's class batch: K = 8 trees, each with its own bootstrap w --

def test_eight_tree_batch_with_per_tree_w_matches_reference_vmap():
    """Uplift DRF grows 8 trees a batch, each on its own bootstrap weights:
    the plain version at K = 8 with w [8, R] against the reference's
    segment sum under jax.vmap."""
    data = _batch(16, 3000, 6, 64, 4, K=8, w_per_class=True, dtype=np.int8)
    want = _vmapped(_level_histograms, data[0], *data[1:], 4, 65)
    got = _port(hist.level_histograms_plain, *data, 4, 65)
    assert got.shape == (8, 6, 4 * 65, 3)
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("R,F,N", [(4099, 12, 1), (1 << 16, 12, 8),
                                   (1 << 16, 12, 16)])
def test_eight_tree_batch_is_bit_identical_on_card(cuda_device, R, F, N):
    """The uplift levels' shape (12 features, 65 int8 bins, K = 8, w per
    tree) on the plan's kernel: two launches bit for bit equal, equal bit
    for bit to the fixed kernel's emulation, within the plain version's
    tolerance."""
    data = _batch(17, R, F, 64, N, K=8, w_per_class=True, dtype=np.int8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    binned_T = t(data[0].T)
    args = (binned_T, *map(t, data[1:]))
    p = hist.launch_plan(binned_T, N, 65, K=8)
    assert p["kernel"] == "fixed"
    before = hist.launch_count()
    a = hist.level_histograms(*args, N, 65)
    b = hist.level_histograms(*args, N, 65)
    assert hist.launch_count() == before + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    emu = hist.level_histograms_fixed_plain(*args, N, 65, p["qbits"])
    assert torch.equal(a.view(torch.int32), emu.view(torch.int32))
    _close(a.cpu().numpy(),
           hist.level_histograms_plain(*args, N, 65).cpu().numpy())


@pytest.mark.cuda
def test_eight_tree_node_totals_are_bit_identical_on_card(cuda_device):
    """The final level of an uplift batch: node totals at K = 8, 32 nodes,
    w per tree."""
    _, node, g, h, w = _batch(18, 1 << 16, 1, 1, 32, K=8, w_per_class=True)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    args = tuple(map(t, (node, g, h, w)))
    before = hist.node_totals.launches
    a = hist.node_totals(*args, 32)
    b = hist.node_totals(*args, 32)
    assert hist.node_totals.launches == before + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.view(torch.int32), hist.node_totals_fixed_plain(
        *args, 32).view(torch.int32))
    _close(a.cpu().numpy(), hist.node_totals_plain(*args, 32).cpu().numpy())
