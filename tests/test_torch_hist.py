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

import jax.numpy as jnp

from h2o3_tpu.models.tree import _level_histograms
from h2o3_tpu.ops import pallas_hist
from h2o3_tpu_torch.ops import hist

#: the shapes of tests/test_pallas_interpret.py: (rows, features, bins, nodes)
SHAPES = [(4096, 7, 16, 8), (2048, 3, 256, 128)]


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


def _port(fn, binned, node, g, h, w, N, Bt, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device)
    out = fn(t(np.ascontiguousarray(binned.T)), t(node), t(g), t(h), t(w),
             N, Bt)
    return out.cpu().numpy()


def _plan(R, F, N, Bt, bin_bytes=1, kernel=None):
    """The launch plan on the H100's 132 SMs at one block per SM (on the
    card, CUDA's occupancy query gives the blocks per SM)."""
    return hist._plan(R, F, N, Bt, bin_bytes, 132, 1, kernel)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("R,F,B,N", SHAPES)
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
    before = hist.level_histograms.launches
    got = _port(hist.level_histograms, *data, 8, 17)
    np.testing.assert_array_equal(
        got, _port(hist.level_histograms_plain, *data, 8, 17))
    assert hist.level_histograms.launches == before


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
    blocks every node, row tiles every row, and slab copies fit the
    budget."""
    p = _plan(R, F, N, Bt)
    fb, nb = p["features_per_group"], p["nodes_per_block"]
    # each feature in exactly one group, each node in exactly one block
    assert p["groups"] * fb >= F and (p["groups"] - 1) * fb < F
    assert p["node_blocks"] * nb >= N and (p["node_blocks"] - 1) * nb < N
    assert p["tiles"] * p["tile_rows"] >= R
    assert (p["tiles"] - 1) * p["tile_rows"] < R
    assert 1 <= p["row_splits"] <= p["tiles"]   # no split without a tile
    if p["kernel"] == "lanes":
        # a lane per feature, a slab of [3, Nb, Bt, 32 lanes] per copy, and
        # copies x owners warps, each owner a class of the block's nodes
        assert fb <= 32 and p["slab_bytes"] == nb * Bt * 3 * 32 * 4
        assert p["copies"] * p["owners"] == p["warps"] <= 8
        assert p["owners"] <= nb
        assert p["copies"] * p["slab_bytes"] < p["smem_bytes"]
        assert p["tile_rows"] == 64 * p["warps"]
    else:
        # one feature per block, a node block from the budget
        assert fb == 1 and p["slab_bytes"] == nb * Bt * 12
        assert p["smem_bytes"] == p["slab_bytes"]
        assert p["smem_bytes"] <= hist._SMEM_BUDGET or nb == 1
    assert p["copies"] in (1, 2, 4, 8)
    assert p["smem_bytes"] <= hist._SMEM_MAX
    assert p["blocks"] == p["groups"] * p["node_blocks"] * p["row_splits"]
    assert p["blocks"] <= hist._GRID_X_MAX


@pytest.mark.parametrize("N,node_blocks,copies,owners", [
    (1, 1, 8, 1), (2, 1, 4, 2), (4, 1, 2, 4), (8, 1, 1, 8), (16, 2, 1, 8),
])
def test_launch_plan_of_the_main_path_levels(N, node_blocks, copies, owners):
    """At 11M x 28 int8 rows and 65 bins every level runs the lane kernel
    with all 28 features in one group: slab copies where nodes are few,
    node owners where they are many, two node blocks at N = 16, and one
    block per SM of the H100's 132."""
    p = _plan(11_000_000, 28, N, 65)
    assert p["kernel"] == "lanes" and p["groups"] == 1
    assert (p["node_blocks"], p["copies"], p["owners"]) == \
        (node_blocks, copies, owners)
    assert p["blocks"] == 132


@pytest.mark.parametrize("R,F,N,Bt", [
    (1 << 20, 4, 1 << 14, 65), (2048, 3, 128, 257),
])
def test_launch_plan_degrades_to_the_atomic_kernel(R, F, N, Bt):
    """Where a block holds too few nodes for the lane kernel (2^14 nodes,
    or 257 bins at 128 nodes), the plan takes the atomic kernel."""
    assert _plan(R, F, N, Bt, 2 if Bt > 126 else 1)["kernel"] == "atomic"


@pytest.mark.parametrize("N,Bt,kernel", [
    (512, 65, "lanes"), (1024, 65, "atomic"), (4, 129, "lanes"),
    (8, 129, "atomic"), (1, 257, "atomic"),
])
def test_launch_plan_takes_the_kernel_measured_faster(N, Bt, kernel):
    """The switch between the kernels where bench/hist_crossover.py found
    it on the H100 at 11M rows x 28 features: the lane kernel with 8 warps
    (65 bins) up to 64 node blocks, with 4 warps (129 bins) in one node
    block, with 2 warps (257 bins) never."""
    assert _plan(11_000_000, 28, N, Bt, 1 if Bt < 128 else 2)["kernel"] == \
        kernel


@pytest.mark.parametrize("kernel,N,Bt,node_blocks,groups", [
    ("atomic", 16, 65, 1, 28), ("lanes", 1 << 14, 65, 2048, 1),
    ("lanes", 128, 257, 64, 1),
])
def test_launch_plan_takes_the_kernel_it_is_given(kernel, N, Bt, node_blocks,
                                                  groups):
    """A forced kernel (the crossover bench times both) gets its own plan
    at any shape it can hold."""
    p = _plan(1_000_000, 28, N, Bt, 2 if Bt > 126 else 1, kernel)
    assert p["kernel"] == kernel
    assert (p["node_blocks"], p["groups"]) == (node_blocks, groups)


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
    (4099, 5, 64, 1, np.int8, True),         # one node: the slab copies
    (1 << 16, 28, 64, 16, np.int8, False),   # four feature groups
    (2048, 3, 256, 128, np.int16, True),
])
def test_kernel_matches_plain_on_card(cuda_device, R, F, B, N, dtype, node0):
    data = _data(6, R, F, B, N, dtype=dtype)
    if node0:
        data[1][:] = 0
    before = hist.level_histograms.launches
    got = _port(hist.level_histograms, *data, N, B + 1, device=cuda_device)
    assert hist.level_histograms.launches == before + 1
    _close(got, _port(hist.level_histograms_plain, *data, N, B + 1,
                      device=cuda_device))
