"""Level histograms of tree growth — the port of ``h2o3_tpu/ops/pallas_hist.py``.

For every feature f, node n < N and bin b < Bt::

    hist[f, n*Bt + b, :] = sum over rows r with node[r] == n and
                           min(bin[f, r], Bt - 1) == b of (g[r], h[r], w[r])

Rows at node -1 add nothing. A batch of K classes (the reference's
``jax.vmap`` of ``hist_pallas`` over the K class trees of a multinomial
round) passes ``node``, ``g`` and ``h`` as [K, R] and ``w`` as [K, R] or as
one [R] row that every class shares, and gets [K, F, N*Bt, 3] back.
:func:`level_histograms_plain` is the plain PyTorch version (the same
function as the JAX reference's ``models/tree.py:_level_histograms``);
:func:`level_histograms` launches the hand-written CUDA kernels of
``csrc/hist.cu`` on CUDA tensors (the lane kernel, without atomics, at the
shapes where it was measured the faster; the atomic kernel elsewhere), one
launch for all K classes, and takes the plain version only for tensors on
the CPU. ``level_histograms.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: largest dynamic shared memory of one block on Hopper
_SMEM_MAX = 227 * 1024
#: fewest row tiles per block, so that zeroing and flushing a slab stay
#: small beside counting rows into it
_MIN_TILES_PER_BLOCK = 2
#: CUDA's limits on grid dimensions x (feature groups, node blocks and row
#: splits) and y (classes)
_GRID_X_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535

# lane_hist_kernel: kinds 0-2 of h2o3_level_hist are its modes (the kernel,
# then its updates-out and staging-only measurement instances)
_COUNT, _UPDATES_OUT, _STAGING_ONLY = 0, 1, 2
#: most warps of a block, and most lanes (features) of a feature group
_LANE_WARPS = 8
_LANE_FEATURES = 32
#: tile rows per warp for int8 bins; int16 takes half (rows_per_warp)
_LANE_ROWS_PER_WARP = 64
#: most node blocks (each of which reads every row) at which the lane kernel
#: beat the atomic kernel, by warps per block, at 11M rows x 28 features
#: (bench/hist_crossover.py on the H100): with 8 warps up to 64 (not 128),
#: with 4 one (not 2), with 2 or 1 none. Elsewhere the atomic kernel is
#: planned.
_LANE_MAX_NODE_BLOCKS = {8: 64, 4: 1}

# atomic_hist_kernel: kind 3
_ATOMIC = 3
#: shared memory one block may hold for its slab: two such blocks fit on an
#: SM
_SMEM_BUDGET = 96 * 1024
#: threads per block, which are also the rows of one tile (kThreads)
_ATOMIC_THREADS = 256


def level_histograms_plain(binned_T: torch.Tensor, node: torch.Tensor,
                           g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                           n_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[F, n_nodes*n_bins_tot, 3] float32 histograms of (g, h, w), or
    [K, F, n_nodes*n_bins_tot, 3] for a batch of K classes, built feature by
    feature with one ``index_add_`` onto (k*N + node)*Bt + bin ids (the
    reference scans features with one ``segment_sum`` per stat). A 1-D call
    is the K = 1 batch."""
    if node.dim() == 1:
        return level_histograms_plain(binned_T, node[None], g[None],
                                      h[None], w, n_nodes, n_bins_tot)[0]
    K, R = node.shape
    F = binned_T.shape[0]
    NB = n_nodes * n_bins_tot
    active = node >= 0
    cls = torch.arange(K, device=node.device)[:, None] * n_nodes
    base = torch.where(active, (cls + node.long()) * n_bins_tot, 0)
    stats = torch.stack([torch.where(active, v, 0.0)
                         for v in (g, h, w.expand(K, R))], -1).reshape(-1, 3)
    out = torch.zeros((F, K * NB, 3), dtype=torch.float32,
                      device=binned_T.device)
    for f in range(F):
        b = binned_T[f].long()
        # the kernel skips negative bins too
        keep = (active & (b >= 0)).reshape(-1)
        ids = (base + b.clamp_max(n_bins_tot - 1)).reshape(-1)
        out[f].index_add_(0, ids[keep], stats[keep])
    return out.reshape(F, K, NB, 3).transpose(0, 1).contiguous()


def _lane_smem_bytes(Nb: int, Bt: int, Fb: int, copies: int, warps: int,
                     bin_bytes: int) -> int:
    """Shared memory of lane_hist_kernel (lane_smem_words in hist.cu): the
    slab copies [copies, 3, Nb, Bt, 32] float32, the staged tile's stats
    [T + 1, 4] (row T is a zero row) and node [T], each warp's row list of
    64, and the tile's bins [Fb, T*bin_bytes/4 + 1] words."""
    T = _LANE_ROWS_PER_WARP // bin_bytes * warps
    return 4 * (copies * 3 * Nb * Bt * 32 + 4 * (T + 1) + T + 64 * warps
                + Fb * (T * bin_bytes // 4 + 1))


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def _lane_plan(F: int, n_nodes: int, n_bins_tot: int, bin_bytes: int):
    """lane_hist_kernel's shape, or None where a block cannot hold one
    node's slab beside a tile: feature groups of at most 32 (one per lane),
    Nb nodes per block (what shared memory holds beside a full tile), owners
    (node classes, one warp each) and slab copies (one set of owners each),
    with copies x owners warps."""
    groups = -(-F // _LANE_FEATURES)
    fb = -(-F // groups)
    per_node = 3 * n_bins_tot * 32 * 4
    avail = _SMEM_MAX - _lane_smem_bytes(0, n_bins_tot, fb, 0, _LANE_WARPS,
                                         bin_bytes)
    nb = min(n_nodes, avail // per_node)
    if nb < 1:
        return None
    owners = _pow2_floor(min(nb, _LANE_WARPS))
    copies = _pow2_floor(min(_LANE_WARPS // owners, avail // (nb * per_node)))
    warps = copies * owners
    return dict(kernel="lanes", features_per_group=fb, groups=groups,
                nodes_per_block=nb, node_blocks=-(-n_nodes // nb),
                copies=copies, owners=owners, warps=warps,
                slab_bytes=nb * per_node,
                smem_bytes=_lane_smem_bytes(nb, n_bins_tot, fb, copies,
                                            warps, bin_bytes),
                tile_rows=_LANE_ROWS_PER_WARP // bin_bytes * warps)


def _atomic_plan(F: int, n_nodes: int, n_bins_tot: int):
    """atomic_hist_kernel's shape: one feature per block and as many nodes
    as the slab [Nb, Bt, 3] float32 fits in the budget (at least one)."""
    per = n_bins_tot * 3 * 4            # one node's bins
    if per > _SMEM_MAX:
        raise ValueError(f"{n_bins_tot} bins per node need {per} bytes "
                         f"of shared memory; a block has {_SMEM_MAX}")
    nb = min(n_nodes, max(1, _SMEM_BUDGET // per))
    return dict(kernel="atomic", features_per_group=1, groups=F,
                nodes_per_block=nb, node_blocks=-(-n_nodes // nb), copies=1,
                owners=1, warps=_ATOMIC_THREADS // 32, slab_bytes=nb * per,
                smem_bytes=nb * per, tile_rows=_ATOMIC_THREADS)


@functools.lru_cache(maxsize=256)
def _kernel_plan(F: int, n_nodes: int, n_bins_tot: int, bin_bytes: int = 1,
                 kernel: str | None = None) -> dict:
    """The kernel and its block shape: ``kernel`` ("lanes" or "atomic")
    where given, else the lane kernel wherever it was measured the faster
    (``_LANE_MAX_NODE_BLOCKS``), else the atomic kernel."""
    if kernel != "atomic":
        lanes = _lane_plan(F, n_nodes, n_bins_tot, bin_bytes)
        if kernel == "lanes" and lanes is None:
            raise ValueError(f"the lane kernel holds no node of "
                             f"{n_bins_tot} bins")
        if kernel == "lanes" or (lanes and lanes["node_blocks"]
                                 <= _LANE_MAX_NODE_BLOCKS.get(lanes["warps"],
                                                              0)):
            return lanes
    return _atomic_plan(F, n_nodes, n_bins_tot)


@functools.lru_cache(maxsize=256)
def _plan(R: int, F: int, n_nodes: int, n_bins_tot: int, bin_bytes: int,
          sms: int, blocks_per_sm: int, kernel: str | None = None,
          K: int = 1) -> dict:
    """Launch shape: :func:`_kernel_plan`'s fields, plus the row tiles and
    the persistent grid: about ``sms`` x ``blocks_per_sm`` blocks (the
    card's SMs and the kernel's occupancy at this shape), split over the K
    classes (the grid's y dimension), feature groups and node blocks, each
    block walking every ``row_splits``-th tile. Each class has a slab of
    its own, so the kernel and its block shape do not depend on K."""
    p = _kernel_plan(F, n_nodes, n_bins_tot, bin_bytes, kernel)
    combos = p["groups"] * p["node_blocks"]
    tiles = -(-R // p["tile_rows"])
    # at most one wave: a block more than the SMs hold would double the time
    splits = max(1, min(sms * blocks_per_sm // (combos * K),
                        tiles // _MIN_TILES_PER_BLOCK))
    if combos * splits > _GRID_X_MAX:
        raise ValueError(f"{combos} feature groups x node blocks exceed the "
                         f"grid's {_GRID_X_MAX} blocks")
    if K > _GRID_Y_MAX:
        raise ValueError(f"{K} classes exceed the grid's {_GRID_Y_MAX}")
    return dict(p, tiles=tiles, row_splits=splits, classes=K,
                blocks=combos * splits * K)


def _check(binned_T, node, g, h, w, n_nodes, n_bins_tot) -> None:
    """Raise on anything the kernel does not take."""
    if binned_T.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"binned_T must be int8 or int16, got {binned_T.dtype}")
    if binned_T.dim() != 2:
        raise ValueError(f"binned_T must be [F, R], got {tuple(binned_T.shape)}")
    F, R = binned_T.shape
    if node.dtype != torch.int32 or node.dim() not in (1, 2) \
            or node.shape[-1] != R or (node.dim() == 2 and node.shape[0] == 0):
        raise TypeError(f"node must be int32 [{R}] or [K, {R}], got "
                        f"{node.dtype} {tuple(node.shape)}")
    shape = tuple(node.shape)
    for name, v, shapes in (("g", g, (shape,)), ("h", h, (shape,)),
                            ("w", w, (shape, (R,)))):
        if v.dtype != torch.float32 or tuple(v.shape) not in shapes:
            raise TypeError(f"{name} must be float32 "
                            f"{' or '.join(map(str, shapes))}, got {v.dtype} "
                            f"{tuple(v.shape)}")
    for name, v in (("binned_T", binned_T), ("node", node), ("g", g),
                    ("h", h), ("w", w)):
        if v.device != binned_T.device:
            raise ValueError(f"{name} is on {v.device}, binned_T on "
                             f"{binned_T.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_nodes < 1 or n_bins_tot < 1:
        raise ValueError(f"n_nodes={n_nodes} and n_bins_tot={n_bins_tot} "
                         "must be positive")


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(device_index: int, kind: int, bin_bytes: int,
                   threads: int, smem_bytes: int) -> int:
    """Blocks of kernel ``kind`` one SM of the card holds, from CUDA's
    occupancy calculator."""
    from h2o3_tpu_torch.ops import _build
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().h2o3_level_hist_blocks_per_sm(
            kind, bin_bytes, threads, smem_bytes, ctypes.byref(blocks))
    _build.check(err, "level histogram occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the histogram kernel does not fit an SM at "
                           f"{smem_bytes} bytes of shared memory")
    return blocks.value


def launch_plan(binned_T: torch.Tensor, n_nodes: int, n_bins_tot: int,
                kernel: str | None = None, K: int = 1) -> dict:
    """The plan :func:`level_histograms` launches with for these CUDA
    inputs and K classes (or, with ``kernel``, the plan of that kernel):
    :func:`_plan` at the card's SM count and the kernel's occupancy."""
    F, R = binned_T.shape
    bb = binned_T.element_size()
    dev = binned_T.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    k = _kernel_plan(F, n_nodes, n_bins_tot, bb, kernel)
    kind = _ATOMIC if k["kernel"] == "atomic" else _COUNT
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _plan(R, F, n_nodes, n_bins_tot, bb, sms,
                 _blocks_per_sm(dev, kind, bb, 32 * k["warps"],
                                k["smem_bytes"]), kernel, K)


def _launch(binned_T, node, g, h, w, n_nodes: int, n_bins_tot: int,
            kernel: str | None = None, mode: int = _COUNT) -> torch.Tensor:
    """Check the inputs, plan, and launch on CUDA tensors the planned kernel
    (or ``kernel``, "lanes" or "atomic"), or the lane kernel in a
    measurement ``mode``, once for all classes of a batch; returns the
    zero-initialised output it added into. Each launch of a kernel in its
    counting mode adds one to ``level_histograms.launches``."""
    _check(binned_T, node, g, h, w, n_nodes, n_bins_tot)
    if binned_T.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {binned_T.device}")
    F, R = binned_T.shape
    batched = node.dim() == 2
    K = node.shape[0] if batched else 1
    out = torch.zeros((K, F, n_nodes * n_bins_tot, 3), dtype=torch.float32,
                      device=binned_T.device)
    if R == 0:
        return out if batched else out[0]
    from h2o3_tpu_torch.ops import _build
    lib = _build.library()
    p = launch_plan(binned_T, n_nodes, n_bins_tot,
                    "lanes" if mode != _COUNT else kernel, K)
    kind = _ATOMIC if p["kernel"] == "atomic" else mode
    with torch.cuda.device(binned_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.h2o3_level_hist(
            kind, binned_T.data_ptr(), binned_T.element_size(),
            node.data_ptr(), g.data_ptr(), h.data_ptr(), w.data_ptr(),
            out.data_ptr(), R, F, n_nodes, n_bins_tot,
            p["features_per_group"], p["nodes_per_block"], p["copies"],
            p["owners"], p["row_splits"], p["smem_bytes"], K,
            R if w.dim() == 2 else 0, stream)
    _build.check(err, f"level histogram ({p['kernel']}) launch")
    if mode == _COUNT:
        level_histograms.launches += 1
    return out if batched else out[0]


def level_histograms(binned_T: torch.Tensor, node: torch.Tensor,
                     g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                     n_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[F, n_nodes*n_bins_tot, 3] level histograms, or
    [K, F, n_nodes*n_bins_tot, 3] for a batch of K classes.

    ``binned_T`` [F, R] int8/int16; ``node`` [R] or [K, R] int32 (-1 =
    inactive); ``g``/``h`` float32 shaped as ``node``; ``w`` float32 shaped
    as ``node`` or [R] (one weight row for every class); all contiguous on
    one device. On a CUDA device this launches ``csrc/hist.cu`` once (or
    raises); on the CPU it is :func:`level_histograms_plain`."""
    if binned_T.device.type == "cpu":
        _check(binned_T, node, g, h, w, n_nodes, n_bins_tot)
        return level_histograms_plain(binned_T, node, g, h, w, n_nodes,
                                      n_bins_tot)
    return _launch(binned_T, node, g, h, w, n_nodes, n_bins_tot)


level_histograms.launches = 0


def level_histograms_loads_only(binned_T: torch.Tensor, node: torch.Tensor,
                                g: torch.Tensor, h: torch.Tensor,
                                w: torch.Tensor, n_nodes: int,
                                n_bins_tot: int,
                                scan: bool = True) -> torch.Tensor:
    """The lane kernel of :func:`level_histograms` with its slab updates
    compiled out, on the lane plan: it stages, lists and decodes the same
    rows and returns zeros; with ``scan=False`` it only stages the tiles.
    Measurement instances (chip_smoke.py times them to split load, scan and
    update time); nothing on the training path calls them, and they add
    nothing to ``level_histograms.launches``."""
    return _launch(binned_T, node, g, h, w, n_nodes, n_bins_tot,
                   mode=_UPDATES_OUT if scan else _STAGING_ONLY)


def hist_bytes(R: int, F: int, n_nodes: int, n_bins_tot: int,
               bin_bytes: int, K: int = 1, w_per_class: bool = False) -> int:
    """Bytes the function must move for K classes: each input read once
    (the bins once for all classes, node/g/h per class, w per class or one
    shared row), the output written once."""
    return (R * F * bin_bytes + K * R * 12 + (K if w_per_class else 1) * R * 4
            + K * F * n_nodes * n_bins_tot * 3 * 4)


def hist_flops(active_rows: int, F: int) -> int:
    """Float adds the function needs: three per active row (summed over the
    classes of a batch) and feature."""
    return 3 * active_rows * F
