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
``csrc/hist.cu`` on CUDA tensors, one launch for all K classes: each level
takes the kernel that ``bench/hist_crossover.py`` measured the fastest at its
node and bin count: the fixed-point kernel, with integer shared atomics,
where nodes are few (below 64 at 65 bins, 32 at 129, 16 at 257, 4 at
1025), the global kernel, which reads each row once and adds into L2, where
they are many. It takes the plain version only for tensors on the CPU.
``level_histograms.kernel_launches`` counts each kernel's launches and
:func:`launch_count` their sum.

Across the ranks of a cloud (``parallel/``), :func:`mesh_level_histograms`
and :func:`mesh_node_totals` give every rank the histograms of all the
rows from its own block, equal bit for bit to one launch over all of them
at every fixed-kernel level: the ranks sum the scale kernel's exponent
counts (one all_reduce), each derives the one-launch scale from them, the
fixed kernel adds its block at that scale into its int64 accumulator, and
the ranks sum the accumulators (a second all_reduce) before one
conversion. Integer sums do not depend on the order of the adds, so the
result does not depend on the ranks' count. Global-kernel levels sum
float32 histograms, as the JAX package's psum does, and are not bit-exact
across rank counts. On the CPU the same steps run through the plain fixed
version (:func:`fixed_counts_plain`, :func:`fixed_acc_plain`), which
:func:`fixed_point_on_cpu` also selects for a one-rank fit.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import math
import threading

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

# fixed_hist_kernel: kind 0 of the occupancy query, entry h2o3_fixed_hist;
# fixed-point sums with int32 shared atomics, flushed into an int64
# accumulator. Its modes: the kernel, then its updates-out and
# staging-only measurement instances
_FIXED = 0
_COUNT, _UPDATES_OUT, _STAGING_ONLY, _TOTALS = 0, 1, 2, 3
# the distributed modes (hist.cu: kAccOut, kTotalsAcc, kScaleOnly): the
# accumulator out at exponents given, for levels and node totals, and the
# scale kernel's exponent counts alone
_ACC_OUT, _TOTALS_ACC, _SCALE_ONLY = 4, 5, 6
#: threads per block (one block per SM), rows of one tile, and the most
#: features of a group (kFixedThreads, kFixedRows, kFixedMaxFeatures)
_FIXED_THREADS = 512
_FIXED_ROWS = 256
_FIXED_MAX_FEATURES = 32
#: tiles staged ahead of the adding warps (kFixedStages)
_FIXED_STAGES = 2
#: dynamic shared memory a fixed block may plan: the block's 227 KB less 1 KB
#: for the kernel's static shared memory (288 bytes)
_FIXED_SMEM_BUDGET = _SMEM_MAX - 1024
_INT32_MAX = 2 ** 31 - 1
#: bits of a quantised value: at most 22 (kFixedMaxQbits), and at least 15,
#: so that a block flushes its slab at least every 255 tiles
_FIXED_MAX_QBITS = 22
_FIXED_MIN_QBITS = 15
#: the precision the plan keeps: 2 x qbits + log2(n) >= 41, n = R / (2 N Bt)
#: the rows an entry of a level holds on average (half the rows active, the
#: siblings coming by subtraction). An entry's rounding error grows as
#: 2^-qbits x sqrt(n) and the check's floor (1e-5 x max|hist|) as n, so the
#: rule holds their ratio. bench/hist_crossover.py at 11M rows and 15 bits
#: saw the kernel fail float64 sums at 2 x qbits + log2(n) = 38.4 (334 rows
#: an entry), fail one of three shapes at 39.4 (670 rows) and pass all from
#: 40.4 on; 41 keeps a factor of 1.7 in that ratio over 39.4.
_FIXED_PRECISION = 41
#: the two-tier scale (kExpBuckets, kOutlierCap, kOutlierBits in hist.cu):
#: values are counted by float exponent in 256 buckets per stat; the bulk
#: bucket is the highest whose values, with every higher bucket's, outnumber
#: 64, and lies at most 56 - qbits below the top bucket; values above it are
#: outliers, added apart at the bulk's scale
_EXP_BUCKETS = 256
_OUTLIER_CAP = 64
_OUTLIER_BITS = 56
#: bits of a value in the node-totals instance: its slab is a few hundred
#: words, so it flushes every 15 tiles at little cost and keeps 4 bits more
#: than the plan's least
_TOTALS_QBITS = 19

# global_hist_kernel: kind 1 of the occupancy query, entry h2o3_global_hist;
# one 16-byte reduction per (row, feature) into a [K, F, N*Bt, 4] scratch
_GLOBAL = 1
#: threads per block; a tile is four rows a thread (kGlobalRows)
_GLOBAL_THREADS = 256
_GLOBAL_ROWS = 4 * _GLOBAL_THREADS
#: most features whose bins a block stages per pass, and the largest node
#: count a list entry packs beside its row (kGlobalMaxNodes)
_GLOBAL_MAX_FEATURES = 32
_GLOBAL_MAX_NODES = 2 ** 21
#: histogram bytes one pass of features keeps in use at once: 8 MiB was the
#: fastest budget at 1024 and 4096 nodes (65 bins) and at 1024 nodes of 257
#: bins, against 4, 16 and 32 MiB and one pass (bench/hist_crossover.py on
#: the H100)
_GLOBAL_L2_BYTES = 8 * 2 ** 20

#: the kernel a level takes, from where bench/hist_crossover.py measured
#: each the fastest at 11M rows x 28 features on the H100 (K = 1 and 3
#: alike): by the bins (incl. NA) up to which an entry holds, the kernel
#: below a node count and the global kernel from it on. A bin count between
#: or beyond the measured ones takes the entry of the least measured count
#: at or above it, or else the largest.
_KERNEL_SWITCH = {65: ("fixed", 64), 129: ("fixed", 32), 257: ("fixed", 16),
                  1025: ("fixed", 4)}

#: kind of the occupancy query by kernel
_KINDS = {"fixed": _FIXED, "global": _GLOBAL}
#: held across each call into the library and each update of the launch
#: counts: a launch sets its kernel's dynamic shared-memory ceiling, which
#: is process-wide, before it launches, so overlapped builds on other
#: threads must not set it in between (a launch above another's lower
#: ceiling is refused)
_LAUNCH_LOCK = threading.Lock()


def level_histograms_plain(binned_T: torch.Tensor, node: torch.Tensor,
                           g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                           n_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[F, n_nodes*n_bins_tot, 3] float32 histograms of (g, h, w), or
    [K, F, n_nodes*n_bins_tot, 3] for a batch of K classes, built feature by
    feature with one ``index_add_`` onto (k*N + node)*Bt + bin ids (the
    reference scans features with one ``segment_sum`` per stat). A 1-D call
    is the K = 1 batch. Float64 stats give float64 sums (a yardstick for
    the kernels' rounding)."""
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
    out = torch.zeros((F, K * NB, 3), dtype=g.dtype, device=binned_T.device)
    for f in range(F):
        b = binned_T[f].long()
        # the kernel skips negative bins too
        keep = (active & (b >= 0)).reshape(-1)
        ids = (base + b.clamp_max(n_bins_tot - 1)).reshape(-1)
        out[f].index_add_(0, ids[keep], stats[keep])
    return out.reshape(F, K, NB, 3).transpose(0, 1).contiguous()


def _scale_buckets(vals: torch.Tensor, qbits: int) -> tuple:
    """The two-tier scale of one stat from its active values (float32, all
    classes): (top, bulk, non-finite), the top non-empty finite exponent
    bucket, the bulk bucket and whether a value is NaN or infinite;
    bucket b holds 2^(b-127) <= |x| < 2^(b-126), top -1 where there is no
    finite value (fixed_hist_kernel's selection)."""
    bits = vals.contiguous().view(torch.int32) & 0x7fffffff
    c = torch.bincount((bits >> 23).long(), minlength=_EXP_BUCKETS).tolist()
    nonfinite = c[_EXP_BUCKETS - 1] > 0
    top = max((b for b in range(_EXP_BUCKETS - 1) if c[b]), default=-1)
    above, bulk = 0, top
    for b in range(top, -1, -1):
        if above + c[b] > _OUTLIER_CAP:
            bulk = max(b, top - (_OUTLIER_BITS - qbits))
            break
        above += c[b]
    return top, bulk, nonfinite


def fixed_exponents(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                    w: torch.Tensor, n_nodes: int, qbits: int) -> tuple:
    """fixed_hist_kernel's scale rule: for each of g, h and w, over the
    values at a node in [0, n_nodes) of every class, the bulk bucket B of
    :func:`_scale_buckets` (the top bucket where at most 64 values lie above
    the one below it) and E = max(B, 1) - 126 (for the top bucket, the
    exponent of max|x|: max = m * 2**E with m in [0.5, 1)), 0 with no
    value; returns the exponents ``qbits - E`` that scale a value to its
    integer (|q| <= 2**qbits below 2**E, larger for the outliers above it)
    and whether each stat holds a non-finite value (then it is NaN
    throughout)."""
    node2 = node.reshape(-1, node.shape[-1])
    active = (node2 >= 0) & (node2 < n_nodes)
    exps, bad = [], []
    for v in (g, h, w):
        vals = v.reshape(-1, v.shape[-1]).expand(node2.shape)[active]
        top, bulk, nonfinite = _scale_buckets(vals.float(), qbits)
        bad.append(nonfinite)
        e = 0 if top < 0 else max(bulk, 1) - 126
        exps.append(0 if nonfinite else qbits - e)
    return exps, bad


def level_histograms_fixed_plain(binned_T: torch.Tensor, node: torch.Tensor,
                                 g: torch.Tensor, h: torch.Tensor,
                                 w: torch.Tensor, n_nodes: int,
                                 n_bins_tot: int, qbits: int) -> torch.Tensor:
    """What fixed_hist_kernel computes, in plain PyTorch: each active value
    rounded (half to even) to an integer at the scale of
    :func:`fixed_exponents` (the bulk in int32 slabs, the outliers above it
    in int64 straight into the accumulator, both at that one scale),
    summed exactly in int64 by ``index_add_``, and scaled back in float64
    before one rounding to float32; a stat holding a non-finite value is
    NaN throughout. The kernel's output equals it bit for bit at the plan's
    ``qbits``; it lies within n x 2**(E_s - qbits - 1) (n the entry's rows,
    2**E_s the stat's bulk bound) plus float32 rounding of the exact
    sums."""
    if node.dim() == 1:
        return level_histograms_fixed_plain(binned_T, node[None], g[None],
                                            h[None], w, n_nodes, n_bins_tot,
                                            qbits)[0]
    exps, bad = fixed_exponents(node, g, h, w, n_nodes, qbits)
    acc = fixed_acc_plain(binned_T, node, g, h, w, n_nodes, n_bins_tot,
                          exps, bad)
    return fixed_from_acc(acc, torch.tensor(exps), torch.tensor(bad))


def fixed_acc_plain(binned_T: torch.Tensor, node: torch.Tensor,
                    g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    n_nodes: int, n_bins_tot: int, exps: list,
                    bad: list) -> torch.Tensor:
    """The int64 accumulator [K, F, n_nodes*n_bins_tot, 3] of
    :func:`level_histograms_fixed_plain` (node, g, h as [K, R]) at the
    given scale: each active value rounded to an integer at 2**exps[s],
    nothing for a ``bad`` stat. What the fixed kernel's distributed mode
    leaves in its accumulator, bit for bit."""
    K, R = node.shape
    F = binned_T.shape[0]
    NB = n_nodes * n_bins_tot
    active = (node >= 0) & (node < n_nodes)
    cls = torch.arange(K, device=node.device)[:, None] * n_nodes
    base = torch.where(active, (cls + node.long()) * n_bins_tot, 0)
    q = [torch.where(active & ~torch.tensor(z),
                     torch.round(v.expand(K, R).double() * 2.0 ** e),
                     0.0).long().reshape(-1)
         for v, e, z in zip((g, h, w), exps, bad)]
    # values of at most 2^22 (the bulk) are summed by float64 bincounts,
    # exactly: an entry's sum stays below K R 2^22 < 2^53; the few larger
    # ones (outliers) by int64 index_add_
    lim = 2 ** _FIXED_MAX_QBITS
    small = [torch.where(v.abs() <= lim, v, 0).double() for v in q]
    large = [(v.abs() > lim).nonzero()[:, 0] for v in q]
    acc = torch.zeros((F, K * NB, 3), dtype=torch.int64,
                      device=binned_T.device)
    for f in range(F):
        b = binned_T[f].long()
        ids = (base + b.clamp(0, n_bins_tot - 1)).reshape(-1)
        # the kernel skips negative bins
        skip = (b < 0).expand(K, R).reshape(-1)
        has_skip = bool(skip.any())
        for st in range(3):
            wts = torch.where(skip, 0.0, small[st]) if has_skip else small[st]
            acc[f, :, st] = torch.bincount(ids, weights=wts,
                                           minlength=K * NB).long()
            rows = large[st][~skip[large[st]]]
            if rows.numel():
                acc[f, :, st].index_add_(0, ids[rows], q[st][rows])
    return acc.reshape(F, K, NB, 3).transpose(0, 1).contiguous()


def fixed_from_acc(acc: torch.Tensor, exps: torch.Tensor,
                   bad: torch.Tensor) -> torch.Tensor:
    """float32 sums of an int64 accumulator [..., 3] at the scales 2**exps
    (int [3]): each sum scaled back in float64 by an exact power of two,
    then rounded once (the fixed kernel's conversion); NaN throughout a
    ``bad`` stat. ``exps`` and ``bad`` may lie on the card: no sync."""
    e = exps.to(device=acc.device, dtype=torch.int64)
    scale = ((1023 - e) << 52).view(torch.float64)     # 2**-e, exactly
    out = (acc.double() * scale).float()
    return torch.where(bad.to(acc.device), float("nan"), out)


def _fixed_stride(Fb: int) -> int:
    """The slab's feature stride (fixed_stride in hist.cu): Fb rounded up
    to a power of two, so that lane l adds feature l % P."""
    return 1 << (Fb - 1).bit_length()


def _fixed_smem_bytes(Fb: int, Nb: int, Bt: int, bin_bytes: int) -> int:
    """Shared memory of fixed_hist_kernel (fixed_smem_bytes in hist.cu): the
    slab [3, Nb, Bt, P] int32 (padded to 16 bytes), and for each of the two
    staged tiles its row list [256] int4 and its bins [Fb, 256*bin_bytes/4
    + 1] words."""
    return (16 * -(-3 * Nb * Bt * _fixed_stride(Fb) // 4)
            + _FIXED_STAGES * (16 * _FIXED_ROWS
                               + 4 * Fb * (_FIXED_ROWS * bin_bytes // 4 + 1)))


def _fixed_plan(F: int, n_nodes: int, n_bins_tot: int,
                bin_bytes: int) -> dict:
    """fixed_hist_kernel's shape: of the feature groups (at most 32
    features each) whose slab holds a node beside the tile in a block's
    shared memory, the one that reads the fewest bytes per row (16 of node,
    g, h and w per group, the bins once per node block), each block holding
    as many nodes as fit."""
    best = None
    for groups in range(-(-F // _FIXED_MAX_FEATURES), F + 1):
        fb = -(-F // groups)
        if groups > 1 and fb == -(-F // (groups - 1)):
            continue
        per_node = 12 * n_bins_tot * _fixed_stride(fb)
        nb = min(n_nodes, (_FIXED_SMEM_BUDGET - _fixed_smem_bytes(
            fb, 0, n_bins_tot, bin_bytes)) // per_node)
        if nb < 1:
            continue
        cost = -(-F // fb) * 16 + -(-n_nodes // nb) * F * bin_bytes
        if best is None or cost < best[0]:
            best = (cost, fb, nb)
    if best is None:
        need = _fixed_smem_bytes(1, 1, n_bins_tot, bin_bytes)
        raise ValueError(f"{n_bins_tot} bins per node need {need} bytes of "
                         f"shared memory; a block has {_FIXED_SMEM_BUDGET}")
    _, fb, nb = best
    return dict(kernel="fixed", features_per_group=fb, groups=-(-F // fb),
                nodes_per_block=nb, node_blocks=-(-n_nodes // nb),
                warps=_FIXED_THREADS // 32,
                slab_bytes=12 * nb * n_bins_tot * _fixed_stride(fb),
                smem_bytes=_fixed_smem_bytes(fb, nb, n_bins_tot, bin_bytes),
                tile_rows=_FIXED_ROWS)


def fixed_qbits(flush_rows: int) -> int:
    """Bits of the largest quantised |value| when a block adds at most
    ``flush_rows`` rows into an int32 entry between two flushes: the most
    with ``flush_rows * 2**qbits <= 2**31 - 1``, at most 22."""
    return min(_FIXED_MAX_QBITS, (_INT32_MAX // flush_rows).bit_length() - 1)


def fixed_needed_qbits(R: int, n_nodes: int, n_bins_tot: int) -> int:
    """The fewest bits a value may keep at a level of R rows over n_nodes x
    n_bins_tot entries: the least qbits in [15, 22] with 2 x qbits +
    log2(R / (2 N Bt)) >= ``_FIXED_PRECISION``, or 22 where none is enough
    (an entry then holds a row or none, and 22 bits keep its error under
    max|x| x 2^-22)."""
    need = math.ceil((_FIXED_PRECISION
                      - math.log2(max(R, 1) / (2 * n_nodes * n_bins_tot)))
                     / 2)
    return max(_FIXED_MIN_QBITS, min(_FIXED_MAX_QBITS, need))


def _global_smem_bytes(Fb: int, bin_bytes: int) -> int:
    """Shared memory of global_hist_kernel (global_smem_bytes in hist.cu):
    the list of a tile's rows [T] float4, each warp's count, and the tile's
    bins [Fb, T]."""
    return (16 * _GLOBAL_ROWS + 4 * (_GLOBAL_THREADS // 32)
            + Fb * _GLOBAL_ROWS * bin_bytes)


def _global_plan(F: int, n_nodes: int, n_bins_tot: int, bin_bytes: int,
                 K: int) -> dict:
    """global_hist_kernel's shape: the histogram entries of all K classes
    cut into as many parts of ``_GLOBAL_L2_BYTES`` as they fill (at least
    one per ``_GLOBAL_MAX_FEATURES`` features, at most one per feature),
    the features spread evenly over them, each group a pass that every
    block walks over its rows in turn; no node blocks."""
    if n_nodes > _GLOBAL_MAX_NODES:
        raise ValueError(f"the global kernel takes at most "
                         f"{_GLOBAL_MAX_NODES} nodes, got {n_nodes}")
    per_feature = K * n_nodes * n_bins_tot * 16   # float4 entries
    passes = min(F, max(-(-F // _GLOBAL_MAX_FEATURES),
                        -(-F * per_feature // _GLOBAL_L2_BYTES)))
    fb = -(-F // passes)
    return dict(kernel="global", features_per_group=fb, groups=-(-F // fb),
                nodes_per_block=n_nodes, node_blocks=1,
                warps=_GLOBAL_THREADS // 32, slab_bytes=0,
                smem_bytes=_global_smem_bytes(fb, bin_bytes),
                tile_rows=_GLOBAL_ROWS)


@functools.lru_cache(maxsize=256)
def _kernel_plan(F: int, n_nodes: int, n_bins_tot: int, bin_bytes: int = 1,
                 kernel: str | None = None, K: int = 1) -> dict:
    """The kernel and its block shape: ``kernel`` ("fixed" or "global")
    where given, else the one ``_KERNEL_SWITCH`` takes at this node and bin
    count. Only the global kernel's shape depends on the K classes."""
    if kernel is None:
        key = min((b for b in _KERNEL_SWITCH if b >= n_bins_tot),
                  default=max(_KERNEL_SWITCH))
        below, min_nodes = _KERNEL_SWITCH[key]
        kernel = "global" if n_nodes >= min_nodes else below
    if kernel == "global":
        return _global_plan(F, n_nodes, n_bins_tot, bin_bytes, K)
    if kernel == "fixed":
        return _fixed_plan(F, n_nodes, n_bins_tot, bin_bytes)
    raise ValueError(f"no histogram kernel {kernel!r}")


@functools.lru_cache(maxsize=256)
def _plan(R: int, F: int, n_nodes: int, n_bins_tot: int, bin_bytes: int,
          sms: int, blocks_per_sm: int, kernel: str | None = None,
          K: int = 1, min_qbits: int = 0) -> dict:
    """Launch shape: :func:`_kernel_plan`'s fields, plus the row tiles and
    the persistent grid: about ``sms`` x ``blocks_per_sm`` blocks (the
    card's SMs and the kernel's occupancy at this shape), split over the K
    classes (the grid's y dimension), feature groups and node blocks, each
    block walking every ``row_splits``-th tile. Each class has a slab of
    its own, so the kernel and its block shape do not depend on K, except
    for the global kernel's passes. The fixed kernel keeps at least
    ``min_qbits`` bits a value where given."""
    p = _kernel_plan(F, n_nodes, n_bins_tot, bin_bytes, kernel, K)
    # the global kernel's feature groups are passes that every block walks
    combos = p["node_blocks"] * (1 if p["kernel"] == "global"
                                 else p["groups"])
    tiles = -(-R // p["tile_rows"])
    # at most one wave: a block more than the SMs hold would double the time
    splits = max(1, min(sms * blocks_per_sm // (combos * K),
                        tiles // _MIN_TILES_PER_BLOCK))
    if combos * splits > _GRID_X_MAX:
        raise ValueError(f"{combos} feature groups x node blocks exceed the "
                         f"grid's {_GRID_X_MAX} blocks")
    if K > _GRID_Y_MAX:
        raise ValueError(f"{K} classes exceed the grid's {_GRID_Y_MAX}")
    p = dict(p, tiles=tiles, row_splits=splits, classes=K,
             blocks=combos * splits * K)
    if p["kernel"] == "fixed":
        # a block flushes its slab every flush_tiles of its tiles, and its
        # values have qbits bits, so that no int32 entry can overflow; it
        # flushes as rarely as the level's precision rule allows
        need = max(min_qbits, fixed_needed_qbits(R, n_nodes, n_bins_tot))
        flush_tiles = max(1, min(-(-tiles // splits),
                                 (_INT32_MAX >> need) // _FIXED_ROWS))
        flush_rows = flush_tiles * _FIXED_ROWS
        p.update(flush_tiles=flush_tiles, flush_rows=flush_rows,
                 qbits=fixed_qbits(flush_rows),
                 scale_blocks=max(1, min(-(-2 * sms // K),
                                         -(-R // (4 * _FIXED_THREADS)))))
    return p


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
        with _LAUNCH_LOCK:
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
    return _card_plan(binned_T.device.index, R, F, n_nodes, n_bins_tot,
                      binned_T.element_size(), K, kernel)


def _card_plan(dev: int | None, R: int, F: int, n_nodes: int,
               n_bins_tot: int, bin_bytes: int, K: int,
               kernel: str | None = "fixed", min_qbits: int = 0) -> dict:
    """:func:`_plan` at these shapes on card ``dev`` (the current one for
    None): its SM count and the kernel's occupancy."""
    if dev is None:
        dev = torch.cuda.current_device()
    k = _kernel_plan(F, n_nodes, n_bins_tot, bin_bytes, kernel, K)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _plan(R, F, n_nodes, n_bins_tot, bin_bytes, sms,
                 _blocks_per_sm(dev, _KINDS[k["kernel"]], bin_bytes,
                                32 * k["warps"], k["smem_bytes"]), kernel, K,
                 min_qbits)


def _fixed_scratch_words(p: dict, F: int, n_nodes: int,
                         n_bins_tot: int) -> int:
    """int64 words of the fixed kernel's scratch: the accumulator [K, F,
    N*Bt, 3], the done counters [K, groups x node blocks] (uint32) and the
    exponent counts [3, 256] (uint64) (launch_fixed in hist.cu)."""
    K = p["classes"]
    return (K * F * n_nodes * n_bins_tot * 3
            + -(-K * p["groups"] * p["node_blocks"] // 2)
            + 3 * _EXP_BUCKETS)


def _launch_fixed(lib, p: dict, binned_T, node, g, h, w, n_nodes: int,
                  n_bins_tot: int, shape: tuple, mode: int,
                  aux: torch.Tensor | None = None) -> tuple:
    """fixed_hist_kernel in ``mode`` (after its scale kernel) into a new
    output, every entry of which it writes; returns the output and the
    launch's error. ``binned_T`` is None for the node-totals instance,
    which reads no bins (F = 1). In a distributed mode the output is the
    scratch, whose first K·F·N·Bt·3 words are the int64 accumulator, and
    ``aux`` the exponents in (int32 [6]) or the counts out (int64 [3, 256])."""
    if p["flush_rows"] << p["qbits"] > _INT32_MAX:
        raise RuntimeError(f"fixed plan may overflow: {p['flush_rows']} rows "
                           f"of up to 2^{p['qbits']} per int32 entry")
    R = node.shape[-1]
    F, bins, bin_bytes = ((1, 0, 1) if binned_T is None else
                          (binned_T.shape[0], binned_T.data_ptr(),
                           binned_T.element_size()))
    dist_mode = mode in (_ACC_OUT, _TOTALS_ACC, _SCALE_ONLY)
    scratch = torch.empty(0 if mode == _SCALE_ONLY else
                          _fixed_scratch_words(p, F, n_nodes, n_bins_tot),
                          dtype=torch.int64, device=node.device)
    out = scratch if dist_mode else torch.empty(
        shape, dtype=torch.float32, device=node.device)
    stream = torch.cuda.current_stream().cuda_stream
    with _LAUNCH_LOCK:
        err = lib.h2o3_fixed_hist(
            mode, ctypes.c_void_p(bins), bin_bytes, node.data_ptr(),
            g.data_ptr(), h.data_ptr(), w.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), R, F, n_nodes, n_bins_tot,
            p["features_per_group"], p["nodes_per_block"], p["row_splits"],
            p["smem_bytes"], p["classes"], R if w.dim() == 2 else 0,
            p["scale_blocks"], p["flush_tiles"], p["qbits"],
            ctypes.c_void_p(0 if aux is None else aux.data_ptr()), stream)
    return out, err


def _launch(binned_T, node, g, h, w, n_nodes: int, n_bins_tot: int,
            kernel: str | None = None, mode: int = _COUNT) -> torch.Tensor:
    """Check the inputs, plan, and launch on CUDA tensors the planned kernel
    (or ``kernel``, "fixed" or "global"), or the fixed kernel in a
    measurement ``mode``, once for all classes of a batch; returns its
    output (the global kernel adds into a zeroed scratch of four floats an
    entry, whose first three are returned; the fixed kernel writes every
    entry of its output). Each launch of a kernel in its counting mode adds
    one to its kernel's count in ``level_histograms.kernel_launches``."""
    _check(binned_T, node, g, h, w, n_nodes, n_bins_tot)
    if binned_T.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {binned_T.device}")
    F, R = binned_T.shape
    batched = node.dim() == 2
    K = node.shape[0] if batched else 1
    shape = (K, F, n_nodes * n_bins_tot, 3)
    if R == 0:
        out = torch.zeros(shape, dtype=torch.float32, device=binned_T.device)
        return out if batched else out[0]
    from h2o3_tpu_torch.ops import _build
    lib = _build.library()
    p = launch_plan(binned_T, n_nodes, n_bins_tot,
                    "fixed" if mode != _COUNT else kernel, K)
    with torch.cuda.device(binned_T.device):
        if p["kernel"] == "fixed":
            out, err = _launch_fixed(lib, p, binned_T, node, g, h, w,
                                     n_nodes, n_bins_tot, shape, mode)
        else:
            out = torch.zeros(shape[:-1] + (4,), dtype=torch.float32,
                              device=binned_T.device)
            stream = torch.cuda.current_stream().cuda_stream
            with _LAUNCH_LOCK:
                err = lib.h2o3_global_hist(
                    binned_T.data_ptr(), binned_T.element_size(),
                    node.data_ptr(), g.data_ptr(), h.data_ptr(),
                    w.data_ptr(), out.data_ptr(), R, F, n_nodes, n_bins_tot,
                    p["features_per_group"], p["row_splits"],
                    p["smem_bytes"], K, R if w.dim() == 2 else 0, stream)
            out = out[..., :3]
    _build.check(err, f"level histogram ({p['kernel']}) launch")
    if mode == _COUNT:
        with _LAUNCH_LOCK:
            level_histograms.kernel_launches[p["kernel"]] += 1
    out = out.contiguous()
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


level_histograms.kernel_launches = {"fixed": 0, "global": 0}


def launch_count() -> int:
    """Kernel launches of :func:`level_histograms`, all kernels together."""
    return sum(level_histograms.kernel_launches.values())


def node_totals_plain(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                      w: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-node (G, H, W) sums [K, n_nodes, 3] of K trees (node/g/h [K, R],
    w [K, R] or shared [R]): one ``index_add_`` onto k*n_nodes + node (the
    reference's ``_node_totals``, a ``segment_sum`` per stat), accumulated
    in float64 and rounded once to the stats' dtype, so that its sums lie as
    near the exact ones as the kernel's integer sums do (a float32
    accumulation over a node of 100k rows drifts by 1e-3 of a leaf value);
    rows at node -1 add nothing."""
    K, R = node.shape
    active = node >= 0
    cls = torch.arange(K, device=node.device)[:, None] * n_nodes
    ids = torch.where(active, cls + node, 0).long().reshape(-1)
    stats = torch.stack([torch.where(active, v, 0.0).double()
                         for v in (g, h, w.expand(K, R))], -1).reshape(-1, 3)
    out = torch.zeros((K * n_nodes, 3), dtype=torch.float64,
                      device=node.device)
    return out.index_add_(0, ids, stats).reshape(K, n_nodes, 3).to(g.dtype)


def node_totals_fixed_plain(node: torch.Tensor, g: torch.Tensor,
                            h: torch.Tensor, w: torch.Tensor, n_nodes: int,
                            qbits: int = _TOTALS_QBITS) -> torch.Tensor:
    """What the node-totals instance of fixed_hist_kernel computes, bit for
    bit: :func:`level_histograms_fixed_plain` at one feature whose every
    bin is 0 (Bt = 1), [K, n_nodes, 3]."""
    zeros = torch.zeros((1, node.shape[-1]), dtype=torch.int8,
                        device=node.device)
    return level_histograms_fixed_plain(zeros, node, g, h, w, n_nodes, 1,
                                        qbits)[:, 0]


def _totals_plan(node: torch.Tensor, n_nodes: int) -> dict:
    """The node-totals instance's plan on the card: the fixed kernel's at
    F = 1 and Bt = 1, keeping ``_TOTALS_QBITS`` bits a value."""
    K, R = node.shape
    return _card_plan(node.device.index, R, 1, n_nodes, 1, 1, K,
                      min_qbits=_TOTALS_QBITS)


def node_totals(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                w: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-node (G, H, W) sums [K, n_nodes, 3] of K trees: ``node``, ``g``,
    ``h`` float32 [K, R] (int32 node, -1 = inactive), ``w`` [K, R] or
    shared [R], contiguous on one device. On a CUDA device one launch of the
    node-totals instance of ``csrc/hist.cu``'s fixed kernel (integer sums at
    a power-of-two scale: the same bits every run), counted in
    ``node_totals.launches``, or an error; on the CPU
    :func:`node_totals_plain`."""
    if node.dim() != 2:
        raise ValueError(f"node must be [K, R], got {tuple(node.shape)}")
    zeros = torch.empty((1, node.shape[1]), dtype=torch.int8,
                        device=node.device)
    _check(zeros, node, g, h, w, n_nodes, 1)
    if node.device.type == "cpu":
        return node_totals_plain(node, g, h, w, n_nodes)
    if node.device.type != "cuda":
        raise ValueError(f"no node-totals kernel for device {node.device}")
    K, R = node.shape
    if R == 0:
        return torch.zeros((K, n_nodes, 3), dtype=torch.float32,
                           device=node.device)
    from h2o3_tpu_torch.ops import _build
    lib = _build.library()
    p = _totals_plan(node, n_nodes)
    with torch.cuda.device(node.device):
        out, err = _launch_fixed(lib, p, None, node, g, h, w, n_nodes, 1,
                                 (K, 1, n_nodes, 3), _TOTALS)
    _build.check(err, "node totals launch")
    with _LAUNCH_LOCK:
        node_totals.launches += 1
    return out[:, 0]


node_totals.launches = 0


def level_histograms_loads_only(binned_T: torch.Tensor, node: torch.Tensor,
                                g: torch.Tensor, h: torch.Tensor,
                                w: torch.Tensor, n_nodes: int,
                                n_bins_tot: int,
                                scan: bool = True) -> torch.Tensor:
    """The fixed kernel of :func:`level_histograms` with its atomic adds and
    flushes compiled out, on the fixed plan: it stages, quantises and lists
    the same rows and reads their bins, and returns zeros; with
    ``scan=False`` it only loads and stores the tiles. Measurement instances
    (chip_smoke.py times them to split load, listing and update time);
    nothing on the training path calls them, and they add nothing to
    ``level_histograms.kernel_launches``."""
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


# ---------------------------------------------------------------------------
# across ranks

#: the global row count of the row-blocked arrays a fit grows trees on
#: (set by a rank-aware builder around its growth, :func:`mesh_rows`)
_MESH_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "h2o3_torch_mesh_rows", default=None)
#: a one-rank fit on the CPU through the fixed plain version, the path a
#: cloud of CPU ranks takes (:func:`fixed_point_on_cpu`)
_FIXED_ON_CPU: contextvars.ContextVar = contextvars.ContextVar(
    "h2o3_torch_fixed_on_cpu", default=False)


@contextlib.contextmanager
def mesh_rows(nrows: int):
    """Within the block, the trees grow on row blocks of ``nrows`` rows in
    all: the scale of a fixed level is planned for them."""
    token = _MESH_ROWS.set(int(nrows))
    try:
        yield
    finally:
        _MESH_ROWS.reset(token)


@contextlib.contextmanager
def fixed_point_on_cpu():
    """Within the block, CPU fits sum every level's histograms and node
    totals as a cloud of CPU ranks does (the fixed plain version, integer
    sums), so a one-rank fit equals a cloud's bit for bit."""
    token = _FIXED_ON_CPU.set(True)
    try:
        yield
    finally:
        _FIXED_ON_CPU.reset(token)


def summed_over_mesh(device: torch.device) -> bool:
    """Whether tree growth on ``device`` takes :func:`mesh_level_histograms`
    and :func:`mesh_node_totals`: under a mesh of more than one rank, or on
    the CPU inside :func:`fixed_point_on_cpu`."""
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    return get_mesh().size > 1 or (device.type == "cpu"
                                   and _FIXED_ON_CPU.get())


def _global_rows(R: int) -> int:
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    n = _MESH_ROWS.get()
    if get_mesh().size == 1:
        return R
    if n is None:
        raise RuntimeError("tree growth across ranks needs the global row "
                           "count: wrap the fit in ops.hist.mesh_rows(n)")
    return n


def fixed_counts_plain(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                       w: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """The scale kernel's exponent counts [3, 256] int64 in plain PyTorch:
    for each of g, h and w, its values at a node in [0, n_nodes) of every
    class counted by float exponent (bucket 255: NaN and infinity)."""
    node2 = node.reshape(-1, node.shape[-1])
    active = (node2 >= 0) & (node2 < n_nodes)
    rows = []
    for v in (g, h, w):
        vals = v.reshape(-1, v.shape[-1]).expand(node2.shape)[active]
        bits = vals.float().contiguous().view(torch.int32) & 0x7fffffff
        rows.append(torch.bincount((bits >> 23).long(),
                                   minlength=_EXP_BUCKETS))
    return torch.stack(rows)


def exponents_from_counts(counts: torch.Tensor, qbits: int) -> tuple:
    """fixed_hist_kernel's scale rule (:func:`_scale_buckets`) on exponent
    counts [3, 256], on their device without a sync: (exps int [3], the
    exponent that scales each stat to its integers, 0 for a stat without
    values; bad bool [3], a stat holding a NaN or an infinity)."""
    c = counts.to(torch.int64)
    bad = c[:, _EXP_BUCKETS - 1] > 0
    c = torch.cat([c[:, :-1], torch.zeros_like(c[:, :1])], dim=1)
    idx = torch.arange(_EXP_BUCKETS, device=c.device)
    top = torch.where(c > 0, idx, -1).amax(dim=1)
    incl = c.flip(1).cumsum(1).flip(1)      # counts at or above each bucket
    brk = torch.where(incl > _OUTLIER_CAP, idx, -1).amax(dim=1)
    bulk = torch.where(brk < 0, top,
                       torch.maximum(brk, top - (_OUTLIER_BITS - qbits)))
    e = torch.where(top < 0, 0, bulk.clamp_min(1) - 126)
    return torch.where(bad, 0, qbits - e), bad


def _forced_qbits(p: dict, qbits: int) -> dict:
    """A fixed plan of a rank's block, flushing often enough to add values
    of ``qbits`` bits (the one-launch plan's) into int32 slab entries."""
    ft = max(1, min(-(-p["tiles"] // p["row_splits"]),
                    (_INT32_MAX >> qbits) // _FIXED_ROWS))
    return dict(p, flush_tiles=ft, flush_rows=ft * _FIXED_ROWS, qbits=qbits)


def fixed_counts(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                 w: torch.Tensor, n_nodes: int, p: dict | None = None,
                 counter=None) -> torch.Tensor:
    """The scale kernel's exponent counts [3, 256] int64 of the active
    values (node/g/h [K, R]): on the card one launch of the fixed kernel's
    scale-only mode on plan ``p`` (counted in ``counter.kernel_launches``
    where given), on the CPU :func:`fixed_counts_plain`."""
    if node.device.type == "cpu":
        return fixed_counts_plain(node, g, h, w, n_nodes)
    counts = torch.zeros((3, _EXP_BUCKETS), dtype=torch.int64,
                         device=node.device)
    if node.shape[-1] == 0:
        return counts
    from h2o3_tpu_torch.ops import _build
    with torch.cuda.device(node.device):
        _, err = _launch_fixed(_build.library(), p, None, node, g, h, w,
                               n_nodes, 1, None, _SCALE_ONLY, aux=counts)
    _build.check(err, "fixed scale counts launch")
    if counter is not None:
        with _LAUNCH_LOCK:
            counter.kernel_launches["scale_only"] += 1
    return counts


def fixed_acc(binned_T, node: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor, w: torch.Tensor, n_nodes: int,
              n_bins_tot: int, exps: torch.Tensor, bad: torch.Tensor,
              p: dict | None = None, counter=None) -> torch.Tensor:
    """The int64 accumulator [K, F, n_nodes*n_bins_tot, 3] of the active
    rows at the scale ``exps``/``bad`` (node/g/h [K, R]; ``binned_T`` None
    for the node totals, F = Bt = 1): on the card one launch of the fixed
    kernel's accumulator mode on plan ``p`` (counted in ``counter``), on
    the CPU :func:`fixed_acc_plain`."""
    K, R = node.shape
    F = 1 if binned_T is None else binned_T.shape[0]
    shape = (K, F, n_nodes * n_bins_tot, 3)
    if node.device.type == "cpu":
        bins = (torch.zeros((1, R), dtype=torch.int8, device=node.device)
                if binned_T is None else binned_T)
        return fixed_acc_plain(bins, node, g, h, w, n_nodes, n_bins_tot,
                               exps.tolist(), bad.tolist())
    if R == 0:
        return torch.zeros(shape, dtype=torch.int64, device=node.device)
    from h2o3_tpu_torch.ops import _build
    exps_in = torch.cat([exps, bad.to(torch.int64)]).to(torch.int32)
    with torch.cuda.device(node.device):
        scratch, err = _launch_fixed(
            _build.library(), p, binned_T, node, g, h, w, n_nodes,
            n_bins_tot, None, _TOTALS_ACC if binned_T is None else _ACC_OUT,
            aux=exps_in)
    _build.check(err, "fixed accumulator launch")
    if counter is not None:
        with _LAUNCH_LOCK:
            counter.kernel_launches["acc_out"] += 1
    return scratch[:K * F * n_nodes * n_bins_tot * 3].view(shape)


def mesh_plan(binned_T, node: torch.Tensor, n_nodes: int, n_bins_tot: int,
              qbits: int, min_qbits: int = 0) -> dict | None:
    """The fixed plan of this rank's block on the card at ``qbits`` bits a
    value (None on the CPU); ``binned_T`` None for the node totals."""
    if node.device.type == "cpu":
        return None
    K, R = node.shape
    F, bb = (1, 1) if binned_T is None else (binned_T.shape[0],
                                             binned_T.element_size())
    return _forced_qbits(_card_plan(node.device.index, max(R, 1), F,
                                    n_nodes, n_bins_tot, bb, K,
                                    min_qbits=min_qbits), qbits)


def _mesh_fixed(binned_T, node, g, h, w, n_nodes: int, n_bins_tot: int,
                qbits_of, counter, min_qbits: int = 0) -> torch.Tensor:
    """Histograms [K, F, N·Bt, 3] (``binned_T`` [F, R]) or node totals
    (``binned_T`` None) summed over the mesh by integer partials:
    ``qbits_of(R_global)`` the bits of the one-launch plan. Counts each
    kernel launch and all_reduce in ``counter``."""
    from h2o3_tpu_torch.parallel.distributed import all_reduce
    qbits = qbits_of(_global_rows(node.shape[-1]))
    p = mesh_plan(binned_T, node, n_nodes, n_bins_tot, qbits, min_qbits)
    counts = fixed_counts(node, g, h, w, n_nodes, p, counter)
    all_reduce(counts)
    counter.all_reduces += 1
    exps, bad = exponents_from_counts(counts, qbits)
    acc = fixed_acc(binned_T, node, g, h, w, n_nodes, n_bins_tot, exps, bad,
                    p, counter)
    all_reduce(acc)
    counter.all_reduces += 1
    return fixed_from_acc(acc, exps, bad)


def mesh_level_histograms(binned_T: torch.Tensor, node: torch.Tensor,
                          g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                          n_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """:func:`level_histograms` of all the mesh's rows from this rank's
    block (every rank calls it, in the same order), node/g/h as [K, R]:
    at a fixed-kernel level the integer sums above, bit for bit one
    launch's over all the rows at that launch's ``qbits``; at a
    global-kernel level this rank's float32 histograms, all_reduced. On the
    CPU the plain versions, the fixed one at :func:`fixed_needed_qbits` of
    the global rows."""
    from h2o3_tpu_torch.parallel.distributed import all_reduce
    _check(binned_T, node, g, h, w, n_nodes, n_bins_tot)
    F, R = binned_T.shape
    bb = binned_T.element_size()
    counter = mesh_level_histograms
    if node.dim() == 1:
        return mesh_level_histograms(binned_T, node[None], g[None], h[None],
                                     w, n_nodes, n_bins_tot)[0]
    K = node.shape[0]
    if _kernel_plan(F, n_nodes, n_bins_tot, bb, None, K)["kernel"] != "fixed":
        out = level_histograms(binned_T, node, g, h, w, n_nodes, n_bins_tot)
        all_reduce(out)
        counter.all_reduces += 1
        return out

    def qbits_of(rows: int) -> int:
        if binned_T.device.type == "cpu":
            return fixed_needed_qbits(rows, n_nodes, n_bins_tot)
        return _card_plan(binned_T.device.index, rows, F, n_nodes,
                          n_bins_tot, bb, K)["qbits"]

    return _mesh_fixed(binned_T, node, g, h, w, n_nodes, n_bins_tot,
                       qbits_of, counter)


mesh_level_histograms.kernel_launches = {"scale_only": 0, "acc_out": 0}
mesh_level_histograms.all_reduces = 0


def mesh_node_totals(node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     w: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """:func:`node_totals` of all the mesh's rows from this rank's block,
    [K, n_nodes, 3]: the node-totals instance's integer sums at the
    one-launch plan's ``qbits`` (``_TOTALS_QBITS`` on the CPU, as
    :func:`node_totals_fixed_plain`), summed over the ranks."""
    if node.dim() != 2:
        raise ValueError(f"node must be [K, R], got {tuple(node.shape)}")
    zeros = torch.empty((1, node.shape[1]), dtype=torch.int8,
                        device=node.device)
    _check(zeros, node, g, h, w, n_nodes, 1)
    K = node.shape[0]

    def qbits_of(rows: int) -> int:
        if node.device.type == "cpu":
            return _TOTALS_QBITS
        return _card_plan(node.device.index, rows, 1, n_nodes, 1, 1, K,
                          min_qbits=_TOTALS_QBITS)["qbits"]

    return _mesh_fixed(None, node, g, h, w, n_nodes, 1, qbits_of,
                       mesh_node_totals, _TOTALS_QBITS)[:, 0]


mesh_node_totals.kernel_launches = {"scale_only": 0, "acc_out": 0}
mesh_node_totals.all_reduces = 0
