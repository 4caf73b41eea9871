"""Level histograms of tree growth — the port of ``h2o3_tpu/ops/pallas_hist.py``.

For every feature f, node n < N and bin b < Bt::

    hist[f, n*Bt + b, :] = sum over rows r with node[r] == n and
                           min(bin[f, r], Bt - 1) == b of (g[r], h[r], w[r])

Rows at node -1 add nothing. :func:`level_histograms_plain` is the plain
PyTorch version (the same function as the JAX reference's
``models/tree.py:_level_histograms``); :func:`level_histograms` launches the
hand-written CUDA kernel ``csrc/hist.cu`` on CUDA tensors and takes the plain
version only for tensors on the CPU. ``level_histograms.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

#: shared memory one block may hold for its slab: two such blocks fit on an
#: SM (228 KB), and a slab above 48 KB is opted in by the C entry point
_SMEM_BUDGET = 96 * 1024
#: largest dynamic shared memory of one block on Hopper
_SMEM_MAX = 227 * 1024
#: blocks to aim for per launch: 16 per SM of the H100's 132
_TARGET_BLOCKS = 132 * 16
#: fewest rows per block, so that zeroing and flushing a slab stay small
#: beside counting rows into it
_MIN_ROWS_PER_BLOCK = 4096
#: CUDA's limit on grid dimensions y and z
_GRID_YZ_MAX = 65535


def level_histograms_plain(binned_T: torch.Tensor, node: torch.Tensor,
                           g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                           n_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[F, n_nodes*n_bins_tot, 3] float32 histograms of (g, h, w), built
    feature by feature with ``index_add_`` (the reference scans features
    with one ``segment_sum`` per stat)."""
    F = binned_T.shape[0]
    active = node >= 0
    base = torch.where(active, node.long() * n_bins_tot, 0)
    stats = torch.stack([torch.where(active, v, 0.0) for v in (g, h, w)], 1)
    out = torch.zeros((F, n_nodes * n_bins_tot, 3), dtype=torch.float32,
                      device=binned_T.device)
    for f in range(F):
        b = binned_T[f].long()
        keep = active & (b >= 0)     # the kernel skips negative bins too
        ids = base + b.clamp_max(n_bins_tot - 1)
        out[f].index_add_(0, ids[keep], stats[keep])
    return out


def _plan(R: int, F: int, n_nodes: int, n_bins_tot: int) -> dict:
    """Launch shape: nodes per block (from the shared-memory budget), node
    blocks, row chunks and rows per block, and the slab's bytes."""
    per_node = n_bins_tot * 3 * 4
    if per_node > _SMEM_MAX:
        raise ValueError(f"{n_bins_tot} bins per node need {per_node} bytes "
                         f"of shared memory; a block has {_SMEM_MAX}")
    nb = min(n_nodes, max(1, _SMEM_BUDGET // per_node))
    n_node_blocks = -(-n_nodes // nb)
    if n_node_blocks > _GRID_YZ_MAX:
        raise ValueError(f"{n_nodes} nodes need {n_node_blocks} node blocks; "
                         f"the grid allows {_GRID_YZ_MAX}")
    want = max(1, -(-_TARGET_BLOCKS // (F * n_node_blocks)))
    rows = max(-(-R // want), _MIN_ROWS_PER_BLOCK, nb * n_bins_tot * 3)
    rows = max(rows, -(-R // _GRID_YZ_MAX))
    return dict(nodes_per_block=nb, node_blocks=n_node_blocks,
                chunks=max(1, -(-R // rows)), rows_per_block=rows,
                smem_bytes=nb * per_node)


def _check(binned_T, node, g, h, w, n_nodes, n_bins_tot) -> None:
    """Raise on anything the kernel does not take."""
    if binned_T.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"binned_T must be int8 or int16, got {binned_T.dtype}")
    if binned_T.dim() != 2:
        raise ValueError(f"binned_T must be [F, R], got {tuple(binned_T.shape)}")
    F, R = binned_T.shape
    if node.dtype != torch.int32 or tuple(node.shape) != (R,):
        raise TypeError(f"node must be int32 [{R}], got {node.dtype} "
                        f"{tuple(node.shape)}")
    for name, v in (("g", g), ("h", h), ("w", w)):
        if v.dtype != torch.float32 or tuple(v.shape) != (R,):
            raise TypeError(f"{name} must be float32 [{R}], got {v.dtype} "
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


def level_histograms(binned_T: torch.Tensor, node: torch.Tensor,
                     g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                     n_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[F, n_nodes*n_bins_tot, 3] level histograms.

    ``binned_T`` [F, R] int8/int16, ``node`` [R] int32 (-1 = inactive),
    ``g``/``h``/``w`` [R] float32, all contiguous on one device. On a CUDA
    device this launches ``csrc/hist.cu`` (or raises); on the CPU it is
    :func:`level_histograms_plain`."""
    _check(binned_T, node, g, h, w, n_nodes, n_bins_tot)
    if binned_T.device.type == "cpu":
        return level_histograms_plain(binned_T, node, g, h, w, n_nodes,
                                      n_bins_tot)
    if binned_T.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {binned_T.device}")
    F, R = binned_T.shape
    out = torch.zeros((F, n_nodes * n_bins_tot, 3), dtype=torch.float32,
                      device=binned_T.device)
    if R == 0:
        return out
    from h2o3_tpu_torch.ops import _build
    lib = _build.library()
    p = _plan(R, F, n_nodes, n_bins_tot)
    with torch.cuda.device(binned_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.h2o3_level_hist(
            binned_T.data_ptr(), binned_T.element_size(), node.data_ptr(),
            g.data_ptr(), h.data_ptr(), w.data_ptr(), out.data_ptr(), R, F,
            n_nodes, n_bins_tot, p["nodes_per_block"], p["chunks"],
            p["rows_per_block"], p["smem_bytes"], stream)
    _build.check(err, "level histogram kernel launch")
    level_histograms.launches += 1
    return out


level_histograms.launches = 0


def hist_bytes(R: int, F: int, n_nodes: int, n_bins_tot: int,
               bin_bytes: int) -> int:
    """Bytes the function must move: each input read once (bins, node,
    g/h/w), the output written once."""
    return (R * F * bin_bytes + R * 4 + R * 12
            + F * n_nodes * n_bins_tot * 3 * 4)


def hist_flops(active_rows: int, F: int) -> int:
    """Float adds the function needs: three per active row and feature."""
    return 3 * active_rows * F
