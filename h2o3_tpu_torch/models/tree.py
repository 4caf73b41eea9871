"""Histogram tree grower — the port of ``h2o3_tpu/models/tree.py`` (numeric
splits).

Growth is level-synchronous over a dense heap (arrays indexed 2i+1/2i+2):
per level, one histogram build (the CUDA kernel of :mod:`h2o3_tpu_torch.ops.hist`
on the card), a vectorised cumsum+argmax split search over
[F, nodes, bins, direction], and a gather that routes rows to next-level
node ids. At level d >= 1 only the smaller child of each split is
histogrammed; its sibling is the parent's histogram minus the child's
(sibling subtraction). The reference's ``vmap`` over K trees is a K=1 call;
categorical group splits, monotone and interaction constraints and column
sampling are left for later slices.

Uses (g, h) gradient-pair stats with h = w for H2O GBM's mean-leaf
semantics, exactly as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h2o3_tpu_torch.ops.hist import level_histograms


@dataclasses.dataclass
class TreeParams:
    max_depth: int = 5
    nbins: int = 64              # regular bins; bin index nbins = missing
    min_rows: float = 10.0       # min sum of instance weights per child
    reg_lambda: float = 1.0      # L2 on leaf values
    reg_alpha: float = 0.0       # L1 on leaf values
    gamma: float = 0.0           # min split gain
    min_split_improvement: float = 1e-8


@dataclasses.dataclass
class Tree:
    """Dense heap tensors, length 2^(max_depth+1)-1."""
    feat: torch.Tensor         # int32, split feature (or -1)
    thresh_bin: torch.Tensor   # int32, go left if bin < thresh_bin
    thresh_val: torch.Tensor   # f32, go left if x < thresh_val (raw traversal)
    na_left: torch.Tensor      # bool, direction for missing values
    is_split: torch.Tensor     # bool
    leaf: torch.Tensor         # f32 leaf values (valid where !is_split)
    gain: torch.Tensor | None = None    # f32 split gain (0 at leaves)
    cover: torch.Tensor | None = None   # f32 sum of row weights through the node


#: heap fields in the order _grow_tree_device returns them
HEAP_FIELDS = ("feat", "thresh_bin", "thresh_val", "na_left", "is_split",
               "leaf", "gain", "cover")


def _histograms(binned_T, node_local, g, h, w, n_nodes: int, n_bins_tot: int):
    """Level histograms [F, n_nodes*n_bins_tot, 3]: the CUDA kernel on the
    card, its plain version on the CPU (reference ``_histograms``)."""
    return level_histograms(binned_T, node_local, g, h, w, n_nodes, n_bins_tot)


def _node_totals(node_local, g, h, w, n_nodes: int):
    """Per-node (G, H, W) sums — all the final level needs."""
    active = node_local >= 0
    ids = torch.where(active, node_local, 0).long()
    stats = torch.stack([torch.where(active, v, 0.0) for v in (g, h, w)], 1)
    out = torch.zeros((n_nodes, 3), dtype=torch.float32, device=g.device)
    return out.index_add_(0, ids, stats)


def _leaf_value(G, H, W, reg_lambda, reg_alpha):
    Gt = torch.sign(G) * torch.clamp(G.abs() - reg_alpha, min=0.0)
    return torch.where(W > 0, -Gt / torch.clamp(H + reg_lambda, min=1e-30), 0.0)


def _find_splits(hists, n_bins: int, min_rows, reg_lambda, reg_alpha, gamma,
                 feat_mask):
    """Vectorised split search (reference: DTree.findBestSplitPoint).

    hists: [F, N*(n_bins+1), 3]. Candidate split t in [1, n_bins-1]: bins < t
    go left; the missing bin (index n_bins) goes to the better direction.
    Returns per-node best (gain, feat, t, na_left, G, H, W, child values and
    weights, left-membership [N, n_bins])."""
    F = hists.shape[0]
    Bt = n_bins + 1
    N = hists.shape[1] // Bt
    hist4 = hists.reshape(F, N, Bt, 3)
    reg = hist4[:, :, :n_bins, :]                 # [F,N,B,3]
    na = hist4[:, :, n_bins, :]                   # [F,N,3]
    cum = torch.cumsum(reg, dim=2)                # [F,N,B,3]
    tot = cum[:, :, -1, :] + na                   # [F,N,3] (same for all f)
    G, H, W = tot[0, :, 0], tot[0, :, 1], tot[0, :, 2]

    GL = cum[:, :, : n_bins - 1, :]               # split t=b+1 → left = bins<=b
    # direction choice for missing values: [2, F, N, B-1, 3]
    GLd = torch.stack([GL + na[:, :, None, :], GL], dim=0)
    gl, hl, wl = GLd[..., 0], GLd[..., 1], GLd[..., 2]
    gr = G[None, None, :, None] - gl
    hr = H[None, None, :, None] - hl
    wr = W[None, None, :, None] - wl

    def half(gs, hs):
        # XGBoost leaf objective with L1: soft-threshold G by alpha
        gt = torch.sign(gs) * torch.clamp(gs.abs() - reg_alpha, min=0.0)
        return gt * gt / (hs + reg_lambda)

    parent = half(G, H)[None, None, :, None]
    gain = 0.5 * (half(gl, hl) + half(gr, hr) - parent) - gamma
    ok = (wl >= min_rows) & (wr >= min_rows) & feat_mask[None, :, None, None]
    vl = _leaf_value(gl, hl, wl, reg_lambda, reg_alpha)
    vr = _leaf_value(gr, hr, wr, reg_lambda, reg_alpha)
    gain = torch.where(ok, gain, -torch.inf)

    # the reference's flattening order [N, dir, F, B-1] and first argmax:
    # ties break identically
    flat = gain.permute(2, 0, 1, 3).reshape(N, -1)   # [N, 2*F*(B-1)]
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    na_left = best < F * (n_bins - 1)
    rem = best % (F * (n_bins - 1))
    best_feat = (rem // (n_bins - 1)).to(torch.int32)
    best_t = (rem % (n_bins - 1) + 1).to(torch.int32)
    nn = torch.arange(N, device=hists.device)
    dirs = torch.where(na_left, 0, 1)
    ix = (dirs, best_feat.long(), nn, (best_t - 1).long())
    vl_b, vr_b, wl_b, wr_b = vl[ix], vr[ix], wl[ix], wr[ix]
    member = torch.arange(n_bins, device=hists.device)[None, :] < best_t[:, None]
    return (best_gain, best_feat, best_t, na_left, G, H, W, vl_b, vr_b,
            wl_b, wr_b, member)


def _route_rows(binned, node_local, feat, member, na_left, do_split,
                n_bins: int):
    """Advance rows to next-level node ids (local: nl*2 + {0, 1}); rows of
    frozen (leaf) nodes get -1. ``binned`` is [rows, F]; ``member`` [N, B]
    is the left-membership of each bin at each node."""
    active = node_local >= 0
    nl = torch.where(active, node_local, 0).long()
    f = feat[nl].long()
    split = do_split[nl] & active
    b = binned.gather(1, f.clamp_min(0)[:, None])[:, 0].long()
    is_na = b >= n_bins
    left = torch.where(is_na, na_left[nl],
                       member[nl, b.clamp_max(n_bins - 1)])
    child = nl * 2 + torch.where(left, 0, 1)
    return torch.where(split, child, -1).to(torch.int32)


def _grow_tree_device(binned, binned_T, edges, g, h, w, feat_mask, depth: int,
                      n_bins: int, min_rows, reg_lambda, reg_alpha, gamma,
                      min_split_improvement):
    """Grow one whole tree; returns the heap tensors (``HEAP_FIELDS`` order)
    plus each row's leaf value (what boosting adds to the margins).

    ``binned`` [rows, F] and ``binned_T`` [F, rows] hold the same int8/int16
    bins (routing gathers rows, the histogram kernel reads features);
    ``edges`` [F, n_bins-1] float32; ``g``/``h``/``w`` [rows] float32;
    ``feat_mask`` [F] bool. Hyperparameters are Python floats: torch casts
    them to float32 inside each float32 op, the rounding the reference's
    traced float32 scalars get."""
    dev = g.device
    B = n_bins
    Bt = B + 1
    F = binned.shape[1]
    R = binned.shape[0]
    node_local = torch.zeros(R, dtype=torch.int32, device=dev)
    levels = {k: [] for k in HEAP_FIELDS}
    row_leaf = torch.zeros(R, dtype=torch.float32, device=dev)
    # sibling-subtraction state (reference ScoreBuildHistogram2 / gpu_hist
    # "hist subtraction trick")
    prev_hists = prev_do = chosen_left = None
    for d in range(depth):
        N = 2 ** d
        if d == 0:
            hists = _histograms(binned_T, node_local, g, h, w, N, Bt)
        else:
            P = N // 2
            # chosen child id per parent; rows elsewhere mask to -1
            chosen = (torch.arange(P, device=dev) * 2
                      + torch.where(chosen_left, 0, 1))
            act = node_local >= 0
            par = torch.where(act, node_local // 2, 0).long()
            at_chosen = act & (node_local == chosen[par])
            node_slot = torch.where(at_chosen, par, -1).to(torch.int32)
            part = _histograms(binned_T, node_slot, g, h, w, P, Bt)
            part4 = part.reshape(F, P, Bt, 3)
            prev4 = prev_hists.reshape(F, P, Bt, 3)
            # sibling by subtraction — only where the parent really split
            # (a frozen parent's children hold no rows; its stale histogram
            # must not leak into phantom nodes)
            other4 = torch.where(prev_do[None, :, None, None],
                                 prev4 - part4, 0.0)
            cl = chosen_left[None, :, None, None]
            left4 = torch.where(cl, part4, other4)
            right4 = torch.where(cl, other4, part4)
            hists = torch.stack([left4, right4], dim=2).reshape(F, N * Bt, 3)
        (gain, feat, t, na_left, G, H, W, vl_b, vr_b, wl_b, wr_b,
         member) = _find_splits(hists, B, min_rows, reg_lambda, reg_alpha,
                                gamma, feat_mask)
        prev_hists = hists
        chosen_left = wl_b <= wr_b
        do = (gain > min_split_improvement) & torch.isfinite(gain) & (W > 0)
        prev_do = do
        leaf = torch.where(do, 0.0, _leaf_value(G, H, W, reg_lambda, reg_alpha))
        lv_feat = torch.where(do, feat, -1).to(torch.int32)
        levels["feat"].append(lv_feat)
        levels["thresh_bin"].append(torch.where(do, t, 0).to(torch.int32))
        levels["thresh_val"].append(torch.where(
            do, edges[feat.long(), (t - 1).clamp_min(0).long()], 0.0))
        levels["na_left"].append(do & na_left)
        levels["is_split"].append(do)
        levels["leaf"].append(leaf)
        levels["gain"].append(torch.where(do, gain, 0.0))
        levels["cover"].append(W)
        # rows whose node froze at this level take its leaf value
        active = node_local >= 0
        nl = torch.where(active, node_local, 0).long()
        row_leaf = torch.where(active & ~do[nl], leaf[nl], row_leaf)
        node_local = _route_rows(binned, node_local, lv_feat, member,
                                 na_left, do, B)

    # final level: every surviving node is a leaf; only per-node totals
    N = 2 ** depth
    tot = _node_totals(node_local, g, h, w, N)
    leaf = _leaf_value(tot[:, 0], tot[:, 1], tot[:, 2], reg_lambda, reg_alpha)
    levels["feat"].append(torch.full((N,), -1, dtype=torch.int32, device=dev))
    levels["thresh_bin"].append(torch.zeros(N, dtype=torch.int32, device=dev))
    levels["thresh_val"].append(torch.zeros(N, dtype=torch.float32, device=dev))
    levels["na_left"].append(torch.zeros(N, dtype=torch.bool, device=dev))
    levels["is_split"].append(torch.zeros(N, dtype=torch.bool, device=dev))
    levels["leaf"].append(leaf)
    levels["gain"].append(torch.zeros(N, dtype=torch.float32, device=dev))
    levels["cover"].append(tot[:, 2])
    active = node_local >= 0
    nl = torch.where(active, node_local, 0).long()
    row_leaf = torch.where(active, leaf[nl], row_leaf)
    return tuple(torch.cat(levels[k]) for k in HEAP_FIELDS) + (row_leaf,)


def grow_tree(binned, binned_T, edges, g, h, w, params: TreeParams,
              feat_mask) -> tuple[Tree, torch.Tensor]:
    """Grow one tree; returns it and each training row's leaf value."""
    out = _grow_tree_device(
        binned, binned_T, edges, g, h, w, feat_mask, params.max_depth,
        params.nbins, float(params.min_rows), float(params.reg_lambda),
        float(params.reg_alpha), float(params.gamma),
        float(params.min_split_improvement))
    return Tree(**dict(zip(HEAP_FIELDS, out[:-1]))), out[-1]


def _stack(trees: list[Tree], attr: str) -> torch.Tensor:
    return torch.stack([getattr(t, attr) for t in trees])


def _heap_depth(heap_len: int) -> int:
    return int(np.log2(heap_len + 1)) - 1


def _walk_binned(binned, feat, t, na_l, is_sp, n_bins: int, depth: int):
    """Heap index reached by each row of one tree (global ids 2i+1/2i+2)."""
    idx = torch.zeros(binned.shape[0], dtype=torch.long, device=binned.device)
    for _ in range(depth):
        f = feat[idx].clamp_min(0).long()
        b = binned.gather(1, f[:, None])[:, 0]
        left = torch.where(b >= n_bins, na_l[idx], b < t[idx])
        nxt = idx * 2 + torch.where(left, 1, 2)
        idx = torch.where(is_sp[idx], nxt, idx)
    return idx


def predict_binned(binned, trees: list[Tree], n_bins: int) -> torch.Tensor:
    """Sum of leaf values over the trees, traversing binned features."""
    depth = _heap_depth(trees[0].feat.shape[0])
    acc = torch.zeros(binned.shape[0], dtype=torch.float32,
                      device=binned.device)
    for tr in trees:
        idx = _walk_binned(binned, tr.feat, tr.thresh_bin, tr.na_left,
                           tr.is_split, n_bins, depth)
        acc = acc + tr.leaf[idx]
    return acc


def fold_binned(binned, trees: list[Tree], n_bins: int, lr, F0) -> torch.Tensor:
    """Margins folded tree by tree: ``F = (((F0 + lr*l1) + lr*l2) + ...)`` —
    the boosting loop's exact float-addition order (``predict_binned``'s
    sum-then-scale differs by ulps)."""
    F0 = torch.as_tensor(F0, dtype=torch.float32, device=binned.device)
    if not trees:
        return F0
    depth = _heap_depth(trees[0].feat.shape[0])
    lr = float(lr)
    acc = F0.expand(binned.shape[0]) if F0.dim() == 0 else F0
    for tr in trees:
        idx = _walk_binned(binned, tr.feat, tr.thresh_bin, tr.na_left,
                           tr.is_split, n_bins, depth)
        acc = acc + lr * tr.leaf[idx]
    return acc


def _predict_raw_impl(X, feat_s, tv_s, na_s, sp_s, leaf_s) -> torch.Tensor:
    """Raw-value traversal for scoring new frames (threshold = edge value):
    stacked heaps [trees, heap], X [rows, F] float32 with NaN = missing."""
    rows = X.shape[0]
    depth = _heap_depth(feat_s.shape[1])
    acc = torch.zeros(rows, dtype=torch.float32, device=X.device)
    for feat, tv, na_l, is_sp, leaf in zip(feat_s, tv_s, na_s, sp_s, leaf_s):
        idx = torch.zeros(rows, dtype=torch.long, device=X.device)
        for _ in range(depth):
            f = feat[idx].clamp_min(0).long()
            x = X.gather(1, f[:, None])[:, 0]
            left = torch.where(torch.isnan(x), na_l[idx], x < tv[idx])
            nxt = idx * 2 + torch.where(left, 1, 2)
            idx = torch.where(is_sp[idx], nxt, idx)
        acc = acc + leaf[idx]
    return acc


def predict_raw(X, trees: list[Tree]) -> torch.Tensor:
    """Sum of leaf values over the trees for raw features X [rows, F]."""
    return _predict_raw_impl(X, _stack(trees, "feat"),
                             _stack(trees, "thresh_val"),
                             _stack(trees, "na_left"),
                             _stack(trees, "is_split"), _stack(trees, "leaf"))
