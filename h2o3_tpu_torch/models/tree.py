"""Histogram tree grower — the port of ``h2o3_tpu/models/tree.py`` (numeric
splits).

Growth is level-synchronous over a dense heap (arrays indexed 2i+1/2i+2):
per level, one histogram build (the CUDA kernel of :mod:`h2o3_tpu_torch.ops.hist`
on the card), a vectorised cumsum+argmax split search over
[F, nodes, bins, direction], and a gather that routes rows to next-level
node ids. At level d >= 1 only the smaller child of each split is
histogrammed; its sibling is the parent's histogram minus the child's
(sibling subtraction). The reference's ``vmap`` over the K class trees of a
round is a class axis written out (:func:`grow_trees_batched`): every
per-row and per-node array leads with K, and each level makes one histogram
call for all K trees; :func:`grow_tree` is the K = 1 case. With
``col_rate`` < 1 each level draws its own feature mask from an explicit
``torch.Generator``. Categorical features take group splits (bins ranked
per node by G/H, scanned as sorted prefixes; each tree then carries a
left-membership mask per node); monotone constraints reject violating
splits and clamp leaves into bounds that propagate down the heap, and
interaction constraints narrow the features each branch may split on.

Uses (g, h) gradient-pair stats with h = w for H2O GBM's mean-leaf
semantics, exactly as the reference does.

Each batched growth is the ``gbm:grow_batched`` site of the compute
observatory (:mod:`h2o3_tpu_torch.utils.costs`), rated by
:func:`grow_cost`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h2o3_tpu_torch.ops.hist import (hist_bytes, hist_flops,
                                     level_histograms, mesh_level_histograms,
                                     mesh_node_totals, node_totals,
                                     summed_over_mesh)
from h2o3_tpu_torch.utils.costs import accounted


def grow_cost(R: int, F: int, K: int, depth: int, n_bins: int,
              bin_bytes: int, w_per_class: bool = False) -> dict:
    """FLOPs and bytes of growing K trees of ``depth`` on R rows and F
    features, counted where the growth moves data: each level's histogram
    (the kernel's bound bytes, :func:`~h2o3_tpu_torch.ops.hist.hist_bytes`,
    for the nodes it histograms: 1 at level 0, 2^(d-1) at level d >= 1 by
    sibling subtraction; three adds per row and feature, every row counted
    active) and the final level's node totals (node ids, g, h and w read
    once, the [K, 2^depth, 3] totals written once, three adds a row). The
    split search and routing are left out. Returns ``flops``, ``bytes``
    and ``level_bytes`` (one entry per histogram level)."""
    Bt = n_bins + 1
    levels = [hist_bytes(R, F, 1 if d == 0 else 2 ** (d - 1), Bt,
                         bin_bytes, K, w_per_class) for d in range(depth)]
    totals = (K * R * 12 + (K if w_per_class else 1) * R * 4
              + K * (2 ** depth) * 3 * 4)
    flops = depth * K * hist_flops(R, F) + 3 * K * R
    return {"flops": float(flops), "bytes": float(sum(levels) + totals),
            "level_bytes": levels}


def _grow_site_cost(args, statics) -> tuple[float, float]:
    binned, g, w = args
    c = grow_cost(binned.shape[0], binned.shape[1], g.shape[0],
                  statics["depth"], statics["n_bins"],
                  binned.element_size(), w.dim() == 2)
    return c["flops"], c["bytes"]


#: the batched tree growth as a site of the compute observatory
GROW_SITE = accounted("gbm:grow_batched", _grow_site_cost, loop="gbm_grow")


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
    # [heap, B] bool, the bins routed left at each node: only in models with
    # categorical features (group splits); numeric-only trees route by
    # thresh_bin / thresh_val alone
    left_mask: torch.Tensor | None = None


#: heap fields in the order _grow_tree_device returns them
HEAP_FIELDS = ("feat", "thresh_bin", "thresh_val", "na_left", "is_split",
               "leaf", "gain", "cover")


def _histograms(binned_T, node_local, g, h, w, n_nodes: int, n_bins_tot: int):
    """Level histograms [K, F, n_nodes*n_bins_tot, 3] of K class trees in one
    call: the CUDA kernel on the card, its plain version on the CPU
    (reference ``_histograms`` under ``vmap``); across the ranks of a mesh,
    every rank's rows summed (the reference's ``_level_histograms_fused``:
    shard-local sums, then one psum)."""
    if summed_over_mesh(binned_T.device):
        return mesh_level_histograms(binned_T, node_local, g, h, w, n_nodes,
                                     n_bins_tot)
    return level_histograms(binned_T, node_local, g, h, w, n_nodes, n_bins_tot)


def _node_totals(node_local, g, h, w, n_nodes: int):
    """Per-node (G, H, W) sums [K, n_nodes, 3] of K trees — all the final
    level needs: the node-totals instance of the fixed kernel on the card
    (integer sums, the same bits every run), one ``index_add_`` on the
    CPU; across the ranks of a mesh, every rank's rows summed."""
    if summed_over_mesh(node_local.device):
        return mesh_node_totals(node_local, g, h, w, n_nodes)
    return node_totals(node_local, g, h, w, n_nodes)


def _leaf_value(G, H, W, reg_lambda, reg_alpha):
    Gt = torch.sign(G) * torch.clamp(G.abs() - reg_alpha, min=0.0)
    return torch.where(W > 0, -Gt / torch.clamp(H + reg_lambda, min=1e-30), 0.0)


def _find_splits(hists, n_bins: int, min_rows, reg_lambda, reg_alpha, gamma,
                 feat_mask, mono=None, allowed=None, cat_feats=None):
    """Vectorised split search (reference: DTree.findBestSplitPoint).

    hists: [F, N*(n_bins+1), 3]. Candidate split t in [1, n_bins-1]: bins < t
    go left; the missing bin (index n_bins) goes to the better direction.
    ``feat_mask`` is [F], or [N, F] for a mask per node (the class trees of a
    batch, each with its own level mask, searched as one level).
    ``mono`` [F] in {-1, 0, 1} rejects splits whose child values break the
    feature's direction (the caller clamps leaves into propagated bounds);
    ``allowed`` [N, F] masks the features an interaction-constrained branch
    may split on; ``cat_feats`` [F] bool marks categorical features, whose
    candidates are group splits: bins ranked per node by G/H (empty bins
    last, ties in bin order) and scanned as sorted prefixes.
    Returns per-node best (gain, feat, t, na_left, G, H, W, child values and
    weights, left-membership [N, n_bins])."""
    flat, (G, H, W), (vl, vr, wl, wr), rank = _candidate_gains(
        hists, n_bins, min_rows, reg_lambda, reg_alpha, gamma, feat_mask,
        mono, allowed, cat_feats)
    F = hists.shape[0]
    N = flat.shape[0]
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
    if cat_feats is not None:
        # a categorical split's left group: the bins ranked in the prefix
        member = torch.where(cat_feats[best_feat.long()][:, None],
                             rank[best_feat.long(), nn] < best_t[:, None],
                             member)
    return (best_gain, best_feat, best_t, na_left, G, H, W, vl_b, vr_b,
            wl_b, wr_b, member)


def tied_splits(hists, n_bins: int, min_rows, reg_lambda, reg_alpha, gamma,
                feat_mask, mono=None, allowed=None, cat_feats=None):
    """[N] True at the nodes where more than one candidate split attains
    the best gain exactly, in :func:`_find_splits`' own arithmetic: such a
    node has no one right split, and the last bits of its sums pick one
    (arguments as :func:`_find_splits`')."""
    flat = _candidate_gains(hists, n_bins, min_rows, reg_lambda, reg_alpha,
                            gamma, feat_mask, mono, allowed, cat_feats)[0]
    best = flat.max(dim=1).values
    return ((flat == best[:, None]).sum(1) > 1) & torch.isfinite(best)


def _candidate_gains(hists, n_bins: int, min_rows, reg_lambda, reg_alpha,
                     gamma, feat_mask, mono, allowed, cat_feats):
    """Every candidate's gain [N, 2*F*(n_bins-1)] in the reference's
    flattening order [N, dir, F, B-1] (-inf where not allowed), the node
    totals (G, H, W), the child values and weights [2, F, N, B-1] (vl, vr,
    wl, wr) and, with ``cat_feats``, each bin's rank per feature and
    node."""
    F = hists.shape[0]
    Bt = n_bins + 1
    N = hists.shape[1] // Bt
    hist4 = hists.reshape(F, N, Bt, 3)
    reg = hist4[:, :, :n_bins, :]                 # [F,N,B,3]
    na = hist4[:, :, n_bins, :]                   # [F,N,3]
    cum = torch.cumsum(reg, dim=2)                # [F,N,B,3]
    rank = None
    if cat_feats is not None:
        # rank bins by mean gradient; empty bins sort last, so prefixes
        # take occupied categories first (jnp.argsort is stable: so here)
        ratio = reg[..., 0] / torch.clamp(reg[..., 1], min=1e-12)
        ratio = torch.where(reg[..., 2] > 0, ratio, torch.inf)
        order = torch.argsort(ratio, dim=2, stable=True)        # [F,N,B]
        cum_sorted = torch.cumsum(
            torch.take_along_dim(reg, order[..., None], dim=2), dim=2)
        rank = torch.argsort(order, dim=2)                      # bin -> rank
        cum = torch.where(cat_feats[:, None, None, None], cum_sorted, cum)
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
    if allowed is not None:
        feat_mask = allowed & (feat_mask if feat_mask.dim() == 2
                               else feat_mask[None, :])
    fm = (feat_mask[None, :, None, None] if feat_mask.dim() == 1
          else feat_mask.T[None, :, :, None])
    ok = (wl >= min_rows) & (wr >= min_rows) & fm
    vl = _leaf_value(gl, hl, wl, reg_lambda, reg_alpha)
    vr = _leaf_value(gr, hr, wr, reg_lambda, reg_alpha)
    if mono is not None:
        m = mono[None, :, None, None]
        ok = ok & ~(((m > 0) & (vl > vr)) | ((m < 0) & (vl < vr)))
    gain = torch.where(ok, gain, -torch.inf)
    # the reference's flattening order and first argmax: ties break alike
    flat = gain.permute(2, 0, 1, 3).reshape(N, -1)   # [N, 2*F*(B-1)]
    return flat, (G, H, W), (vl, vr, wl, wr), rank


def _route_rows(binned, node_local, feat, member, na_left, do_split,
                n_bins: int):
    """Advance rows to next-level node ids (local: nl*2 + {0, 1}); rows of
    frozen (leaf) nodes get -1. ``binned`` is [rows, F]; ``member`` [N, B]
    is the left-membership of each bin at each node. A class batch passes
    ``node_local`` [K, rows] and ``feat``/``na_left``/``do_split`` [K, N],
    ``member`` [K, N, B]."""
    if node_local.dim() == 1:
        return _route_rows(binned, node_local[None], feat[None], member[None],
                           na_left[None], do_split[None], n_bins)[0]
    active = node_local >= 0
    nl = torch.where(active, node_local, 0).long()
    f = feat.gather(1, nl).long()
    split = do_split.gather(1, nl) & active
    # [rows, K] gather of each row's split feature, back to [K, rows]
    b = binned.gather(1, f.clamp_min(0).T).T.contiguous().long()
    is_na = b >= n_bins
    cls = torch.arange(node_local.shape[0], device=nl.device)[:, None]
    left = torch.where(is_na, na_left.gather(1, nl),
                       member[cls, nl, b.clamp_max(n_bins - 1)])
    child = nl * 2 + torch.where(left, 0, 1)
    return torch.where(split, child, -1).to(torch.int32)


def _level_feat_mask(feat_mask, col_rate: float, generator):
    """Per-level column sampling (reference ``_grow_tree_device``): each
    tree's features pass with probability ``col_rate``, one drawn feature is
    forced in BEFORE the draw is intersected with ``feat_mask`` [K, F], and
    a tree whose mask comes out empty keeps ``feat_mask``."""
    K, F = feat_mask.shape
    dev = feat_mask.device
    sub = torch.rand((K, F), generator=generator, device=dev) < col_rate
    forced = torch.randint(0, F, (K,), generator=generator, device=dev)
    # a scatter, where indexed assignment would wait for the card
    sub.scatter_(1, forced[:, None], True)
    m = feat_mask & sub
    return torch.where(m.any(1, keepdim=True), m, feat_mask)


def _grow_batched(binned, binned_T, edges, g, h, w, feat_mask, depth: int,
                  n_bins: int, min_rows, reg_lambda, reg_alpha, gamma,
                  min_split_improvement, col_rate: float = 1.0,
                  generator: torch.Generator | None = None, mono=None,
                  reach=None, cat_feats=None):
    """Grow K whole trees, one per row of ``g``/``h`` [K, rows]; returns
    the heap tensors [K, heap] (``HEAP_FIELDS`` order), then, with
    ``cat_feats``, the left-membership masks [K, heap, n_bins], then each
    row's leaf value [K, rows] (what boosting adds to the margins).

    ``mono`` [F] int monotone directions: each class tree's child bounds
    [K, N, 2] propagate down from the split midpoints and its leaves clamp
    into them. ``reach`` [F, F] bool: below a split on f only features
    with ``reach[f]`` may split (each tree's allowed sets [K, N, F]).
    ``cat_feats`` [F] bool: categorical features take group splits.

    ``binned`` [rows, F] and ``binned_T`` [F, rows] hold the same int8/int16
    bins (routing gathers rows, the histogram kernel reads features);
    ``edges`` [F, n_bins-1] float32; ``w`` [K, rows], or [rows] shared by
    the K trees; ``feat_mask`` [F] or [K, F] bool. ``col_rate`` < 1 draws a
    feature mask per tree and level from ``generator`` (on the tensors'
    device). Hyperparameters are Python floats: torch casts them to float32
    inside each float32 op, the rounding the reference's traced float32
    scalars get."""
    with GROW_SITE.dispatch((binned, g, w),
                            {"depth": depth, "n_bins": n_bins}):
        return _grow_batched_body(
            binned, binned_T, edges, g, h, w, feat_mask, depth, n_bins,
            min_rows, reg_lambda, reg_alpha, gamma, min_split_improvement,
            col_rate, generator, mono, reach, cat_feats)


def _grow_batched_body(binned, binned_T, edges, g, h, w, feat_mask, depth,
                       n_bins, min_rows, reg_lambda, reg_alpha, gamma,
                       min_split_improvement, col_rate, generator, mono,
                       reach, cat_feats):
    dev = g.device
    B = n_bins
    Bt = B + 1
    K, R = g.shape
    F = binned.shape[1]
    if feat_mask.dim() == 1:
        feat_mask = feat_mask.expand(K, F)
    node_local = torch.zeros((K, R), dtype=torch.int32, device=dev)
    levels = {k: [] for k in HEAP_FIELDS + ("left_mask",)}
    bounds = (torch.tensor([-torch.inf, torch.inf], device=dev)
              .expand(K, 1, 2) if mono is not None else None)
    allowed = (torch.ones((K, 1, F), dtype=torch.bool, device=dev)
               if reach is not None else None)
    row_leaf = torch.zeros((K, R), dtype=torch.float32, device=dev)
    # sibling-subtraction state (reference ScoreBuildHistogram2 / gpu_hist
    # "hist subtraction trick"), per class
    prev_hists = prev_do = chosen_left = None
    for d in range(depth):
        N = 2 ** d
        lmask = (feat_mask if col_rate >= 1.0
                 else _level_feat_mask(feat_mask, col_rate, generator))
        if d == 0:
            hists = _histograms(binned_T, node_local, g, h, w, N, Bt)
        else:
            P = N // 2
            # chosen child id per parent; rows elsewhere mask to -1
            chosen = (torch.arange(P, device=dev) * 2
                      + torch.where(chosen_left, 0, 1))
            act = node_local >= 0
            par = torch.where(act, node_local // 2, 0).long()
            at_chosen = act & (node_local == chosen.gather(1, par))
            node_slot = torch.where(at_chosen, par, -1).to(torch.int32)
            part = _histograms(binned_T, node_slot, g, h, w, P, Bt)
            part4 = part.reshape(K, F, P, Bt, 3)
            prev4 = prev_hists.reshape(K, F, P, Bt, 3)
            # sibling by subtraction — only where the parent really split
            # (a frozen parent's children hold no rows; its stale histogram
            # must not leak into phantom nodes)
            other4 = torch.where(prev_do[:, None, :, None, None],
                                 prev4 - part4, 0.0)
            cl = chosen_left[:, None, :, None, None]
            left4 = torch.where(cl, part4, other4)
            right4 = torch.where(cl, other4, part4)
            del part, part4, prev4, other4
            hists = torch.stack([left4, right4], dim=3).reshape(K, F, N * Bt, 3)
            del left4, right4
        # the K trees' N nodes searched as one level of K*N nodes, each
        # with its tree's feature mask (per class, the reference's order)
        flat = hists.reshape(K, F, N * Bt, 3).transpose(0, 1).reshape(
            F, K * N * Bt, 3)
        mask = lmask[0] if K == 1 else lmask.repeat_interleave(N, 0)
        split = _find_splits(flat, B, min_rows, reg_lambda, reg_alpha, gamma,
                             mask, mono=mono,
                             allowed=None if allowed is None
                             else allowed.reshape(K * N, F),
                             cat_feats=cat_feats)
        del flat
        (gain, feat, t, na_left, G, H, W, vl_b, vr_b, wl_b, wr_b) = (
            a.reshape(K, N) for a in split[:-1])
        member = split[-1].reshape(K, N, B)
        prev_hists = hists
        chosen_left = wl_b <= wr_b
        do = (gain > min_split_improvement) & torch.isfinite(gain) & (W > 0)
        prev_do = do
        leaf = torch.where(do, 0.0, _clamp(
            _leaf_value(G, H, W, reg_lambda, reg_alpha), bounds))
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
        if cat_feats is not None:
            levels["left_mask"].append(member & do[..., None])
        # rows whose node froze at this level take its leaf value
        active = node_local >= 0
        nl = torch.where(active, node_local, 0).long()
        row_leaf = torch.where(active & ~do.gather(1, nl), leaf.gather(1, nl),
                               row_leaf)
        node_local = _route_rows(binned, node_local, lv_feat, member,
                                 na_left, do, B)
        if bounds is not None:
            # monotone bound propagation: the split's midpoint bounds its
            # children (0 where unconstrained or not split)
            lo, hi = bounds[..., 0], bounds[..., 1]
            mid = torch.minimum(torch.maximum(0.5 * (vl_b + vr_b), lo), hi)
            c = mono[feat.long()] * do
            bounds = torch.stack([
                torch.stack([torch.where(c < 0, mid, lo),
                             torch.where(c > 0, mid, hi)], -1),
                torch.stack([torch.where(c > 0, mid, lo),
                             torch.where(c < 0, mid, hi)], -1)],
                dim=2).reshape(K, 2 * N, 2)
        if allowed is not None:
            child = torch.where(do[..., None], allowed & reach[feat.long()],
                                allowed)
            allowed = child.repeat_interleave(2, dim=1)
    del prev_hists

    # final level: every surviving node is a leaf; only per-node totals
    N = 2 ** depth
    tot = _node_totals(node_local, g, h, w, N)
    leaf = _clamp(_leaf_value(tot[..., 0], tot[..., 1], tot[..., 2],
                              reg_lambda, reg_alpha), bounds)
    levels["feat"].append(torch.full((K, N), -1, dtype=torch.int32, device=dev))
    levels["thresh_bin"].append(torch.zeros((K, N), dtype=torch.int32,
                                            device=dev))
    levels["thresh_val"].append(torch.zeros((K, N), dtype=torch.float32,
                                            device=dev))
    levels["na_left"].append(torch.zeros((K, N), dtype=torch.bool, device=dev))
    levels["is_split"].append(torch.zeros((K, N), dtype=torch.bool, device=dev))
    levels["leaf"].append(leaf)
    levels["gain"].append(torch.zeros((K, N), dtype=torch.float32, device=dev))
    levels["cover"].append(tot[..., 2])
    if cat_feats is not None:
        levels["left_mask"].append(torch.zeros((K, N, B), dtype=torch.bool,
                                               device=dev))
    active = node_local >= 0
    nl = torch.where(active, node_local, 0).long()
    row_leaf = torch.where(active, leaf.gather(1, nl), row_leaf)
    out = tuple(torch.cat(levels[k], dim=1) for k in HEAP_FIELDS)
    if cat_feats is not None:
        out += (torch.cat(levels["left_mask"], dim=1),)
    return out + (row_leaf,)


def _clamp(v, bounds):
    """Leaf values into their nodes' monotone bounds [..., 2] (jnp.clip)."""
    if bounds is None:
        return v
    return torch.minimum(torch.maximum(v, bounds[..., 0]), bounds[..., 1])


def _grow_tree_device(binned, binned_T, edges, g, h, w, feat_mask, depth: int,
                      n_bins: int, min_rows, reg_lambda, reg_alpha, gamma,
                      min_split_improvement, col_rate: float = 1.0,
                      generator: torch.Generator | None = None, mono=None,
                      reach=None, cat_feats=None):
    """Grow one whole tree (the K = 1 case of :func:`_grow_batched`):
    ``g``/``h``/``w`` [rows], ``feat_mask`` [F]; returns the heap tensors
    (``HEAP_FIELDS`` order), the left masks with ``cat_feats``, then each
    row's leaf value."""
    out = _grow_batched(binned, binned_T, edges, g[None], h[None], w,
                        feat_mask, depth, n_bins, min_rows, reg_lambda,
                        reg_alpha, gamma, min_split_improvement, col_rate,
                        generator, mono=mono, reach=reach,
                        cat_feats=cat_feats)
    return tuple(a[0] for a in out)


def grow_trees_batched(binned, binned_T, edges, g, h, w, params: TreeParams,
                       feat_mask, col_rate: float = 1.0,
                       generator: torch.Generator | None = None, mono=None,
                       reach=None, cat_feats=None
                       ) -> tuple[list[Tree], torch.Tensor]:
    """Grow K trees (leading axis of ``g``/``h``, and of ``w`` unless it is
    one row for all) with one histogram call per level; returns the trees
    and each tree's training-row leaf values [K, rows]. ``col_rate`` < 1
    resamples each tree's feature mask every level from ``generator``;
    ``mono``, ``reach`` and ``cat_feats`` as in :func:`_grow_batched`."""
    out = _grow_batched(
        binned, binned_T, edges, g, h, w, feat_mask, params.max_depth,
        params.nbins, float(params.min_rows), float(params.reg_lambda),
        float(params.reg_alpha), float(params.gamma),
        float(params.min_split_improvement), float(col_rate), generator,
        mono=mono, reach=reach, cat_feats=cat_feats)
    masks = out[len(HEAP_FIELDS)] if cat_feats is not None else None
    trees = [Tree(**{f: a[k] for f, a in zip(HEAP_FIELDS, out)},
                  left_mask=None if masks is None else masks[k])
             for k in range(g.shape[0])]
    return trees, out[-1]


def grow_tree(binned, binned_T, edges, g, h, w, params: TreeParams,
              feat_mask, col_rate: float = 1.0,
              generator: torch.Generator | None = None, mono=None,
              reach=None, cat_feats=None) -> tuple[Tree, torch.Tensor]:
    """Grow one tree (K = 1 batched growth); returns it and each training
    row's leaf value."""
    trees, preds = grow_trees_batched(binned, binned_T, edges, g[None],
                                      h[None], w, params, feat_mask,
                                      col_rate, generator, mono=mono,
                                      reach=reach, cat_feats=cat_feats)
    return trees[0], preds[0]


def _stack(trees: list[Tree], attr: str) -> torch.Tensor:
    return torch.stack([getattr(t, attr) for t in trees])


def _heap_depth(heap_len: int) -> int:
    return int(np.log2(heap_len + 1)) - 1


def _walk_binned(binned, tree: Tree, n_bins: int, depth: int):
    """Heap index reached by each row of one tree (global ids 2i+1/2i+2),
    by threshold or, in a group-split tree, by the left masks."""
    idx = torch.zeros(binned.shape[0], dtype=torch.long, device=binned.device)
    feat, na_l, is_sp = tree.feat, tree.na_left, tree.is_split
    for _ in range(depth):
        f = feat[idx].clamp_min(0).long()
        b = binned.gather(1, f[:, None])[:, 0].long()
        inner = (tree.left_mask[idx, b.clamp_max(n_bins - 1)]
                 if tree.left_mask is not None else b < tree.thresh_bin[idx])
        left = torch.where(b >= n_bins, na_l[idx], inner)
        nxt = idx * 2 + torch.where(left, 1, 2)
        idx = torch.where(is_sp[idx], nxt, idx)
    return idx


def predict_binned(binned, trees: list[Tree], n_bins: int) -> torch.Tensor:
    """Sum of leaf values over the trees, traversing binned features."""
    depth = _heap_depth(trees[0].feat.shape[0])
    acc = torch.zeros(binned.shape[0], dtype=torch.float32,
                      device=binned.device)
    for tr in trees:
        acc = acc + tr.leaf[_walk_binned(binned, tr, n_bins, depth)]
    return acc


def fold_binned(binned, trees: list[Tree], n_bins: int, lr, F0) -> torch.Tensor:
    """Margins folded tree by tree: ``F = (((F0 + lr*l1) + lr*l2) + ...)`` —
    the boosting loop's exact float-addition order (``predict_binned``'s
    sum-then-scale differs by ulps), so a checkpoint resume seeded from it
    grows the uninterrupted run's remaining trees bit for bit."""
    F0 = torch.as_tensor(F0, dtype=torch.float32, device=binned.device)
    if not trees:
        return F0
    depth = _heap_depth(trees[0].feat.shape[0])
    lr = float(lr)
    acc = F0.expand(binned.shape[0]) if F0.dim() == 0 else F0
    for tr in trees:
        acc = acc + lr * tr.leaf[_walk_binned(binned, tr, n_bins, depth)]
    return acc


def cat_bins_for_codes(X, cat_card, n_bins: int) -> torch.Tensor:
    """Raw categorical codes [rows, F] (NaN = missing) to histogram bins:
    the code where the cardinality fits ``n_bins``, else contiguous ranges
    of ``code * n_bins // card`` (the reference's nbins_cats grouping)."""
    code = torch.nan_to_num(X, nan=0.0).to(torch.int32)
    card = cat_card.clamp_min(1)[None, :]
    grouped = (code * n_bins) // card
    return torch.where(cat_card[None, :] > n_bins,
                       grouped.clamp(0, n_bins - 1),
                       code.clamp(0, n_bins - 1)).to(torch.int32)


def _predict_raw_impl(X, trees: list[Tree], cat_card=None,
                      n_bins: int = 0) -> torch.Tensor:
    """Raw-value traversal for scoring new frames, X [rows, F] float32 with
    NaN = missing: numeric features go left below the edge threshold;
    with ``cat_card`` [F] (> 0 for a categorical feature, a group-split
    model), categorical codes go left where their bin is in the node's
    left mask."""
    rows = X.shape[0]
    depth = _heap_depth(trees[0].feat.shape[0])
    cat_bin = (cat_bins_for_codes(X, cat_card, n_bins).long()
               if cat_card is not None else None)
    acc = torch.zeros(rows, dtype=torch.float32, device=X.device)
    for tr in trees:
        feat, tv, na_l, is_sp = tr.feat, tr.thresh_val, tr.na_left, tr.is_split
        idx = torch.zeros(rows, dtype=torch.long, device=X.device)
        for _ in range(depth):
            f = feat[idx].clamp_min(0).long()
            x = X.gather(1, f[:, None])[:, 0]
            inner = x < tv[idx]
            if cat_bin is not None:
                b = cat_bin.gather(1, f[:, None])[:, 0].clamp(0, n_bins - 1)
                inner = torch.where(cat_card[f] > 0, tr.left_mask[idx, b],
                                    inner)
            left = torch.where(torch.isnan(x), na_l[idx], inner)
            nxt = idx * 2 + torch.where(left, 1, 2)
            idx = torch.where(is_sp[idx], nxt, idx)
        acc = acc + tr.leaf[idx]
    return acc


def predict_raw(X, trees: list[Tree], cat_card=None,
                n_bins: int = 0) -> torch.Tensor:
    """Sum of leaf values over the trees for raw features X [rows, F]; a
    group-split model passes its categorical cardinalities and category
    bins (``cat_card``, ``n_bins``)."""
    if trees[0].left_mask is None:
        cat_card = None
    return _predict_raw_impl(X, trees, cat_card, n_bins)
