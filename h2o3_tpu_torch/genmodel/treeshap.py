"""Exact TreeSHAP contributions of dense-heap trees, path by path on the
device — the port of ``h2o3_tpu/genmodel/treeshap.py``.

The reference replays Lundberg and Lee's recursion node by node on the
host (EXTEND on the way down, UNWIND at each leaf), carrying [rows]
float64 arrays. Here every root-to-leaf path of the ensemble is one row
of a batch (the path-batched form of GPUTreeShap, Mitchell et al. 2022).
A feature that recurs on a path merges into one element whose zero
fraction is the product of its cover fractions and whose one fraction is
the AND of its decisions: EXTEND's weights depend only on the multiset of
(zero, one) pairs, so this equals the reference's unwind-then-extend.

Along a path the zero fractions are the tree's own, and a row's one
fractions are 0 or 1. So a path of L elements has at most 2^L distinct
inputs, and a table [paths, L, 2^L] of each element's contribution (the
leaf value times its unwound weight sum times (one - zero)) serves every
row: the rows then only compute each path's bit pattern (which elements
the row follows) and gather. Where a path's 2^L patterns outnumber the
rows, the same arithmetic runs on the rows' own patterns instead. Sums
are float64, as the reference's; split decisions compare float32 raw
values against float32 thresholds, as scoring does, and group-split
nodes route a categorical code through its bin's left mask
(:func:`~h2o3_tpu_torch.models.tree.cat_bins_for_codes`).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.models.tree import Tree, cat_bins_for_codes

#: float64 entries of one table block or row chunk (256 MiB)
_BLOCK_ENTRIES = 2 ** 25


def _fetch_heaps(trees: list[Tree]) -> dict:
    """The heap arrays every path needs, of every tree, in one fetch a
    field: numpy [T, H]."""
    if any(getattr(t, "cover", None) is None for t in trees):
        raise ValueError("tree has no cover stats (grown before gain/cover "
                         "channels); retrain to use predict_contributions")
    return {k: torch.stack([getattr(t, k) for t in trees]).cpu().numpy()
            for k in ("feat", "thresh_val", "na_left", "is_split", "leaf",
                      "cover")}


def expected_value(leaf: np.ndarray, cover: np.ndarray,
                   isp: np.ndarray) -> float:
    """Cover-weighted mean leaf value of one tree (its bias term), over the
    reached leaves (reference ``_expected_value``)."""
    leaves = ~isp & (cover > 0)
    tot = cover[leaves].sum()
    if tot <= 0:
        return 0.0
    return float((leaf[leaves] * cover[leaves]).sum() / tot)


def _paths(heaps: dict) -> dict:
    """Every root-to-leaf path of every tree whose root has cover, as
    numpy arrays over paths: the split-node slot of each ancestor
    (``anc`` [P, D], -1 where the path is shorter), the direction it took
    (``left``), the element each ancestor's feature merges into
    (``elem``), the elements' features (``feat`` [P, D], -1 past the
    path's length ``L``) and zero fractions (``z``, float64, multiplied
    in path order as the reference's ``iz * cover[child] / rj``), and the
    leaf value ``v``; and the split nodes (``split_tree``, ``split_node``),
    numbered in the order ``anc`` refers to them."""
    feat, isp = heaps["feat"], heaps["is_split"]
    cover = heaps["cover"].astype(np.float64)
    leaf = heaps["leaf"].astype(np.float64)
    T, H = feat.shape
    D = int(np.log2(H + 1)) - 1
    live = cover[:, 0] > 0
    # reached: the root, and the children of reached split nodes
    reached = np.zeros((T, H), bool)
    reached[:, 0] = live
    for d in range(D):
        lo, hi = 2 ** d - 1, 2 ** (d + 1) - 1
        par = reached[:, lo:hi] & isp[:, lo:hi]
        reached[:, 2 * lo + 1:2 * hi + 1:2] = par
        reached[:, 2 * lo + 2:2 * hi + 2:2] = par
    split_tree, split_node = np.nonzero(reached & isp)
    slot = np.full((T, H), -1, np.int64)
    slot[split_tree, split_node] = np.arange(split_tree.shape[0])
    ptree, pnode = np.nonzero(reached & ~isp)
    P = ptree.shape[0]
    depth = np.floor(np.log2(pnode + 1)).astype(np.int64)
    # ancestors from the root down: anc[:, k] is the node at depth k
    anc_node = np.full((P, max(D, 1)), -1, np.int64)
    left = np.zeros((P, max(D, 1)), bool)
    child = np.full((P, max(D, 1)), -1, np.int64)
    node = pnode.copy()
    for k in range(D - 1, -1, -1):
        on = depth > k
        par = (node - 1) // 2
        anc_node[on, k] = par[on]
        child[on, k] = node[on]
        left[on, k] = (node[on] % 2) == 1
        node = np.where(on, par, node)
    on = anc_node >= 0
    a_feat = np.where(on, feat[ptree[:, None], np.maximum(anc_node, 0)], -1)
    # each ancestor's element: its feature's first position on the path,
    # numbered among first positions
    same = (a_feat[:, :, None] == a_feat[:, None, :]) & on[:, :, None] \
        & on[:, None, :]
    first_pos = np.argmax(same, axis=2)
    is_first = on & (first_pos == np.arange(on.shape[1])[None, :])
    rank = np.cumsum(is_first, axis=1) - 1
    elem = np.where(on, np.take_along_axis(rank, first_pos, 1), -1)
    L = is_first.sum(1)
    E = on.shape[1]
    e_feat = np.full((P, E), -1, np.int64)
    z = np.ones((P, E), np.float64)
    rows = np.arange(P)
    for k in range(E):
        ok = on[:, k]
        r, e = rows[ok], elem[ok, k]
        e_feat[r, e] = a_feat[ok, k]
        rj = np.maximum(cover[ptree[ok], anc_node[ok, k]], 1e-12)
        z[r, e] = z[r, e] * cover[ptree[ok], child[ok, k]] / rj
    return dict(anc=np.where(on, slot[ptree[:, None],
                                      np.maximum(anc_node, 0)], -1),
                left=left, elem=elem, feat=e_feat, z=z, L=L,
                v=leaf[ptree, pnode], split_tree=split_tree,
                split_node=split_node)


def _path_weights(z: torch.Tensor, o: torch.Tensor,
                  L: torch.Tensor) -> torch.Tensor:
    """EXTEND of every path's elements in turn: ``z`` [P, E], ``o`` [P, E,
    N] (N inputs a path: patterns or rows), ``L`` [P] elements a path;
    returns the permutation weights [P, E + 1, N] (position 0 is the
    root's element, zero and one fractions 1)."""
    P, E, N = o.shape
    w = torch.zeros((P, E + 1, N), dtype=torch.float64, device=o.device)
    w[:, 0] = 1.0
    for e in range(1, E + 1):
        on = (L >= e)[:, None]
        ze, oe = z[:, e - 1, None], o[:, e - 1]
        for i in range(e - 1, -1, -1):
            up = w[:, i + 1] + oe * w[:, i] * (i + 1) / (e + 1)
            down = ze * w[:, i] * (e - i) / (e + 1)
            w[:, i + 1] = torch.where(on, up, w[:, i + 1])
            w[:, i] = torch.where(on, down, w[:, i])
    return w


def _element_contribs(z: torch.Tensor, o: torch.Tensor, L: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """[P, E, N] contribution of each element of each path: its unwound
    weight sum (UNWIND without mutating, the reference's ``unwound_sum``)
    times (one - zero) times the leaf value; 0 past a path's length."""
    P, E, N = o.shape
    w = _path_weights(z, o, L)
    Lf = L.to(torch.float64)[:, None]
    n_last = w.gather(1, L[:, None, None].expand(P, 1, N))[:, 0]
    out = torch.zeros((P, E, N), dtype=torch.float64, device=o.device)
    for i in range(1, E + 1):
        oi, zi = o[:, i - 1], z[:, i - 1, None]
        hot = oi != 0
        safe_o = torch.where(hot, oi, 1.0)
        safe_z = torch.where(zi != 0, zi, 1.0)
        n = n_last
        total = torch.zeros((P, N), dtype=torch.float64, device=o.device)
        for j in range(E - 1, -1, -1):
            act = (L > j)[:, None]
            with_o = n * (Lf + 1) / ((j + 1) * safe_o)
            without = w[:, j] * (Lf + 1) / torch.clamp(Lf - j, min=1) / safe_z
            t = torch.where(hot, with_o, without)
            total = torch.where(act, total + t, total)
            n = torch.where(act & hot, w[:, j] - t * zi * (Lf - j) / (Lf + 1),
                            n)
        out[:, i - 1] = torch.where((L >= i)[:, None],
                                    total * (oi - zi) * v[:, None], 0.0)
    return out


def _go_left(X: torch.Tensor, sf: torch.Tensor, tv: torch.Tensor,
             nal: torch.Tensor, masks, cat_card, n_bins: int) -> torch.Tensor:
    """[S, rows] direction of each split node for each row of X [rows, F]
    (float32, NaN = missing): below the threshold, or, at a group split on
    a categorical feature, the code's bin in the node's left mask."""
    x = X[:, sf]                                          # [rows, S]
    left = x < tv[None, :]
    if masks is not None and cat_card is not None:
        b = cat_bins_for_codes(X, cat_card, n_bins)[:, sf].long()
        b = b.clamp(0, masks.shape[1] - 1)
        s = torch.arange(sf.shape[0], device=X.device)[None, :]
        left = torch.where((cat_card[sf] > 0)[None, :], masks[s, b], left)
    return torch.where(torch.isnan(x), nal[None, :], left).T


def ensemble_contributions(trees: list[Tree], X: torch.Tensor, cat_card=None,
                           n_bins: int = 0) -> torch.Tensor:
    """[rows, F + 1] float64 SHAP contributions of a tree ensemble (last
    column: the sum of the trees' expected values), on X's device (raw
    float32 features [rows, F], NaN = missing; a group-split model passes
    its categorical cardinalities ``cat_card`` and category bins
    ``n_bins``). Row sums equal the sum of the trees' leaves (reference
    ``ensemble_contributions``)."""
    dev = X.device
    R, F = X.shape
    phi = torch.zeros((R, F + 1), dtype=torch.float64, device=dev)
    if not trees:
        return phi
    heaps = _fetch_heaps(trees)
    phi[:, F] = sum(expected_value(heaps["leaf"][t].astype(np.float64),
                                   heaps["cover"][t].astype(np.float64),
                                   heaps["is_split"][t])
                    for t in range(len(trees)) if heaps["cover"][t, 0] > 0)
    pa = _paths(heaps)
    grouped = trees[0].left_mask is not None and cat_card is not None
    masks = torch.stack([t.left_mask for t in trees]) if grouped else None
    if cat_card is not None:
        cat_card = cat_card.to(dev)
    tensor = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a)).to(dev,
                                                                       dt)
    # paths sorted by length, so that a block's table is as small as its
    # longest path allows; a path of no element contributes nothing
    order = np.argsort(pa["L"], kind="stable")
    order = order[pa["L"][order] > 0]
    X = X.contiguous()
    for b0, b1, E in _blocks(pa["L"][order], R):
        sel = order[b0:b1]
        Pb = sel.shape[0]
        anc = pa["anc"][sel]
        # the block's split nodes; an ancestor past a path's length points
        # at an extra row whose every decision agrees with the path
        used, local = np.unique(anc[anc >= 0], return_inverse=True)
        anc_local = np.full(anc.shape, used.shape[0], np.int64)
        anc_local[anc >= 0] = local
        st, sn = pa["split_tree"][used], pa["split_node"][used]
        sf = tensor(heaps["feat"][st, sn], torch.long)
        tv = tensor(heaps["thresh_val"][st, sn], torch.float32)
        nal = tensor(heaps["na_left"][st, sn], torch.bool)
        bm = (masks[tensor(st, torch.long), tensor(sn, torch.long)]
              if masks is not None else None)
        anc_t = tensor(anc_local, torch.long)
        dirl = tensor(np.where(anc >= 0, pa["left"][sel], True), torch.bool)
        elem = tensor(np.maximum(pa["elem"][sel], 0), torch.long)
        z = tensor(pa["z"][sel, :E], torch.float64)
        L = tensor(pa["L"][sel], torch.long)
        v = tensor(pa["v"][sel], torch.float64)
        ef = pa["feat"][sel, :E]
        oh = np.zeros((Pb, E, F + 1), np.float64)
        pe = np.nonzero(ef >= 0)
        oh[pe[0], pe[1], ef[pe]] = 1.0
        onehot = tensor(oh, torch.float64)
        full = (1 << L) - 1
        shifts = torch.arange(E, device=dev)
        table = None
        if 2 ** E <= R:
            pat = torch.arange(2 ** E, device=dev)
            bits = ((pat[None, :] >> shifts[:, None]) & 1).to(torch.float64)
            table = _element_contribs(z, bits.expand(Pb, E, 2 ** E), L, v)
        per_row = Pb * (E if table is not None else 2 * (E + 1))
        rc = max(1, _BLOCK_ENTRIES // max(per_row, used.shape[0] + 1))
        for r0 in range(0, R, rc):
            go = _go_left(X[r0:r0 + rc], sf, tv, nal, bm, cat_card, n_bins)
            go = torch.cat([go, torch.ones_like(go[:1])])
            cold = torch.zeros((Pb, go.shape[1]), dtype=torch.long,
                               device=dev)
            for k in range(anc_t.shape[1]):
                away = go[anc_t[:, k]] != dirl[:, k, None]
                cold = cold | (away.long() << elem[:, k, None])
            pattern = full[:, None] & ~cold                 # [Pb, rows]
            if table is not None:
                contrib = table.gather(
                    2, pattern[:, None, :].expand(Pb, E, pattern.shape[1]))
            else:
                o = (pattern[:, None, :] >> shifts[None, :, None]) & 1
                contrib = _element_contribs(z, o.to(torch.float64), L, v)
            # the elements summed per feature: one product with their
            # one-hot features (a fixed order of sums, unlike atomics)
            phi[r0:r0 + rc] += torch.einsum("per,pef->rf", contrib, onehot)
    return phi


def _blocks(L_sorted: np.ndarray, rows: int) -> list[tuple]:
    """(start, stop, E) of consecutive blocks of paths (sorted by length
    ``L_sorted``) whose table [paths, E, 2^E] and its weights, or weights
    per row where the rows are fewer than 2^E, stay within
    ``_BLOCK_ENTRIES`` a row chunk; E is the block's longest path."""
    out, b0, P = [], 0, L_sorted.shape[0]
    while b0 < P:
        b1 = b0 + 1
        while b1 < P:
            E = int(L_sorted[b1])
            per_path = 2 * (E + 1) * min(2 ** E, max(rows, 1))
            if (b1 + 1 - b0) * per_path > _BLOCK_ENTRIES:
                break
            b1 += 1
        out.append((b0, b1, int(L_sorted[b1 - 1])))
        b0 = b1
    return out


def tree_shap(tree: Tree, X: torch.Tensor, cat_card=None,
              n_bins: int = 0) -> torch.Tensor:
    """[rows, F + 1] contributions of one tree (reference ``tree_shap``)."""
    return ensemble_contributions([tree], X, cat_card, n_bins)
