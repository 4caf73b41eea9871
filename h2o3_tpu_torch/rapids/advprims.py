"""The advanced Rapids primitives — the port of
``h2o3_tpu/rapids/advprims.py``: advmath, filters, matrix, munger,
reducer, repeater, search, string, timeseries and model prims.

Reference: ``water/rapids/ast/prims/*/`` (each function names its Ast*
counterpart). Row-scale work runs on the frame's device; result-sized
payloads (a [k, k] matrix, k winners, group counts) and the seeded numpy
draws (folds and splits, from ``np.random.default_rng(seed)`` as in the
reference) cross to the host.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import CAT_NA, VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.rapids import munge


def _rng(seed):
    return np.random.default_rng(None if seed in (-1, None) else int(seed))


def _cols_frame(X: np.ndarray, names, device) -> Frame:
    """A frame of the host matrix's columns, each typed as a parsed column
    would be (INT where every finite value is whole)."""
    return Frame(list(names), [Vec.from_numpy(X[:, j], device=device)
                               for j in range(X.shape[1])])


def _row_frame(names, values, device) -> Frame:
    """A one-row frame: one float32 value per column."""
    return Frame(list(names), [Vec.from_numpy(np.float32([v]),
                                              device=device)
                               for v in values])


def _col_name(frame: Frame, c) -> str:
    return frame.names[int(c)] if isinstance(c, (int, float)) else c


# -- advmath ------------------------------------------------------------------


def _avg_ranks(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Tie-averaged 1-based ranks of each column's valid entries: one sort
    per column, then (#below + #at-or-below + 1) / 2 from two binary
    searches; invalid rows sort to +inf."""
    Xv = torch.where(w[:, None] > 0, X, torch.inf).T.contiguous()
    srt = torch.sort(Xv, dim=1).values
    lo = torch.searchsorted(srt, Xv, right=False)
    hi = torch.searchsorted(srt, Xv, right=True)
    return ((lo + hi + 1).to(torch.float32) / 2.0).T


def _weighted_corr(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of the columns over the rows of weight > 0."""
    ws = w.sum().clamp_min(1.0)
    on = w[:, None] > 0
    mu = torch.where(on, X, 0.0).sum(0) / ws
    Xc = torch.where(on, X - mu[None, :], 0.0)
    cov = (Xc.T @ Xc) / (ws - 1.0).clamp_min(1.0)
    sd = torch.diag(cov).clamp_min(0.0).sqrt()
    denom = torch.outer(sd, sd)
    return torch.where(denom > 0,
                       cov / torch.where(denom == 0, 1.0, denom), torch.nan)


def cor(frame: Frame, frame2: Frame | None = None, use: str = "complete.obs",
        method: str = "Pearson") -> Frame:
    """AstCorrelation / AstSpearmanCorrelation: the correlation matrix of
    the numeric columns over the complete rows."""
    cols = [c for c in frame.names if frame.vec(c).is_numeric]
    X = frame.matrix(cols)
    w = (~torch.isnan(X).any(dim=1)).to(torch.float32)
    if method.lower().startswith("spearman"):
        X = _avg_ranks(X, w)
    C = _weighted_corr(X, w).double().cpu().numpy()
    return _cols_frame(C.astype(np.float32), cols, frame.device)


def distance(frame: Frame, other: Frame, measure: str = "l2") -> Frame:
    """AstDistance: [nx, ny] pairwise distances."""
    X, Y = frame.matrix(), other.matrix().to(frame.device)
    if measure in ("cosine", "cosine_sq"):
        xn = X / X.norm(dim=1, keepdim=True).clamp_min(1e-30)
        yn = Y / Y.norm(dim=1, keepdim=True).clamp_min(1e-30)
        sim = xn @ yn.T
        D = sim * sim if measure == "cosine_sq" else sim
    elif measure == "l1":
        D = (X[:, None, :] - Y[None, :, :]).abs().sum(dim=2)
    else:                                   # l2
        x2 = (X * X).sum(1)[:, None]
        y2 = (Y * Y).sum(1)[None, :]
        D = (x2 + y2 - 2.0 * (X @ Y.T)).clamp_min(0.0).sqrt()
    Dh = D.cpu().numpy()
    return _cols_frame(Dh, [f"C{j + 1}" for j in range(Dh.shape[1])],
                       frame.device)


def kfold_column(frame: Frame, nfolds: int, seed: int = -1) -> Vec:
    """AstKFold: uniform random fold assignment."""
    return Vec.from_numpy(_rng(seed).integers(0, nfolds, frame.nrows)
                          .astype(np.float32), device=frame.device)


def modulo_kfold_column(frame: Frame, nfolds: int) -> Vec:
    """AstModuloKFold: fold = row % nfolds."""
    return Vec.from_numpy((np.arange(frame.nrows) % nfolds)
                          .astype(np.float32), device=frame.device)


def _vec_device(vec: Vec):
    return vec.device if vec.data is not None else resolve_device()


def stratified_kfold_column(vec: Vec, nfolds: int, seed: int = -1) -> Vec:
    """AstStratifiedKFold: folds balanced within each class."""
    y = vec.to_numpy()
    rng = _rng(seed)
    out = np.zeros(len(y), np.float32)
    for cls in (np.unique(y[~np.isnan(y.astype(np.float64))])
                if y.dtype.kind == "f" else np.unique(y)):
        idx = np.nonzero(y == cls)[0]
        rng.shuffle(idx)
        out[idx] = np.arange(len(idx)) % nfolds
    return Vec.from_numpy(out, device=_vec_device(vec))


def stratified_split(vec: Vec, test_frac: float = 0.2, seed: int = -1) -> Vec:
    """AstStratifiedSplit: a train/test column, split within each class."""
    y = vec.to_numpy()
    rng = _rng(seed)
    out = np.zeros(len(y), np.int32)
    for cls in np.unique(y):
        idx = np.nonzero(y == cls)[0]
        rng.shuffle(idx)
        out[idx[: int(round(test_frac * len(idx)))]] = 1
    return Vec.from_numpy(out, type=VecType.CAT, domain=("train", "test"),
                          device=_vec_device(vec))


def _central_moments(x: torch.Tensor) -> list[float]:
    """(n, m2, m3, m4, n_na) over the valid values, one fetch."""
    ok = ~torch.isnan(x)
    n = ok.sum().to(torch.float32)
    nn = n.clamp_min(1.0)
    m = torch.where(ok, x, 0.0).sum() / nn
    d = torch.where(ok, x - m, 0.0)
    d2 = d * d
    return torch.stack([n, d2.sum() / nn, (d2 * d).sum() / nn,
                        (d2 * d2).sum() / nn, x.numel() - n]).tolist()


def skewness(vec: Vec, na_rm: bool = True) -> float:
    """AstSkewness: the sample skewness g1 * sqrt(n(n-1))/(n-2)."""
    n, m2, m3, _, n_na = _central_moments(vec.as_float())
    if not na_rm and n_na > 0:
        return float("nan")
    g1 = m3 / max(m2, 1e-300) ** 1.5
    return float(g1 * np.sqrt(n * (n - 1)) / max(n - 2, 1))


def kurtosis(vec: Vec, na_rm: bool = True) -> float:
    """AstKurtosis: Pearson's kurtosis m4/m2² (3 for a normal)."""
    n, m2, _, m4, n_na = _central_moments(vec.as_float())
    if not na_rm and n_na > 0:
        return float("nan")
    return float(m4 / max(m2, 1e-300) ** 2)


def mode(vec: Vec) -> float:
    """AstMode: the most frequent level's code (-1 with no value)."""
    if not vec.is_categorical:
        raise ValueError("mode requires a categorical column")
    codes = vec.data.long()
    cnt = torch.bincount(codes.clamp_min(0), weights=(codes >= 0).double(),
                         minlength=max(vec.cardinality(), 1))
    best, total = torch.stack([cnt.argmax().double(),
                               cnt.sum().double()]).tolist()
    return float(best) if total > 0 else -1.0


# -- filters ------------------------------------------------------------------


def drop_duplicates(frame: Frame, by=None, keep: str = "first") -> Frame:
    """Astdropduplicates: the first (or last) row of each duplicate group,
    in row order."""
    cols = [_col_name(frame, c) for c in (list(by) if by else frame.names)]
    gid, ng, _ = munge.frame_group_ids(frame, cols)
    row = torch.arange(frame.nrows, device=frame.device)
    if keep == "last":
        picked = munge.segment_reduce(row, gid, ng, "amax", -1)
    else:
        picked = munge.segment_reduce(row, gid, ng, "amin", frame.nrows)
    return munge.gather_rows(frame, torch.sort(picked).values)


# -- matrix -------------------------------------------------------------------


def mmult(a: Frame, b: Frame) -> Frame:
    """AstMMult: the matrix product."""
    Z = (a.matrix() @ b.matrix().to(a.device)).cpu().numpy()
    return _cols_frame(Z, [f"C{j + 1}" for j in range(Z.shape[1])], a.device)


def transpose(frame: Frame) -> Frame:
    """AstTranspose: one column per row (one fetch of the block)."""
    X = frame.matrix().T.cpu().numpy()
    return _cols_frame(X, [f"C{j + 1}" for j in range(X.shape[1])],
                       frame.device)


# -- mungers ------------------------------------------------------------------


def any_factor(frame: Frame) -> bool:
    """AstAnyFactor."""
    return any(v.is_categorical for v in frame.vecs)


def append_levels(vec: Vec, levels) -> Vec:
    """AstAppendLevels: extend the domain (codes unchanged)."""
    if not vec.is_categorical:
        raise ValueError("appendLevels requires a categorical column")
    dom = tuple(vec.domain) + tuple(l for l in levels if l not in vec.domain)
    return Vec(vec.data, VecType.CAT, domain=dom)


_TYPE_MATCH = {"numeric": (VecType.NUM, VecType.INT),
               "categorical": (VecType.CAT,), "string": (VecType.STR,),
               "time": (VecType.TIME,), "uuid": (VecType.UUID,),
               "bad": (VecType.BAD,)}


def columns_by_type(frame: Frame, coltype: str = "numeric") -> list[float]:
    """AstColumnsByType: 0-based indices of the columns of a type."""
    types = _TYPE_MATCH.get(coltype.lower())
    if types is None:
        raise ValueError(f"unknown column type {coltype!r}")
    return [float(i) for i, v in enumerate(frame.vecs) if v.type in types]


def ddply(frame: Frame, by, col, fn: str) -> Frame:
    """AstDdply: a named reducer over one column by group."""
    cols = [_col_name(frame, c)
            for c in (by if isinstance(by, (list, tuple)) else [by])]
    return munge.group_by(frame, cols, {_col_name(frame, col): fn})


def _fill_index(valid: torch.Tensor, maxlen: int) -> torch.Tensor:
    """For each row (along the last dim) the row whose value a forward fill
    puts there: the row itself where valid, else the last valid row before
    it when at most ``maxlen`` rows back, else -1 (left missing)."""
    row = torch.arange(valid.shape[-1], device=valid.device).expand_as(valid)
    last = torch.cummax(torch.where(valid, row, -1), dim=-1).values
    ok = valid | ((last >= 0) & (row - last <= maxlen))
    return torch.where(ok, last, -1)


def _fill(X: torch.Tensor, fwd: bool, maxlen: int) -> torch.Tensor:
    """Directional NA fill of each row of X ([columns, rows]) with a
    run-length cap (the reference's AstFillNA carry): one cummax over the
    indices of the valid rows."""
    if not fwd:
        X = X.flip(-1)
    src = _fill_index(~torch.isnan(X), maxlen)
    Y = torch.where(src >= 0, torch.gather(X, -1, src.clamp_min(0)),
                    torch.nan)
    return Y.flip(-1) if not fwd else Y


def fillna(frame: Frame, method: str = "forward", axis: int = 0,
           maxlen: int = 1) -> Frame:
    """AstFillNA: fill each missing value from the nearest value before it
    (forward) or after it (backward), at most ``maxlen`` rows away."""
    from h2o3_tpu_torch.rapids.timeops import time_vec
    fwd = method.lower().startswith("f")
    dev = [v for v in frame.vecs
           if v.data is not None and v.type is not VecType.TIME]
    Y = _fill(torch.stack([v.as_float() for v in dev]), fwd,
              int(maxlen)) if dev else None
    out, j = [], 0
    for v in frame.vecs:
        if v.data is None:
            out.append(v)
        elif v.type is VecType.TIME:
            # the exact float64 epoch ms live on the host: fill there
            ms = torch.as_tensor(np.asarray(v.to_numpy(), np.float64))
            out.append(time_vec(_fill(ms[None], fwd, int(maxlen))[0].numpy(),
                                device=v.device))
        else:
            col = Y[j]
            j += 1
            if v.is_categorical:
                codes = torch.where(torch.isnan(col), CAT_NA,
                                    col).to(torch.int32)
                out.append(Vec(codes, VecType.CAT, domain=v.domain))
            else:
                out.append(Vec(col, v.type))
    return Frame(list(frame.names), out)


def filter_na_cols(frame: Frame, frac: float = 0.2) -> list[float]:
    """AstFilterNaCols: indices of the columns with an NA share below
    ``frac``."""
    return [float(i) for i, v in enumerate(frame.vecs)
            if v.rollups().na_cnt / max(frame.nrows, 1) < frac]


def flatten(frame: Frame):
    """AstFlatten: a 1x1 frame → its value."""
    if frame.nrows != 1 or frame.ncols != 1:
        raise ValueError("flatten requires a 1x1 frame")
    v = frame.vecs[0]
    if v.is_categorical:
        return v.labels()[0]
    val = v.to_numpy()[0]
    return float(val) if v.data is not None else val


def getrow(frame: Frame) -> list:
    """AstGetrow: a one-row frame → its values."""
    if frame.nrows != 1:
        raise ValueError(f"getrow requires a 1-row frame, got {frame.nrows}")
    return [float(v.to_numpy()[0]) if v.data is not None
            else v.host_values[0] for v in frame.vecs]


def na_omit(frame: Frame) -> Frame:
    """AstNaOmit: the rows without a missing value."""
    ok = torch.ones(frame.nrows, dtype=torch.bool, device=frame.device)
    for v in frame.vecs:
        if v.data is not None:
            ok &= (v.data >= 0) if v.is_categorical else ~torch.isnan(v.data)
    for v in frame.vecs:
        if v.data is None:
            ok &= torch.as_tensor(np.array([x is not None
                                            for x in v.host_values]),
                                  device=frame.device)
    return munge.gather_rows(frame, torch.nonzero(ok).squeeze(1))


def nlevels(vec: Vec) -> float:
    """AstNLevels."""
    return float(vec.cardinality())


def rank_within_group_by(frame: Frame, group_cols, sort_cols, ascending=None,
                         new_col: str = "rank",
                         sort_cols_sorted: bool = False) -> Frame:
    """AstRankWithinGroupBy: each row's 1-based rank within its group under
    the sort columns' order (ties by row order)."""
    gcols = [_col_name(frame, c) for c in group_cols]
    scols = [_col_name(frame, c) for c in sort_cols]
    asc = list(ascending) if ascending is not None else [True] * len(scols)
    gid, _, _ = munge.frame_group_ids(frame, gcols)
    keys = []
    # paired from the last sort column back, as the reference pairs them
    # (with fewer directions than columns, the first columns go unsorted)
    for c, a in zip(scols[::-1], asc[::-1]):
        k = frame.vec(c).as_float()
        k = k if a else -k
        # NaN after +inf, NaNs tied (the order jnp.lexsort gives them)
        keys = [torch.isnan(k).to(torch.int8), munge._nan_last(k)] + keys
    keys = [gid] + keys
    order = munge.lexsort(keys)           # row order breaks the ties
    out = Frame(list(frame.names), list(frame.vecs))
    out.add(new_col, Vec(_rank_in_runs(order, gid), VecType.NUM))
    if sort_cols_sorted:
        out = munge.sort(out, gcols + scols, True)
    return out


def _rank_in_runs(order: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """1-based ranks within the runs of equal ``gid`` along ``order``,
    scattered back to the rows: position minus the run's start (a cummax
    over the run starts)."""
    n = order.shape[0]
    gs = gid[order]
    idx = torch.arange(n, device=gid.device)
    new_run = torch.ones(n, dtype=torch.bool, device=gid.device)
    new_run[1:] = gs[1:] != gs[:-1]
    start = torch.cummax(torch.where(new_run, idx, 0), 0).values
    out = torch.empty(n, dtype=torch.float32, device=gid.device)
    out[order] = (idx - start + 1).to(torch.float32)
    return out


def _remap_codes(vec: Vec, dom: list[str]) -> Vec:
    """A categorical column's codes moved onto a reordered domain."""
    lut = torch.tensor([dom.index(d) for d in vec.domain] + [CAT_NA],
                       dtype=torch.int32, device=vec.device)
    new = lut[torch.where(vec.data >= 0, vec.data.long(), -1)]
    return Vec(new, VecType.CAT, domain=tuple(dom))


def relevel(vec: Vec, level: str) -> Vec:
    """AstReLevel: make ``level`` the first (baseline) level."""
    if not vec.is_categorical or level not in (vec.domain or ()):
        raise ValueError(f"level {level!r} not in domain")
    return _remap_codes(vec, [level] + [d for d in vec.domain if d != level])


def relevel_by_freq(vec: Vec, weights: Vec | None = None,
                    top_n: int = -1) -> Vec:
    """AstRelevelByFreq: levels ordered by descending (weighted) count; with
    ``top_n``, only that many most frequent move to the front."""
    card = max(vec.cardinality(), 1)
    codes = vec.data.long()
    w = weights.as_float() if weights is not None else \
        torch.ones(vec.nrows, dtype=torch.float32, device=vec.device)
    w = torch.where((codes >= 0) & ~torch.isnan(w), w, 0.0)
    cnt = torch.bincount(codes.clamp_min(0), weights=w.double(),
                         minlength=card).cpu().numpy()
    order = np.argsort(-cnt, kind="stable")
    if top_n > 0:
        order = np.concatenate([order[:top_n], np.sort(order[top_n:])])
    return _remap_codes(vec, [vec.domain[i] for i in order])


def rename(frame: Frame, old, new: str) -> Frame:
    """AstRename (a single ``colnames<-``)."""
    i = frame._index(old if not isinstance(old, float) else int(old))
    names = list(frame.names)
    names[i] = new
    return Frame(names, list(frame.vecs), key=frame.key)


def set_domain(vec: Vec, domain) -> Vec:
    """AstSetDomain: new level names (codes unchanged)."""
    if not vec.is_categorical:
        raise ValueError("setDomain requires a categorical column")
    if len(domain) != len(vec.domain or ()):
        raise ValueError(f"new domain has {len(domain)} levels, column has "
                         f"{len(vec.domain or ())}")
    return Vec(vec.data, VecType.CAT, domain=tuple(domain))


def set_level(vec: Vec, level: str) -> Vec:
    """AstSetLevel: a constant column at one level."""
    if level not in (vec.domain or ()):
        raise ValueError(f"level {level!r} not in domain")
    return Vec(torch.full((vec.nrows,), vec.domain.index(level),
                          dtype=torch.int32, device=vec.device),
               VecType.CAT, domain=vec.domain)


def _nan_reduce(X: torch.Tensor, fn: str, dim: int) -> torch.Tensor:
    """``jnp.nan*`` reductions of X along ``dim``: NaN where no value."""
    ok = ~torch.isnan(X)
    n = ok.sum(dim)
    if fn == "sum":
        return torch.where(ok, X, 0.0).sum(dim)
    if fn == "mean":
        return torch.where(ok, X, 0.0).sum(dim) / n
    if fn in ("min", "max"):
        fill = torch.inf if fn == "min" else -torch.inf
        m = torch.where(ok, X, fill)
        m = m.amin(dim) if fn == "min" else m.amax(dim)
        return torch.where(n > 0, m, torch.nan)
    if fn == "median":
        s = torch.sort(torch.where(ok, X, torch.inf), dim=dim).values
        c = n.clamp_min(1)
        lo = ((c - 1) // 2).unsqueeze(dim)
        hi = (c // 2).unsqueeze(dim)
        med = (torch.gather(s, dim, lo) + torch.gather(s, dim, hi)) / 2.0
        return torch.where(n > 0, med.squeeze(dim), torch.nan)
    # var / sd, ddof 1
    mu = torch.where(ok, X, 0.0).sum(dim) / n
    d = torch.where(ok, X - mu.unsqueeze(dim), 0.0)
    var = (d * d).sum(dim) / (n - 1)
    return var.sqrt() if fn == "sd" else var


def apply_margin(frame: Frame, margin: int, fn: str) -> Frame:
    """AstApply (the named reducers): margin 1 per row, 2 per column;
    abs and sqrt element-wise."""
    X = frame.matrix()
    if fn in ("abs", "sqrt"):
        Y = getattr(torch, fn)(X).cpu().numpy()
        return _cols_frame(Y, frame.names, frame.device)
    if fn not in ("sum", "mean", "min", "max", "median", "sd", "var"):
        raise ValueError(f"apply supports ['abs', 'max', 'mean', 'median', "
                         f"'min', 'sd', 'sqrt', 'sum', 'var'], got {fn!r}")
    axis = 1 if int(margin) == 1 else 0
    r = _nan_reduce(X, fn, axis).cpu().numpy()
    if axis == 1:
        return Frame([fn], [Vec.from_numpy(r.astype(np.float32),
                                           device=frame.device)])
    return _row_frame(frame.names, r, frame.device)


# -- reducers -----------------------------------------------------------------


def mad(vec: Vec, constant: float = 1.4826) -> float:
    """AstMad: the median absolute deviation, scaled."""
    from h2o3_tpu_torch.rapids.ops import quantiles_sorted, sorted_valid
    x = vec.as_float()
    med = float(np.float32(quantiles_sorted(*sorted_valid(x), [0.5])[0]))
    dev = (x - med).abs()
    return float(constant * np.float32(
        quantiles_sorted(*sorted_valid(dev), [0.5])[0]))


def _na_poison(vec: Vec, base: float) -> float:
    return float("nan") if vec.rollups().na_cnt > 0 else base


def max_na(vec: Vec) -> float:
    """AstMaxNa: NA where any value is NA."""
    from h2o3_tpu_torch.rapids.ops import vmax
    return _na_poison(vec, vmax(vec))


def min_na(vec: Vec) -> float:
    from h2o3_tpu_torch.rapids.ops import vmin
    return _na_poison(vec, vmin(vec))


def sum_na(vec: Vec) -> float:
    from h2o3_tpu_torch.rapids.ops import vsum
    return _na_poison(vec, vsum(vec))


def prod_na(vec: Vec) -> float:
    from h2o3_tpu_torch.rapids.ops import vprod
    return _na_poison(vec, vprod(vec))


def na_cnt(vec: Vec) -> float:
    """AstNaCnt."""
    return float(vec.rollups().na_cnt)


def any_na(frame: Frame) -> bool:
    """AstAnyNa."""
    return any(v.rollups().na_cnt > 0 for v in frame.vecs)


def sum_axis(frame: Frame, na_rm: bool = True, axis: int = 0) -> Frame:
    """AstSumAxis: per-column (axis 0) or per-row (axis 1) sums."""
    X = frame.matrix()
    if na_rm:
        X = torch.where(torch.isnan(X), 0.0, X)
    if int(axis) == 1:
        return Frame(["sum"], [Vec.from_numpy(X.sum(1).cpu().numpy(),
                                              device=frame.device)])
    return _row_frame(frame.names, X.sum(0).cpu().numpy(), frame.device)


def topn(frame: Frame, col, n_percent: float, grab: str = "top") -> Frame:
    """AstTopN: (row index, value) of the top (or bottom) n% of the valid
    values, best first, ties by row order."""
    col = _col_name(frame, col)
    v = frame.vec(col)
    n_valid = v.nrows - v.rollups().na_cnt
    k = min(n_valid, max(1, int(round(n_valid * n_percent / 100.0))))
    dev = frame.device
    if k == 0:
        empty = np.zeros(0, np.float32)
        return Frame(["index", col], [Vec.from_numpy(empty, device=dev),
                                      Vec.from_numpy(empty, device=dev)])
    a = v.as_float()
    key = munge._nan_last(-a if grab == "top" else a)
    order = torch.argsort(key, stable=True)[:k]
    return Frame(["index", col],
                 [Vec.from_numpy(order.cpu().numpy().astype(np.float32),
                                 device=dev),
                  Vec.from_numpy(a[order].cpu().numpy(), device=dev)])


# -- repeaters ----------------------------------------------------------------


def seq(frm: float, to: float, by: float = 1.0) -> Vec:
    """AstSeq."""
    return Vec.from_numpy(np.arange(frm, to + by * 0.5 * np.sign(by), by)
                          .astype(np.float32))


def seq_len(n: float) -> Vec:
    """AstSeqLen: 1..n."""
    return Vec.from_numpy(np.arange(1, int(n) + 1).astype(np.float32))


def rep_len(x, length: float) -> Vec:
    """AstRepLen: ``x`` (a column or a number) recycled to ``length``."""
    n = int(length)
    if isinstance(x, Vec):
        idx = torch.arange(n, device=x.device) % max(x.nrows, 1)
        out = x.data[idx]
        if x.is_categorical:
            return Vec(out.to(torch.int32), VecType.CAT, domain=x.domain)
        return Vec(out.to(torch.float32), VecType.NUM)
    return Vec.from_numpy(np.full(n, float(x), np.float32))


# -- search -------------------------------------------------------------------


def match(vec: Vec, table, nomatch: float = np.nan, start_index: float = 1
          ) -> Vec:
    """AstMatch: each value's 1-based position in ``table``."""
    table = list(table) if isinstance(table, (list, tuple)) else [table]
    if vec.is_categorical:
        lut = {str(t): i + start_index for i, t in enumerate(table)}
        out = np.array([lut.get(v, nomatch) if v is not None else nomatch
                        for v in vec.labels()], np.float64)
        return Vec.from_numpy(out.astype(np.float32), device=vec.device)
    tbl = torch.tensor([float(t) for t in table], dtype=torch.float32,
                       device=vec.device)
    hit = vec.as_float()[:, None] == tbl[None, :]
    pos = hit.to(torch.int8).argmax(dim=1).to(torch.float32) \
        + float(start_index)
    return Vec(torch.where(hit.any(dim=1), pos, float(nomatch)), VecType.NUM)


def which(vec: Vec) -> Vec:
    """AstWhich: the 0-based rows where the value is truthy."""
    a = vec.as_float()
    idx = torch.nonzero(~torch.isnan(a) & (a != 0)).squeeze(1)
    # typed as a parsed column of row numbers: INT, NUM when empty
    return Vec(idx.to(torch.float32),
               VecType.INT if len(idx) else VecType.NUM)


def _nanargext(X: torch.Tensor, how: str, dim: int) -> torch.Tensor:
    """``jnp.nanargmax``/``nanargmin``: NaN read as -inf (+inf), the first
    extreme wins, -1 where every value is NaN."""
    nan = torch.isnan(X)
    fill = -torch.inf if how == "max" else torch.inf
    Xf = torch.where(nan, fill, X)
    r = Xf.argmax(dim) if how == "max" else Xf.argmin(dim)
    return torch.where(nan.all(dim), -1, r)


def which_max(frame: Frame, na_rm: bool = True, axis: int = 0) -> Frame:
    return _which_extreme(frame, "max", axis)


def which_min(frame: Frame, na_rm: bool = True, axis: int = 0) -> Frame:
    return _which_extreme(frame, "min", axis)


def _which_extreme(frame: Frame, how: str, axis: int) -> Frame:
    X = frame.matrix()
    if int(axis) == 1:
        return Frame(["which"], [Vec(_nanargext(X, how, 1).to(torch.float32),
                                     VecType.NUM)])
    r = _nanargext(X, how, 0).cpu().numpy().astype(np.float32)
    return _row_frame(frame.names, r, frame.device)


# -- string extras ------------------------------------------------------------


def _strings(vec: Vec):
    return vec.labels() if vec.is_categorical else vec.host_values


def count_matches(vec: Vec, pattern) -> Vec:
    """AstCountMatches: occurrences of the pattern(s) in each string."""
    pats = list(pattern) if isinstance(pattern, (list, tuple)) else [pattern]
    out = np.array([sum(str(v).count(p) for p in pats) if v is not None
                    else np.nan for v in _strings(vec)], np.float64)
    return Vec.from_numpy(out.astype(np.float32), device=_vec_device(vec))


def _levenshtein(s: str, t: str) -> int:
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s, 1):
        cur = [i]
        for j, ct in enumerate(t, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (cs != ct)))
        prev = cur
    return prev[-1]


def str_distance(vec: Vec, other: Vec, measure: str = "lv",
                 compare_empty: bool = True) -> Vec:
    """AstStrDistance: per-row Levenshtein (lv) or Jaccard distance."""
    def lev(s, t):
        if s is None or t is None:
            return np.nan
        if not compare_empty and (s == "" or t == ""):
            return np.nan
        return _levenshtein(s, t)

    def jac(s, t):
        if s is None or t is None:
            return np.nan
        A, B = set(s), set(t)
        return 1.0 - len(A & B) / max(len(A | B), 1)

    fn = jac if measure == "jaccard" else lev
    out = np.array([fn(x, y) for x, y in zip(_strings(vec), _strings(other))],
                   np.float64)
    return Vec.from_numpy(out.astype(np.float32), device=_vec_device(vec))


def tokenize(frame: Frame, split: str) -> Frame:
    """AstTokenize: one token a row, in a host string column ``token``:
    each string of each column (column by column) split on the regex
    ``split``, empty tokens dropped, and a missing row after every string
    (a missing string gives the missing row alone), which closes the
    document — the Word2Vec ingest format."""
    rx = re.compile(split)
    toks: list = []
    for v in frame.vecs:
        for s in _strings(v):
            if s is not None:
                toks.extend(t for t in rx.split(str(s)) if t)
            toks.append(None)
    return Frame(["token"], [Vec(None, VecType.STR,
                                 host_values=np.array(toks, dtype=object))])


# -- timeseries ---------------------------------------------------------------


def difflag1(vec: Vec) -> Vec:
    """AstDiffLag1: x[i] - x[i-1], the first row NA."""
    a = vec.as_float()
    d = (a - torch.roll(a, 1)).index_fill(
        0, torch.zeros(min(len(a), 1), dtype=torch.long, device=a.device),
        torch.nan)
    return Vec(d.to(torch.float32), VecType.NUM)


def isax(frame: Frame, num_words: int, max_cardinality: int,
         optimize_card: bool = False) -> Frame:
    """AstIsax: each row's iSAX word — z-normalized, PAA over
    ``num_words`` segments, each cut at ``max_cardinality`` gaussian
    breakpoints."""
    from scipy.stats import norm
    X = frame.matrix()
    ok = ~torch.isnan(X)
    n = ok.sum(1, keepdim=True)
    mu = torch.where(ok, X, 0.0).sum(1, keepdim=True) / n
    sd = (torch.where(ok, X - mu, 0.0) ** 2).sum(1, keepdim=True).div(n) \
        .sqrt()
    Z = (X - mu) / sd.clamp_min(1e-12)
    segs = np.array_split(np.arange(X.shape[1]), num_words)
    paa = torch.stack([Z[:, int(s[0]): int(s[-1]) + 1].mean(dim=1)
                       for s in segs], 1)
    breaks = torch.as_tensor(norm.ppf(np.linspace(0, 1, max_cardinality + 1)
                                      [1:-1]).astype(np.float32),
                             device=X.device)
    codes = torch.searchsorted(breaks, paa.contiguous()).cpu().numpy()
    words = np.array(["^".join(str(c) for c in row) for row in codes],
                     dtype=object)
    out = Frame(["iSax_index"], [Vec(None, VecType.STR, host_values=words)])
    for j in range(num_words):
        out.add(f"c{j}", Vec.from_numpy(codes[:, j].astype(np.float32),
                                        device=frame.device))
    return out


# -- models -------------------------------------------------------------------


def perfect_auc(probs: Vec, acts: Vec) -> float:
    """AstPerfectAUC: the exact AUC from raw probabilities (Mann-Whitney
    with tie-averaged ranks; 1.0 when a class is absent)."""
    p, y = probs.as_float(), acts.as_float().to(probs.device)
    ok = ~torch.isnan(p) & ~torch.isnan(y)
    pv = torch.where(ok, p, torch.inf)
    srt = torch.sort(pv).values
    ranks = (torch.searchsorted(srt, pv) + torch.searchsorted(
        srt, pv, right=True) + 1).double() / 2.0
    pos = ok & (y > 0)
    npos, nok, s = torch.stack([pos.sum().double(), ok.sum().double(),
                                torch.where(pos, ranks, 0.0).sum()]).tolist()
    nneg = nok - npos
    if int(npos) == 0 or int(nneg) == 0:
        return 1.0
    return (s - npos * (npos + 1.0) / 2.0) / max(npos * nneg, 1.0)


def grouped_permute(frame: Frame, perm_col, group_by, permute_by, keep_col
                    ) -> Frame:
    """AstGroupedPermute: per group, the ``perm_col`` ids whose
    ``permute_by`` level is "D" (In) crossed with the rest (Out), with
    their summed ``keep_col`` amounts: (group..., In, Out, InAmnt,
    OutAmnt). The (group, id, side) sums run on the device; the cross join
    over them on the host."""
    perm_col, keep_col = (_col_name(frame, perm_col),
                          _col_name(frame, keep_col))
    pb = frame.vec(_col_name(frame, permute_by))
    gcols = [_col_name(frame, g) for g in (
        group_by if isinstance(group_by, (list, tuple, np.ndarray))
        else [group_by])]
    if not pb.is_categorical:
        raise ValueError("permuteBy must be categorical")
    d_code = pb.domain.index("D") if "D" in (pb.domain or ()) else -2
    tmp = Frame(list(frame.names), list(frame.vecs))
    tmp.add("__side", Vec((pb.data == d_code).to(torch.float32),
                          VecType.NUM))
    agg = munge.group_by(tmp, gcols + [perm_col, "__side"],
                         {keep_col: "sum"})
    host = {c: np.asarray(agg.vec(c).as_float().cpu().numpy(), np.float64)
            for c in gcols + [perm_col, "__side", f"sum_{keep_col}"]}
    gvals = (np.stack([host[g] for g in gcols], 1) if gcols
             else np.zeros((agg.nrows, 0)))
    rid, amt = host[perm_col], host[f"sum_{keep_col}"]
    is_in = host["__side"] > 0
    groups: dict = {}
    for r in range(agg.nrows):
        ins, outs = groups.setdefault(tuple(gvals[r]), ({}, {}))
        side = ins if is_in[r] else outs
        side[rid[r]] = side.get(rid[r], 0.0) + amt[r]
    rows = [list(key) + [i_id, o_id, i_amt, o_amt]
            for key, (ins, outs) in groups.items()
            for i_id, i_amt in ins.items() for o_id, o_amt in outs.items()]
    names = gcols + ["In", "Out", "InAmnt", "OutAmnt"]
    arr = np.asarray(rows, np.float32).reshape(len(rows), len(names))
    return _cols_frame(arr, names, frame.device)


def rectangle_assign(dst: Frame, src, cols, rows) -> Frame:
    """AstRectangleAssign ``(:= dst src col_expr row_expr)``: a scalar, a
    string, NA or a Frame assigned into a row x column slice of ``dst``
    (h2o-py emits it for ``fr[rows, cols] = value``); a new Frame."""
    n = dst.nrows
    dev = dst.device

    def _empty_sel(s):
        # "[]" (an empty array) and [] both mean every row or column
        return s is None or (isinstance(s, (list, tuple, np.ndarray))
                             and len(s) == 0)

    if _empty_sel(cols):
        cidx = list(range(dst.ncols))
    else:
        sel = cols if isinstance(cols, (list, tuple, np.ndarray)) else [cols]
        cidx = [dst.names.index(c) if isinstance(c, str) else int(c)
                for c in sel]
    if _empty_sel(rows):
        ridx = np.arange(n)
    elif isinstance(rows, (Frame, Vec)):
        mv = rows.vecs[0] if isinstance(rows, Frame) else rows
        m = mv.as_float().cpu().numpy()
        ridx = np.nonzero((m > 0) & ~np.isnan(m))[0]
    else:
        ridx = np.atleast_1d(np.asarray(rows)).astype(np.int64)
    if np.any((ridx < 0) | (ridx >= n)):
        raise ValueError("row index out of range in rectangle assign")

    def src_col(j_pos: int):
        """The source values of the j-th selected column, aligned to
        ``ridx``."""
        v = src.vecs[j_pos]
        if v.type is VecType.CAT:
            vals = v.labels()
        elif v.data is None:
            vals = v.host_values
        elif v.type is VecType.TIME:
            vals = np.asarray(v.to_numpy(), np.float64)   # absolute ms
        else:
            vals = v.as_float().cpu().numpy()
        if src.nrows == n:
            return vals[ridx]
        if src.nrows == len(ridx):
            return vals
        raise ValueError(
            f"source frame has {src.nrows} rows; need {n} or {len(ridx)}")

    def as_f64(vals):
        return (np.nan if vals is None else
                np.asarray(vals, np.float64) if not np.isscalar(vals)
                else float(vals))

    from h2o3_tpu_torch.rapids.timeops import time_vec
    new_vecs = list(dst.vecs)
    for j_pos, j in enumerate(cidx):
        v = dst.vecs[j]
        vals = src_col(j_pos) if isinstance(src, Frame) else src
        if v.type is VecType.CAT:
            cur = v.labels()
            cur[ridx] = vals
            new_vecs[j] = Vec.from_numpy(cur, type=VecType.CAT, device=dev)
        elif v.data is None:
            cur = np.array(v.host_values, dtype=object)
            cur[ridx] = vals
            new_vecs[j] = Vec(None, v.type, host_values=cur)
        elif v.type is VecType.TIME:
            # the exact absolute epoch ms on the host (scalars are
            # absolute ms), rebuilt through datetime64 nanoseconds
            cur = (np.array(v.host_values, dtype=np.float64)
                   if v.host_values is not None else
                   v.as_float().cpu().numpy().astype(np.float64)
                   + v.time_offset)
            cur[ridx] = as_f64(vals)
            new_vecs[j] = time_vec(cur, device=dev)
        else:
            cur = v.as_float().cpu().numpy().astype(np.float64)
            cur[ridx] = as_f64(vals)
            new_vecs[j] = Vec.from_numpy(cur.astype(np.float32),
                                         type=VecType.NUM, device=dev)
    return Frame(list(dst.names), new_vecs)
