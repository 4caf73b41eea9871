"""Frame mungers: gather, sort, group-by, merge, rbind/cbind, unique, table,
pivot, melt and row filters — the port of ``h2o3_tpu/rapids/munge.py``.

Reference: ``water/rapids/ast/prims/mungers/`` (``AstGroup``, ``AstMerge``,
``AstSort``, ``AstPivot``, ``AstMelt``, ``AstRBind``/``AstCBind``,
``AstUnique``) and the sort/merge engine (``water/rapids/RadixOrder.java``,
``BinaryMerge.java``). Sorting is a chain of stable ``torch.sort`` calls
from the minor key to the major one (torch has no lexsort); group ids come
from the sorted order (a boundary where any key changes, then a cumsum);
group reductions are ``index_add_`` and ``scatter_reduce_`` into one bucket
per group. A merge's row plan is built on the frames' device with
``searchsorted`` and ``repeat_interleave``, row for row the reference's.

The port's columns carry no padding, so every row is valid; sums, means
and variances accumulate in float64 (the reference adds float32), and a
variance sums squares about the group's mean (the reference's one-pass
formula cancels).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import CAT_NA, VecType
from h2o3_tpu_torch.frame.vec import Vec, _guess_type

# ---------------------------------------------------------------------------
# gathers


def _gather_vec(v: Vec, idx: torch.Tensor, idx_host) -> Vec:
    """A new Vec of ``v``'s values at ``idx`` (-1 → missing)."""
    if v.data is None:
        host = idx_host()
        out = np.full(len(host), None, dtype=object)
        ok = host >= 0
        out[ok] = v.host_values[host[ok]]
        return Vec(None, v.type, domain=v.domain, host_values=out)
    fill = CAT_NA if v.type is VecType.CAT else float("nan")
    g = v.data[idx.clamp(0, max(v.nrows - 1, 0))]
    g = torch.where(idx < 0, torch.full_like(g, fill), g)
    out = Vec(g, v.type, domain=v.domain, time_offset=v.time_offset)
    if v.type is VecType.TIME and v.host_values is not None:
        host = idx_host()
        out.host_values = np.where(
            host >= 0, v.host_values[np.clip(host, 0, None)], np.nan)
    return out


def gather_rows(frame: Frame, idx) -> Frame:
    """The frame's rows at ``idx`` (host array or tensor; -1 → an all-NA
    row), as a new Frame on the frame's device: the reference's row slice
    and merge materialization."""
    if isinstance(idx, torch.Tensor):
        idx_dev = idx.to(frame.device, torch.long)
    else:
        idx_dev = torch.as_tensor(np.asarray(idx, np.int64),
                                  device=frame.device)
    host: list = []

    def idx_host() -> np.ndarray:
        if not host:
            host.append(idx_dev.cpu().numpy())
        return host[0]

    return Frame(list(frame.names),
                 [_gather_vec(v, idx_dev, idx_host) for v in frame.vecs])


# ---------------------------------------------------------------------------
# sort


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable order of rows by ``keys``, the major key first (``jnp.
    lexsort`` takes them the other way round): one stable sort per key,
    from the minor key to the major one."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        idx = torch.sort(kk, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def _nan_last(k: torch.Tensor) -> torch.Tensor:
    """A sort key: NaN as +inf, and -0.0 as 0.0 (the card's radix sort
    puts -0.0 first; ``jnp`` sorts the two as one value)."""
    return torch.where(torch.isnan(k), torch.inf, k) + 0.0


def _float_keys(frame: Frame, by: Sequence[str], ascending: Sequence[bool]):
    keys = []
    for col, asc in zip(by, ascending):
        k = frame.vec(col).as_float()
        keys.append(_nan_last(k if asc else -k))      # NAs sort last
    return keys


def sort_perm(frame: Frame, by: Sequence[str], ascending) -> torch.Tensor:
    """The permutation of rows (a device tensor) that orders ``frame`` by
    ``by``."""
    if isinstance(ascending, bool):
        ascending = [ascending] * len(by)
    if frame.nrows == 0:
        return torch.zeros(0, dtype=torch.long, device=frame.device)
    return lexsort(_float_keys(frame, by, ascending))


def sort(frame: Frame, by: str | Sequence[str], ascending=True) -> Frame:
    """Reference: ``AstSort`` / ``Merge.sort`` — stable multi-column sort,
    NAs last."""
    by = [by] if isinstance(by, str) else list(by)
    return gather_rows(frame, sort_perm(frame, by, ascending))


# ---------------------------------------------------------------------------
# group ids (shared by group_by / merge / pivot / unique)


def _group_ids(key_cols: list[torch.Tensor]):
    """(gid [n] int64 in the rows' order, ngroups, rep [ngroups] int64: the
    first row of each group). Groups are numbered in the keys' sorted order
    (NaN keys last, one group), so ``rep`` lists the groups sorted. One
    host fetch: the group count."""
    n = key_cols[0].shape[0]
    dev = key_cols[0].device
    if n == 0:
        return (torch.zeros(0, dtype=torch.long, device=dev), 0,
                torch.zeros(0, dtype=torch.long, device=dev))
    keys = [_nan_last(k) for k in key_cols]
    perm = lexsort(keys)
    differs = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in keys:
        s = k[perm]
        differs[1:] |= s[1:] != s[:-1]
    gid_sorted = torch.cumsum(differs, 0)
    ngroups = int(gid_sorted[-1]) + 1
    gid = torch.empty(n, dtype=torch.long, device=dev)
    gid[perm] = gid_sorted
    # a group's first row in the sorted order is its least row index (the
    # sorts are stable); the other rows scatter into a junk bucket
    start = differs.index_fill(0, torch.zeros(1, dtype=torch.long,
                                              device=dev), True)
    rep = torch.empty(ngroups + 1, dtype=torch.long, device=dev)
    rep.scatter_(0, torch.where(start, gid_sorted, ngroups), perm)
    return gid, ngroups, rep[:ngroups]


def frame_group_ids(frame: Frame, by: Sequence[str]):
    return _group_ids([frame.vec(c).as_float() for c in by])


def segment_sum(x: torch.Tensor, gid: torch.Tensor, nseg: int
                ) -> torch.Tensor:
    """Sums of ``x`` by segment id (``jax.ops.segment_sum``)."""
    return torch.zeros(nseg, dtype=x.dtype, device=x.device).index_add_(
        0, gid, x)


def segment_reduce(x: torch.Tensor, gid: torch.Tensor, nseg: int, how: str,
                   init) -> torch.Tensor:
    """"amin" or "amax" of ``x`` by segment id; ``init`` where a segment is
    empty (``jax.ops.segment_min``/``segment_max`` give the identity)."""
    return torch.full((nseg,), init, dtype=x.dtype, device=x.device
                      ).scatter_reduce_(0, gid, x, how, include_self=True)


# ---------------------------------------------------------------------------
# group-by

_AGG_OPS = ("count", "nrow", "sum", "mean", "min", "max", "var", "sd",
            "median", "first", "last")


def _agg(op: str, frame: Frame, col: str, gid: torch.Tensor, nseg: int
         ) -> torch.Tensor:
    """One aggregate of one column by group, [nseg] float32 on the frame's
    device; NaN where a group has no value (count and nrow aside)."""
    x = frame.vec(col).as_float()
    n = x.shape[0]
    valid = ~torch.isnan(x)
    cnt = segment_sum(valid.to(torch.float64), gid, nseg)
    if op in ("count", "nrow"):
        # rows per group: a row whose value (or key) is NA still counts
        return segment_sum(torch.ones(n, dtype=torch.int64, device=x.device),
                           gid, nseg).to(torch.float32)
    xv = torch.where(valid, x, 0.0).to(torch.float64)
    if op == "sum":
        agg = segment_sum(xv, gid, nseg)
    elif op == "mean":
        agg = segment_sum(xv, gid, nseg) / cnt.clamp_min(1.0)
    elif op == "min":
        agg = segment_reduce(torch.where(valid, x, torch.inf), gid, nseg,
                             "amin", torch.inf)
    elif op == "max":
        agg = segment_reduce(torch.where(valid, x, -torch.inf), gid, nseg,
                             "amax", -torch.inf)
    elif op in ("var", "sd"):
        # two passes, about each group's mean: the reference's one-pass
        # (ss - s²/n) / (n - 1) cancels when the mean is large
        mean = segment_sum(xv, gid, nseg) / cnt.clamp_min(1.0)
        d = torch.where(valid, xv - mean[gid], 0.0)
        var = segment_sum(d * d, gid, nseg) / (cnt - 1.0).clamp_min(1.0)
        agg = var.sqrt() if op == "sd" else var
    elif op in ("first", "last"):
        row = torch.arange(n, device=x.device)
        if op == "first":
            ridx = segment_reduce(torch.where(valid, row, n), gid, nseg,
                                  "amin", n)
        else:
            ridx = segment_reduce(torch.where(valid, row, -1), gid, nseg,
                                  "amax", -1)
        ok = (ridx >= 0) & (ridx < n)
        agg = torch.where(ok, x[ridx.clamp(0, n - 1)], torch.nan) if n \
            else torch.full((nseg,), torch.nan, device=x.device)
    else:
        agg = _group_median(frame, col, gid, nseg)
    return torch.where(cnt > 0, agg.to(torch.float32), torch.nan)


def group_by(frame: Frame, by: str | Sequence[str],
             aggs: Mapping[str, Sequence[str]] | Sequence[tuple[str, str]]
             ) -> Frame:
    """Grouped aggregation (reference: ``AstGroup``; h2o-py
    ``H2OFrame.group_by``). ``aggs``: ``{"col": ["mean", "sum"], ...}`` or
    ``[("mean", "col"), ...]``. NAs in aggregated columns are left out
    (``na="rm"``); rows with an NA key form one group of their own. The
    groups come sorted by their keys, named ``{op}_{col}`` (``nrow``)."""
    by = [by] if isinstance(by, str) else list(by)
    if isinstance(aggs, Mapping):
        pairs = [(op, col) for col, ops in aggs.items()
                 for op in ([ops] if isinstance(ops, str) else ops)]
    else:
        pairs = [(op, col) for op, col in aggs]
    for op, col in pairs:
        if op not in _AGG_OPS:
            raise ValueError(f"unknown agg {op!r}; have {_AGG_OPS}")
        frame.vec(col)   # raises on a missing column

    gid, ng, rep = frame_group_ids(frame, by)
    out = gather_rows(frame[by], rep)
    if not pairs:
        return out
    # one bucket beyond the groups, as the reference's junk bucket
    vals = torch.stack([_agg(op, frame, col, gid, ng + 1)[:ng]
                        for op, col in pairs])
    for (op, col), v, h in zip(pairs, vals, vals.cpu().numpy()):
        name = f"{op}_{col}" if op != "nrow" else "nrow"
        while name in out.names:
            name += "_"
        # typed as a parsed column (INT where every value is whole), from
        # the one fetch of every aggregate
        out.add(name, Vec(v, _guess_type(h)))
    # the groups are numbered in the keys' sorted order, so ``out`` is
    # already sorted by ``by`` (the reference sorts it once more)
    return out


def _group_median(frame: Frame, col: str, gid: torch.Tensor, nseg: int
                  ) -> torch.Tensor:
    """The median of each group's values (the mean of the two middle ones),
    from one sort by (group, value)."""
    x = frame.vec(col).as_float()
    n = x.shape[0]
    if n == 0:
        return torch.full((nseg,), torch.nan, device=x.device)
    valid = ~torch.isnan(x)
    perm = lexsort([torch.where(valid, gid, nseg),
                    torch.where(valid, x, torch.inf)])
    sx = x[perm]
    cnt = segment_sum(valid.to(torch.int64), gid, nseg)
    start = torch.cumsum(cnt, 0) - cnt
    c1 = cnt.clamp_min(1)
    lo = (start + (c1 - 1) // 2).clamp(0, n - 1)
    hi = (start + c1 // 2).clamp(0, n - 1)
    return (sx[lo] + sx[hi]) / 2.0


# ---------------------------------------------------------------------------
# merge / join


def merge(left: Frame, right: Frame, by: Sequence[str] | None = None,
          all_x: bool = False, all_y: bool = False) -> Frame:
    """Equi-join on key columns (reference: ``AstMerge`` over
    ``BinaryMerge``; h2o-py ``H2OFrame.merge(all_x=, all_y=)``).

    Group ids over both frames' keys (one shared sort), then the plan of
    (left row, right row) pairs: each left row in order with its matching
    right rows in their order (one all-NA right row under ``all_x`` where
    none match), then under ``all_y`` the unmatched right rows. NA keys
    match NA keys, as in the reference."""
    if by is None:
        by = [c for c in left.names if c in right.names]
    by = list(by)
    if not by:
        raise ValueError("no common key columns to merge on")
    dev = left.device
    nl, nr = left.nrows, right.nrows
    keys = [torch.cat([left.vec(c).as_float(),
                       _align_key(left.vec(c), right.vec(c)).to(dev)])
            for c in by]
    gid, _, _ = _group_ids(keys)
    gl, gr = gid[:nl], gid[nl:]

    order_r = torch.sort(gr, stable=True).indices
    grs = gr[order_r]
    starts = torch.searchsorted(grs, gl, right=False)
    cnt = torch.searchsorted(grs, gl, right=True) - starts
    keep = cnt > 0
    out_cnt = torch.where(keep, cnt, 1 if all_x else 0)
    tot = int(out_cnt.sum())
    left_plan = torch.repeat_interleave(torch.arange(nl, device=dev),
                                        out_cnt, output_size=tot)
    first = torch.cumsum(out_cnt, 0) - out_cnt
    pos = torch.arange(tot, device=dev) - torch.repeat_interleave(
        first, out_cnt, output_size=tot)
    base = torch.repeat_interleave(torch.where(keep, starts, -1), out_cnt,
                                   output_size=tot)
    if nr:
        right_plan = torch.where(base >= 0,
                                 order_r[(base + pos).clamp(0, nr - 1)], -1)
    else:
        right_plan = torch.full((tot,), -1, dtype=torch.long, device=dev)

    if all_y:
        hits = segment_sum(torch.ones(tot, dtype=torch.int64, device=dev),
                           torch.where(right_plan >= 0, right_plan, nr),
                           nr + 1)[:nr]
        extra = torch.nonzero(hits == 0).squeeze(1)
        left_plan = torch.cat([left_plan, torch.full_like(extra, -1)])
        right_plan = torch.cat([right_plan, extra])

    lf = gather_rows(left, left_plan)
    right_rest = [c for c in right.names if c not in by]
    rf = gather_rows(right[right_rest], right_plan) if right_rest else None
    if all_y and len(right_plan):
        # right-only rows take their key values from the right frame
        rk = gather_rows(right[by], right_plan)
        miss = left_plan < 0
        for c in by:
            lf.replace_vec(c, _merged_key(lf.vec(c), rk.vec(c), miss))
    if rf is not None:
        for c in right_rest:
            name = c if c not in lf.names else c + "_y"
            lf.add(name, rf.vec(c))
    return lf


def _merged_key(lv: Vec, rv: Vec, miss: torch.Tensor) -> Vec:
    """A key column of an ``all_y`` merge: the left's values, the right's
    where the left row is missing. A categorical key's domain becomes the
    levels present in the result, sorted (the reference rebuilds it from
    the labels); a TIME key keeps its exact epoch ms."""
    if lv.is_categorical:
        union = sorted(set(lv.domain) | set(rv.domain))
        at = {s: i for i, s in enumerate(union)}

        def in_union(v: Vec) -> torch.Tensor:
            lut = torch.tensor([at[s] for s in v.domain] + [CAT_NA],
                               dtype=torch.int32, device=v.device)
            return lut[torch.where(v.data >= 0, v.data.long(), -1)]
        codes = torch.where(miss, in_union(rv), in_union(lv))
        ok = codes >= 0
        present = segment_sum(ok.to(torch.int64),
                              torch.where(ok, codes.long(), len(union)),
                              len(union) + 1)[:len(union)] > 0
        keep = present.cpu().numpy()
        remap = (torch.cumsum(present, 0) - 1).to(torch.int32)
        codes = torch.where(ok, remap[codes.long().clamp_min(0)], CAT_NA)
        return Vec(codes, VecType.CAT,
                   domain=tuple(s for s, k in zip(union, keep) if k))
    if lv.type is VecType.TIME and lv.host_values is not None:
        from h2o3_tpu_torch.rapids.timeops import ms_to_datetime64
        m = miss.cpu().numpy()
        return Vec.from_numpy(ms_to_datetime64(
            np.where(m, rv.to_numpy(), lv.to_numpy())), type=VecType.TIME,
            device=lv.device)
    return Vec(torch.where(miss, rv.data, lv.data), lv.type)


def _align_key(lv: Vec, rv: Vec) -> torch.Tensor:
    """The right key column as floats comparable with the left's: levels
    remapped onto the left's domain (a level the left lacks becomes the
    distinct finite value -2 - code, so it matches nothing but stays a
    valid row); a TIME key shifted into the left's offset."""
    if lv.is_categorical != rv.is_categorical:
        raise TypeError("merge key type mismatch (categorical vs numeric)")
    if lv.type is VecType.TIME or rv.type is VecType.TIME:
        return rv.as_float() + (rv.time_offset - lv.time_offset)
    if not rv.is_categorical or lv.domain == rv.domain:
        return rv.as_float()
    ldom = {s: i for i, s in enumerate(lv.domain)}
    lut = torch.tensor([ldom.get(s, -2.0) for s in rv.domain] + [-2.0],
                       dtype=torch.float32, device=rv.device)
    codes = rv.data.long()
    mapped = torch.where(codes < 0, torch.nan,
                         lut[codes.clamp(-1, len(rv.domain) - 1)])
    return torch.where(mapped < -1.5, -2.0 - codes.to(torch.float32), mapped)


# ---------------------------------------------------------------------------
# rbind / cbind


def rbind(*frames: Frame) -> Frame:
    """Stack frames by rows (reference: ``AstRBind``); categorical domains
    are unioned (sorted) and codes remapped."""
    if len(frames) == 1:
        return frames[0]
    base = frames[0]
    for f in frames[1:]:
        if f.names != base.names:
            raise ValueError("rbind: column names differ")
    dev = base.device
    out_vecs = []
    for ci, name in enumerate(base.names):
        vs = [f.vecs[ci] for f in frames]
        t = vs[0].type
        if any(v.type is not t for v in vs):
            raise ValueError(f"rbind: column {name!r} types differ")
        if t is VecType.CAT:
            dom = sorted(set().union(*(v.domain for v in vs)))
            at = {s: i for i, s in enumerate(dom)}
            parts = []
            for v in vs:
                lut = torch.tensor([at[s] for s in v.domain] + [CAT_NA],
                                   dtype=torch.int32, device=dev)
                parts.append(lut[torch.where(v.data >= 0, v.data.long(),
                                             -1).to(dev)])
            out_vecs.append(Vec(torch.cat(parts), t, domain=tuple(dom)))
        elif t is VecType.TIME:
            from h2o3_tpu_torch.rapids.timeops import ms_to_datetime64
            ms = np.concatenate([np.asarray(v.to_numpy(), np.float64)
                                 for v in vs])
            out_vecs.append(Vec.from_numpy(ms_to_datetime64(ms), type=t,
                                           device=dev))
        elif vs[0].data is not None:
            out_vecs.append(Vec(torch.cat([v.data.to(dev) for v in vs]), t))
        else:
            out_vecs.append(Vec(None, t, host_values=np.concatenate(
                [v.host_values for v in vs])))
    return Frame(list(base.names), out_vecs)


def cbind(*frames: Frame) -> Frame:
    """Bind frames by columns (reference: ``AstCBind``); a repeated name
    gets a numeric suffix."""
    names: list[str] = []
    vecs: list[Vec] = []
    nrows = frames[0].nrows
    for f in frames:
        if f.nrows != nrows:
            raise ValueError("cbind: row counts differ")
        for n, v in zip(f.names, f.vecs):
            name, i = n, 0
            while name in names:
                name = f"{n}{i}"
                i += 1
            names.append(name)
            vecs.append(v)
    return Frame(names, vecs)


# ---------------------------------------------------------------------------
# unique / table / pivot / melt


def unique(frame: Frame, cols: Sequence[str] | None = None) -> Frame:
    """Distinct rows of the selected columns, sorted (reference:
    ``AstUnique``)."""
    cols = list(cols) if cols is not None else list(frame.names)
    _, _, rep = frame_group_ids(frame, cols)
    return gather_rows(frame[cols], rep)   # reps come in sorted order


def table(frame: Frame, cols: Sequence[str] | None = None) -> Frame:
    """Level-combination counts (reference: ``AstTable``)."""
    cols = list(cols) if cols is not None else list(frame.names)
    return group_by(frame, cols, [("nrow", cols[0])])


def pivot(frame: Frame, index: str, column: str, value: str,
          agg: str = "mean") -> Frame:
    """Long → wide (reference: ``AstPivot``): one row per ``index`` group
    (sorted), one column per level of the categorical ``column``."""
    cv = frame.vec(column)
    if not cv.is_categorical:
        raise TypeError("pivot column must be categorical")
    if agg not in ("count", "sum", "mean", "min", "max"):
        raise ValueError(f"unknown pivot agg {agg!r}")
    K = cv.cardinality()
    gid, ng, rep = frame_group_ids(frame, [index])
    nseg = ng + 1
    x = frame.vec(value).as_float()
    code = cv.data.long()
    valid = ~torch.isnan(x) & (code >= 0)
    comb = torch.where(valid, gid * K + code.clamp(0, max(K - 1, 0)),
                       nseg * K)
    ncell = nseg * K + 1
    cnt = segment_sum(valid.to(torch.float64), comb, ncell)
    xv = torch.where(valid, x, 0.0).to(torch.float64)
    if agg == "count":
        cells = cnt
    elif agg == "sum":
        cells = segment_sum(xv, comb, ncell)
    elif agg == "mean":
        cells = segment_sum(xv, comb, ncell) / cnt.clamp_min(1.0)
    elif agg == "min":
        cells = segment_reduce(torch.where(valid, x, torch.inf), comb, ncell,
                               "amin", torch.inf)
    else:
        cells = segment_reduce(torch.where(valid, x, -torch.inf), comb,
                               ncell, "amax", -torch.inf)
    cells = cells.to(torch.float32)
    if agg != "count":
        cells = torch.where(cnt > 0, cells, torch.nan)
    cells = cells[: ng * K].reshape(ng, K).T.contiguous()
    host = cells.cpu().numpy()
    out = gather_rows(frame[[index]], rep)     # sorted by ``index``
    for k, lev in enumerate(cv.domain):
        out.add(str(lev), Vec(cells[k], _guess_type(host[k])))
    return out


def melt(frame: Frame, id_vars: Sequence[str],
         value_vars: Sequence[str] | None = None,
         var_name: str = "variable", value_name: str = "value") -> Frame:
    """Wide → long (reference: ``AstMelt``)."""
    id_vars = list(id_vars)
    value_vars = list(value_vars) if value_vars is not None else \
        [c for c in frame.names if c not in id_vars]
    dev = frame.device
    blocks = []
    for var in value_vars:
        b = Frame(list(id_vars), [frame.vec(c) for c in id_vars])
        b.add(var_name, Vec(torch.zeros(frame.nrows, dtype=torch.int32,
                                        device=dev), VecType.CAT,
                            domain=(str(var),)))
        b.add(value_name, Vec(frame.vec(var).as_float(), VecType.NUM))
        blocks.append(b)
    return rbind(*blocks)


# ---------------------------------------------------------------------------
# row filtering


def filter_rows(frame: Frame, mask) -> Frame:
    """Rows where ``mask`` (a Vec or a tensor) is truthy (reference: the
    boolean row slice ``AstRowSlice``); an NA mask value drops the row."""
    m = mask.as_float() if isinstance(mask, Vec) else torch.as_tensor(mask)
    m = m.to(frame.device, torch.float32)
    keep = (m > 0) & ~torch.isnan(m)
    return gather_rows(frame, torch.nonzero(keep).squeeze(1))
