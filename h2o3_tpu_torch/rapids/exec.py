"""The Rapids expression engine — the port of ``h2o3_tpu/rapids/exec.py``.

Reference: ``water/rapids/Rapids.java`` (parser), ``Env.java`` (scopes),
``Session.java`` (temp-frame lifecycle). Every lazy h2o-py ``H2OFrame``
expression compiles to one of these s-expressions (``(op args...)``,
numbers, ``"strings"``, ``[num-list]``, identifiers: DKV keys and special
ops), and this module evaluates it eagerly with :mod:`h2o3_tpu_torch.rapids`
on the frames' device. Session temps live in the port's DKV
(``h2o3_tpu_torch/utils/registry.py``) until removed.

``model.testJavaScoring`` scores the frame through the model's generated
standalone source (:mod:`~h2o3_tpu_torch.genmodel.codegen`) and compares it
with ``predict``. Refused by name: ``setTimeZone`` (the time zone is fixed
to UTC, as in the reference).
"""

from __future__ import annotations

import operator as _op_mod
from typing import Any

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec, floor_divide
from h2o3_tpu_torch.rapids import munge, ops
from h2o3_tpu_torch.utils.registry import DKV

# ---------------------------------------------------------------------------
# parser


def _tokenize(s: str) -> list[str]:
    out, i, n = [], 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c in "()[]":
            out.append(c)
            i += 1
        elif c in "\"'":
            j = s.index(c, i + 1)
            out.append(s[i:j + 1])
            i = j + 1
        else:
            j = i
            while j < n and not s[j].isspace() and s[j] not in "()[]":
                j += 1
            out.append(s[i:j])
            i = j
    return out


def _parse(tokens: list[str]) -> Any:
    tok = tokens.pop(0)
    if tok == "(":
        expr = []
        while tokens[0] != ")":
            expr.append(_parse(tokens))
        tokens.pop(0)
        return expr
    if tok == "[":
        lst = []
        while tokens[0] != "]":
            lst.append(_parse(tokens))
        tokens.pop(0)
        # numeric literals stay an ndarray (row/col index lists); string
        # lists (domains, match tables, pattern lists) stay Python lists
        if all(isinstance(x, (float, np.ndarray)) for x in lst):
            return (np.concatenate([np.atleast_1d(x) for x in lst])
                    if lst else np.array([], dtype=np.float64))
        return [x[1] if isinstance(x, tuple) else x for x in lst]
    if tok[0] in "\"'":
        return ("str", tok[1:-1])
    if tok in ("TRUE", "True", "true"):
        return 1.0
    if tok in ("FALSE", "False", "false"):
        return 0.0
    if tok in ("NA", "NaN", "nan"):
        return float("nan")
    if tok.startswith("#"):      # reference numeric literal syntax
        tok = tok[1:]
    if ":" in tok:
        # AstNumList range entry (reference: water/rapids/ast/params/
        # AstNumList.java:16 — base:cnt or base:cnt:stride); h2o-py emits
        # these for frame slices (expr.py serializes fr[1:] as "[1:N]")
        parts = tok.split(":")
        if 2 <= len(parts) <= 3:
            try:
                base = float(parts[0])
                cnt = float(parts[1])
                stride = float(parts[2]) if len(parts) == 3 else 1.0
                if not np.isfinite(cnt):
                    raise ValueError(f"open-ended range {tok!r} unsupported")
                return base + stride * np.arange(int(cnt), dtype=np.float64)
            except ValueError as e:
                if "open-ended" in str(e):
                    raise
    try:
        return float(tok)
    except ValueError:
        return ("id", tok)


# ---------------------------------------------------------------------------
# evaluator

_BINOPS = {"+": "__add__", "-": "__sub__", "*": "__mul__", "/": "__truediv__",
           "^": "__pow__", "%": "__mod__",
           "<": "__lt__", "<=": "__le__", ">": "__gt__", ">=": "__ge__",
           "==": "__eq__", "!=": "__ne__", "&": "__and__", "|": "__or__"}

_PYOPS = {"+": _op_mod.add, "-": _op_mod.sub, "*": _op_mod.mul,
          "/": _op_mod.truediv, "^": _op_mod.pow, "%": _op_mod.mod,
          "<": _op_mod.lt, "<=": _op_mod.le, ">": _op_mod.gt,
          ">=": _op_mod.ge, "==": _op_mod.eq, "!=": _op_mod.ne,
          "&": lambda a, b: float(bool(a) and bool(b)),
          "|": lambda a, b: float(bool(a) or bool(b))}

_REDUCERS = {"sum": ops.vsum, "mean": ops.vmean, "min": ops.vmin,
             "max": ops.vmax, "sd": ops.vsd, "var": ops.vvar,
             "median": ops.vmedian, "any": ops.vany, "all": ops.vall,
             "prod": ops.vprod}


def _as_vec(x) -> Vec:
    if isinstance(x, Frame):
        if x.ncols != 1:
            raise ValueError("expected a single-column frame")
        return x.vecs[0]
    if isinstance(x, Vec):
        return x
    raise TypeError(f"expected a column, got {type(x).__name__}")


def _colwise(frame_or_vec, fn) -> Frame:
    if isinstance(frame_or_vec, Frame):
        return Frame(list(frame_or_vec.names), [fn(v) for v in frame_or_vec.vecs])
    return Frame(["C1"], [fn(frame_or_vec)])


class Session:
    """Temp-frame scope (reference: ``water/rapids/Session.java``)."""

    def __init__(self):
        self._tmp: dict[str, Frame] = {}

    def lookup(self, name: str):
        if name in self._tmp:
            return self._tmp[name]
        return DKV.get(name)

    def assign(self, name: str, value: Frame):
        self._tmp[name] = value
        # session temps are DKV-resident until rm'd (reference Session
        # semantics) so clients can fetch them via /3/Frames/{name}
        if isinstance(value, Frame):
            value.key = name
            DKV.put(name, value)
        return value

    def remove(self, name: str):
        """Drop a temp or DKV key (reference: ``AstRm``). Temps are also
        DKV-resident (assign puts them there), so both stores are cleared."""
        if name in self._tmp:
            del self._tmp[name]
        if name in DKV:
            DKV.remove(name)

    def end(self):
        """Session teardown drops every temp's DKV copy too (reference:
        ``Session.end`` → ``Scope`` temp-key cleanup)."""
        for name in list(self._tmp):
            self.remove(name)
        self._tmp.clear()


def rapids(expr: str, session: Session | None = None):
    """Parse and evaluate one Rapids expression (reference: ``Rapids.exec``)."""
    session = session or Session()
    return _eval(_parse(_tokenize(expr)), session)


def _sel_names(fr, sel) -> list[str]:
    """Column selection: name, list of names, or numeric index array."""
    if isinstance(sel, str):
        return [sel]
    if isinstance(sel, list):          # string-list literal ['name' 'value']
        return [str(x) for x in sel]
    return [fr.names[int(i)] for i in np.atleast_1d(sel)]


def _eval(node, s: Session):
    if isinstance(node, float) or isinstance(node, np.ndarray):
        return node
    if isinstance(node, str):
        return node
    if isinstance(node, list) and (not node or
                                   not isinstance(node[0], (tuple, list))):
        # literal list from _parse (string lists: domains, column names) —
        # expression nodes always head with an ('id', op) tuple or a nested
        # list, so a plain-value head means this IS the value
        return node
    if isinstance(node, tuple):
        kind, val = node
        if kind == "str":
            return val
        obj = s.lookup(val)
        if obj is None:
            raise KeyError(f"unknown identifier {val!r}")
        return obj
    op = node[0]
    op = op[1] if isinstance(op, tuple) else op

    if op in ("tmp=", "assign"):
        name = node[1][1] if isinstance(node[1], tuple) else str(node[1])
        return s.assign(name, _eval(node[2], s))
    if op in ("rm", "h2o.rm"):
        name = node[1][1] if isinstance(node[1], tuple) else str(node[1])
        s.remove(name)
        return 0.0

    args = [_eval(a, s) for a in node[1:]]

    if op in _BINOPS:
        a, b = args
        if isinstance(a, Frame) and isinstance(b, Frame):
            return Frame(list(a.names),
                         [getattr(x, _BINOPS[op])(y)
                          for x, y in zip(a.vecs, b.vecs)])
        if isinstance(a, Frame):
            return _colwise(a, lambda v: getattr(v, _BINOPS[op])(b))
        if isinstance(b, Frame):
            swapped = {"__add__": "__radd__", "__mul__": "__rmul__",
                       "__sub__": "__rsub__", "__truediv__": "__rtruediv__",
                       "__pow__": "__rpow__"}
            m = swapped.get(_BINOPS[op])
            if m:
                return _colwise(b, lambda v: getattr(v, m)(a))
            inverse = {"<": "__gt__", "<=": "__ge__", ">": "__lt__",
                       ">=": "__le__", "==": "__eq__", "!=": "__ne__",
                       "&": "__and__", "|": "__or__"}
            return _colwise(b, lambda v: getattr(v, inverse[op])(a))
        return float(_PYOPS[op](a, b))   # scalar ⋅ scalar

    if op in ops._UNARY:
        return _colwise(args[0], lambda v: ops.math_op(op, v))
    if op in _REDUCERS:
        return _REDUCERS[op](_as_vec(args[0]))
    if op == "ifelse":
        c, yes, no = args
        return _colwise(c, lambda v: ops.ifelse(
            v, _as_vec(yes) if isinstance(yes, Frame) else yes,
            _as_vec(no) if isinstance(no, Frame) else no))
    if op == "cols":
        fr, sel = args
        return fr[_sel_names(fr, sel)]
    if op == ":=":                  # AstRectangleAssign (dst src cols rows)
        from h2o3_tpu_torch.rapids import advprims
        return advprims.rectangle_assign(args[0], args[1], args[2], args[3])
    if op == "rows":
        fr, sel = args
        if isinstance(sel, Frame):
            return munge.filter_rows(fr, sel.vecs[0])
        return munge.gather_rows(fr, np.atleast_1d(sel).astype(np.int64))
    if op == "nrow":
        return float(args[0].nrows)
    if op == "ncol":
        return float(args[0].ncols)
    if op == "rbind":
        return munge.rbind(*args)
    if op == "cbind":
        return munge.cbind(*args)
    if op == "unique":
        return munge.unique(args[0])
    if op == "sort":
        fr, sel = args[0], args[1]
        cols = _sel_names(fr, sel)
        asc = [bool(a) for a in np.atleast_1d(args[2])] if len(args) > 2 else True
        return munge.sort(fr, cols, asc)
    if op == "merge":
        return munge.merge(args[0], args[1])
    if op == "h2o.runif":
        fr, seed = args
        rng = np.random.default_rng(int(seed) if seed >= 0 else None)
        return Frame(["rnd"], [Vec.from_numpy(
            rng.random(fr.nrows).astype(np.float32), device=fr.device)])

    # -- string prims (reference: ast/prims/string/) ------------------------
    if op == "strsplit":
        from h2o3_tpu_torch.rapids import strings as st
        parts = st.strsplit(_as_vec(args[0]), str(args[1]))
        return Frame([f"C{i + 1}" for i in range(len(parts))], parts)
    if op in _STRING_OPS:
        from h2o3_tpu_torch.rapids import strings as st
        fn = getattr(st, _STRING_OPS[op])
        extra = [int(a) if isinstance(a, float) and float(a).is_integer() else a
                 for a in args[1:]]
        return _colwise(args[0], lambda v: fn(v, *extra))
    # -- time prims (reference: ast/prims/time/) ----------------------------
    if op in _TIME_OPS:
        from h2o3_tpu_torch.rapids import timeops as tt
        fn = getattr(tt, _TIME_OPS[op])
        return _colwise(args[0], fn)
    # -- advmath / munger prims (reference: ast/prims/advmath, mungers) -----
    if op == "quantile":
        probs = np.atleast_1d(args[1]).astype(np.float64) if len(args) > 1 \
            else np.array([0.25, 0.5, 0.75])
        return args[0].quantile(list(probs))
    if op in ("cumsum", "cumprod", "cummin", "cummax"):
        return _colwise(args[0], lambda v: getattr(ops, op)(v))
    if op == "cut":
        fr = args[0]
        breaks = np.atleast_1d(args[1]).astype(np.float64)
        return _colwise(fr, lambda v: ops.cut(v, breaks))
    if op == "hist":
        nbins = int(args[1]) if len(args) > 1 else 20
        return ops.hist(_as_vec(args[0]), nbins)
    if op in ("h2o.impute", "impute"):
        col = args[1] if len(args) > 1 else None
        method = args[2] if len(args) > 2 else "mean"
        return args[0].impute(col, method=method)
    if op == "scale":
        center = bool(args[1]) if len(args) > 1 else True
        sc = bool(args[2]) if len(args) > 2 else True
        return args[0].scale(center=center, scale=sc)
    if op == "round":
        digits = int(args[1]) if len(args) > 1 else 0
        return _colwise(args[0], lambda v: ops.round_(v, digits))
    if op == "signif":
        digits = int(args[1]) if len(args) > 1 else 6
        return _colwise(args[0], lambda v: ops.signif(v, digits))
    if op == "table":
        return munge.table(args[0])
    if op == "GB" or op == "groupby":
        fr, by, agg_col, how = args[0], args[1], args[2], args[3]
        by = [by] if isinstance(by, str) else \
            [fr.names[int(i)] for i in np.atleast_1d(by)]
        return munge.group_by(fr, by, {str(agg_col): str(how)})
    if op == "pivot":
        return munge.pivot(args[0], str(args[1]), str(args[2]), str(args[3]))
    if op == "melt":
        ids = [str(v) for v in (args[1] if isinstance(args[1], list)
                                else [args[1]])]
        return munge.melt(args[0], ids)
    # -- type coercions (reference: ast/prims/operators As*) ----------------
    if op in ("as.factor", "as.character", "as.numeric", "is.na",
              "is.factor", "is.numeric"):
        fr = args[0]

        def coerce(v: Vec) -> Vec:
            dev = v.device if v.data is not None else fr.device
            if op == "as.factor":
                if v.is_categorical:
                    return v
                vals = np.asarray(v.to_numpy())
                return Vec.from_numpy(np.array(
                    ["" if (isinstance(x, float) and np.isnan(x)) else str(x)
                     for x in vals], dtype=object), device=dev)
            if op == "as.character":
                lab = v.labels() if v.is_categorical else \
                    np.array([str(x) for x in v.to_numpy()], dtype=object)
                return Vec.from_numpy(np.asarray(lab, dtype=object),
                                      type=VecType.STR)
            if op == "as.numeric":
                return Vec.from_device(v.as_float(), VecType.NUM)
            if op == "is.na":
                isna = (torch.isnan(v.as_float()) if v.data is not None
                        else torch.zeros(v.nrows, dtype=torch.bool,
                                         device=dev))
                return Vec.from_device(isna.to(torch.float32), VecType.INT)
            flag = v.is_categorical if op == "is.factor" else v.is_numeric
            return Vec.from_numpy(np.full(v.nrows, float(flag), np.float32),
                                  device=dev)
        return _colwise(fr, coerce)
    if op == "colnames":
        return [str(n) for n in args[0].names]
    if op == "colnames=":
        # AstColNames (mungers/AstColNames.java:17-55): rename selected
        # columns IN PLACE — h2o-py's ``frame.columns = [...]`` setter
        # speaks exactly this, and the reference mutates fr._names so
        # every alias (session temps, DKV entry) sees the new names
        fr = args[0]
        cols = args[1]
        cols = (list(np.atleast_1d(cols)) if isinstance(cols, np.ndarray)
                else cols if isinstance(cols, list) else [cols])
        names = args[2] if isinstance(args[2], list) else [args[2]]
        if len(cols) != len(names):
            raise ValueError("Must have the same number of column choices "
                             "as names")
        for c, nm in zip(cols, names):
            ci = int(c)
            if not 0 <= ci < fr.ncols:
                raise ValueError(f"colnames=: column index {ci} out of "
                                 f"range for {fr.ncols} columns")
            fr.names[ci] = str(nm)
        return fr
    if op == "levels":
        v = _as_vec(args[0])
        return list(v.domain or [])

    # -- prim closure (reference: remaining ast/prims families; exact op
    #    names from each Ast*.str()) — h2o3_tpu/rapids/advprims.py ---------
    from h2o3_tpu_torch.rapids import advprims as ap

    def _vec1(i=0) -> Vec:
        return _as_vec(args[i])

    def _wrap(v):
        if isinstance(v, Vec):
            return Frame(["C1"], [v])
        return v

    if op == "cor":
        fr2 = args[1] if len(args) > 1 and isinstance(args[1], Frame) else None
        use = args[2] if len(args) > 2 else "complete.obs"
        method = args[3] if len(args) > 3 else "Pearson"
        return ap.cor(args[0], fr2, str(use), str(method))
    if op == "spearman":
        return ap.cor(args[0], None, "complete.obs", "Spearman")
    if op == "distance":
        return ap.distance(args[0], args[1],
                           str(args[2]) if len(args) > 2 else "l2")
    if op == "kfold_column":
        return _wrap(ap.kfold_column(args[0], int(args[1]),
                                     int(args[2]) if len(args) > 2 else -1))
    if op == "modulo_kfold_column":
        return _wrap(ap.modulo_kfold_column(args[0], int(args[1])))
    if op == "stratified_kfold_column":
        return _wrap(ap.stratified_kfold_column(
            _vec1(), int(args[1]), int(args[2]) if len(args) > 2 else -1))
    if op in ("h2o.random_stratified_split", "stratified_split"):
        return _wrap(ap.stratified_split(
            _vec1(), float(args[1]) if len(args) > 1 else 0.2,
            int(args[2]) if len(args) > 2 else -1))
    if op == "skewness":
        return ap.skewness(_vec1(), bool(args[1]) if len(args) > 1 else True)
    if op == "kurtosis":
        return ap.kurtosis(_vec1(), bool(args[1]) if len(args) > 1 else True)
    if op == "mode":
        return ap.mode(_vec1())
    if op == "dropdup":
        keep = str(args[2]) if len(args) > 2 else "first"
        by = args[1] if len(args) > 1 else None
        if isinstance(by, (str, float, int)):
            by = [by]
        return ap.drop_duplicates(args[0], by, keep)
    if op == "x":
        return ap.mmult(args[0], args[1])
    if op == "t":
        return ap.transpose(args[0])
    if op == "ddply":
        return ap.ddply(args[0], args[1], args[2], str(args[3]))
    if op == "h2o.fillna":
        return ap.fillna(args[0], str(args[1]) if len(args) > 1 else "forward",
                         int(args[2]) if len(args) > 2 else 0,
                         int(args[3]) if len(args) > 3 else 1)
    if op == "filterNACols":
        return ap.filter_na_cols(args[0],
                                 float(args[1]) if len(args) > 1 else 0.2)
    if op == "na.omit":
        return ap.na_omit(args[0])
    if op == "nlevels":
        return ap.nlevels(_vec1())
    if op == "rank_within_groupby":
        asc = args[3] if len(args) > 3 else None
        if asc is not None and not isinstance(asc, (list, tuple, np.ndarray)):
            asc = [asc]
        return ap.rank_within_group_by(
            args[0], _aslist(args[1]), _aslist(args[2]),
            [bool(a) for a in asc] if asc is not None else None,
            str(args[4]) if len(args) > 4 else "rank",
            bool(args[5]) if len(args) > 5 else False)
    if op == "relevel":
        return _wrap(ap.relevel(_vec1(), str(args[1])))
    if op == "relevel.by.freq":
        return _wrap(ap.relevel_by_freq(
            _vec1(), None, int(args[1]) if len(args) > 1 else -1))
    if op == "rename":
        # AstRename (mungers/AstRename.java:20-46): a DKV KEY rename —
        # (rename "old" "new") — not a column rename (that is colnames=);
        # h2o.rename / model re-keying speak this form
        if len(args) == 2:
            old, new = str(args[0]), str(args[1])
            obj = s.lookup(old)
            if obj is None:
                raise KeyError(f"rename: unknown key {old!r}")
            was_temp = old in s._tmp
            s.remove(old)
            if hasattr(obj, "key"):
                obj.key = new
            if was_temp:
                # a renamed session temp stays session-scoped (reclaimed
                # by Session.end like before the rename)
                s._tmp[new] = obj
            DKV.put(new, obj)
            return float("nan")
        # legacy column-rename form (frame, col, name) kept for callers
        # that used it before colnames= existed
        return ap.rename(args[0], args[1], str(args[2]))
    if op == "setDomain":
        return _wrap(ap.set_domain(_vec1(), [str(s) for s in args[1]]))
    if op == "setLevel":
        return _wrap(ap.set_level(_vec1(), str(args[1])))
    if op == "appendLevels":
        return _wrap(ap.append_levels(_vec1(), [str(s) for s in args[1]]))
    if op == "any.factor":
        return float(ap.any_factor(args[0]))
    if op == "columnsByType":
        return ap.columns_by_type(args[0], str(args[1]))
    if op == "apply":
        return ap.apply_margin(args[0], int(args[1]), str(args[2]))
    if op == "flatten":
        return ap.flatten(args[0])
    if op == "getrow":
        return ap.getrow(args[0])
    if op == "h2o.mad":
        return ap.mad(_vec1(), float(args[1]) if len(args) > 1 else 1.4826)
    if op == "maxNA":
        return ap.max_na(_vec1())
    if op == "minNA":
        return ap.min_na(_vec1())
    if op == "sumNA":
        return ap.sum_na(_vec1())
    if op == "prod.na":
        return ap.prod_na(_vec1())
    if op == "naCnt":
        return ap.na_cnt(_vec1())
    if op == "any.na":
        return float(ap.any_na(args[0]))
    if op == "sumaxis":
        return ap.sum_axis(args[0], bool(args[1]) if len(args) > 1 else True,
                           int(args[2]) if len(args) > 2 else 0)
    if op == "topn":
        return ap.topn(args[0], args[1], float(args[2]),
                       "bottom" if len(args) > 3 and args[3] else "top")
    if op == "seq":
        return _wrap(ap.seq(float(args[0]), float(args[1]),
                            float(args[2]) if len(args) > 2 else 1.0))
    if op == "seq_len":
        return _wrap(ap.seq_len(float(args[0])))
    if op == "rep_len":
        x = _as_vec(args[0]) if isinstance(args[0], Frame) else args[0]
        return _wrap(ap.rep_len(x, float(args[1])))
    if op == "match":
        table = args[1]
        if isinstance(table, np.ndarray):
            table = [float(t) for t in table]
        elif not isinstance(table, (list, tuple)):
            table = [table]
        nomatch = float(args[2]) if len(args) > 2 else np.nan
        start = float(args[3]) if len(args) > 3 else 1
        return _wrap(ap.match(_vec1(), table, nomatch, start))
    if op == "which":
        return _wrap(ap.which(_vec1()))
    if op == "which.max":
        return ap.which_max(args[0], axis=int(args[2]) if len(args) > 2 else 0)
    if op == "which.min":
        return ap.which_min(args[0], axis=int(args[2]) if len(args) > 2 else 0)
    if op == "countmatches":
        pat = args[1] if isinstance(args[1], (list, tuple)) else [str(args[1])]
        return _colwise(args[0], lambda v: ap.count_matches(v, pat))
    if op == "strDistance":
        return _wrap(ap.str_distance(
            _vec1(0), _as_vec(args[1]), str(args[2]) if len(args) > 2 else "lv",
            bool(args[3]) if len(args) > 3 else True))
    if op == "tokenize":
        return ap.tokenize(args[0], str(args[1]))
    if op == "difflag1":
        return _wrap(ap.difflag1(_vec1()))
    if op == "isax":
        return ap.isax(args[0], int(args[1]), int(args[2]),
                       bool(args[3]) if len(args) > 3 else False)
    if op == "perfectAUC":
        return ap.perfect_auc(_vec1(0), _as_vec(args[1]))
    if op in ("replaceall", "replacefirst"):       # AstReplaceAll/First
        from h2o3_tpu_torch.rapids import strings as st
        fn = st.gsub if op == "replaceall" else st.sub
        ic = bool(args[3]) if len(args) > 3 else False
        return _colwise(args[0],
                        lambda v: fn(v, str(args[1]), str(args[2]), ic))
    if op == "num_valid_substrings":               # AstCountSubstringsWords
        from h2o3_tpu_torch.rapids import strings as st
        words = [str(wd) for wd in (args[1] if isinstance(args[1], list)
                                    else [args[1]])]
        return _colwise(args[0], lambda v: st.num_valid_substrings(v, words))
    if op == "append":                             # AstAppend: add a column
        fr, col, name = args[0], args[1], str(args[2])
        return Frame(list(fr.names), list(fr.vecs),
                     key=fr.key).add(name, _as_vec(col))
    if op == "cols_py":                            # AstColPySlice
        fr, sel = args[0], args[1]
        return fr[_sel_names(fr, sel)]
    if op == "moment":                             # AstMoment → epoch ms
        from h2o3_tpu_torch.rapids import timeops as tt
        return _colwise_or_scalar_moment(args)
    if op == "grouped_permute":                    # AstGroupedPermute
        return ap.grouped_permute(args[0], args[1], args[2], args[3],
                                  args[4])
    if op == "PermutationVarImp":
        # AstPermutationVarImp args: (model frame metric n_samples n_repeats
        # features seed) — h2o-py model_base.py:1788 sends exactly this order
        from h2o3_tpu_torch.explanation import permutation_varimp
        model = DKV[str(args[0])] if isinstance(args[0], str) else args[0]
        feats = args[5] if len(args) > 5 and isinstance(args[5], list) \
            else None
        rows = permutation_varimp(
            model, args[1], metric=str(args[2]) if len(args) > 2 else None,
            n_samples=int(args[3]) if len(args) > 3 else -1,
            n_repeats=int(args[4]) if len(args) > 4 else 1,
            features=feats,
            seed=int(args[6]) if len(args) > 6 else -1)
        names = ["Variable"] + [k for k in rows[0] if k != "variable"]
        titles = {"relative_importance": "Relative Importance",
                  "scaled_importance": "Scaled Importance",
                  "percentage": "Percentage"}
        vecs = [Vec.from_numpy(np.array([r["variable"] for r in rows],
                                        dtype=object), type=VecType.STR)]
        out_names = ["Variable"]
        for k in names[1:]:
            out_names.append(titles.get(k, k.replace("run_", "Run ")))
            vecs.append(Vec.from_numpy(np.float32([r[k] for r in rows]),
                                       device=args[1].device))
        return Frame(out_names, vecs)
    if op == "makeLeaderboard":
        # AstMakeLeaderboard (models leaderboardFrame sortMetric extensions
        # scoringData) → ranked frame (h2o.make_leaderboard)
        from h2o3_tpu_torch.models.model_base import Model
        from h2o3_tpu_torch.orchestration.leaderboard import Leaderboard
        mods = args[0] if isinstance(args[0], list) else [args[0]]
        lbfr = None
        if len(args) > 1 and args[1] not in (None, ""):
            lbfr = args[1] if isinstance(args[1], Frame) else DKV.get(str(args[1]))
        metric = str(args[2]) if len(args) > 2 and args[2] else None
        lb = Leaderboard(sort_metric=None if metric in (None, "AUTO") else
                         metric.lower(), leaderboard_frame=lbfr)
        for mk in mods:
            lb.add(mk if isinstance(mk, Model) else DKV[str(mk)])
        return lb.as_frame()
    if op == "model.reset.threshold":
        # AstModelResetThreshold: set the binomial decision threshold used by
        # predict(); returns the previous one (0.5 = argmax default)
        model = args[0] if not isinstance(args[0], str) else DKV[args[0]]
        prev = getattr(model, "_default_threshold", None)
        old = 0.5 if prev is None else float(prev)   # 0.0 is a valid threshold
        model._default_threshold = float(args[1])
        DKV.put(model.key, model)
        return old
    if op == "segment_models_as_frame":            # AstSegmentModelsAsFrame
        sm = args[0] if not isinstance(args[0], str) else DKV[args[0]]
        return sm.as_frame()
    if op == "result":                             # AstResultFrame
        # reference: ModelSelection/ANOVAGLM expose their summary as a frame
        model = args[0] if not isinstance(args[0], str) else DKV[args[0]]
        res = getattr(model, "result", None)
        if res is None:
            raise ValueError(f"model {getattr(model, 'key', args[0])!r} has "
                             "no result frame")
        rows = res() if callable(res) else res
        if isinstance(rows, Frame):
            return rows
        names = list(rows[0].keys())
        vecs = []
        for nm in names:
            col = [r.get(nm) for r in rows]
            if any(isinstance(c, (str, list, tuple)) for c in col):
                col = [", ".join(map(str, c)) if isinstance(c, (list, tuple))
                       else c for c in col]
                vecs.append(Vec.from_numpy(np.array(col, dtype=object),
                                           type=VecType.STR))
            else:
                vecs.append(Vec.from_numpy(np.float32(
                    [np.nan if c is None else c for c in col])))
        return Frame(names, vecs)
    if op == "transform":
        # AstTransformFrame (model frame) — transformer models (TargetEncoder,
        # Word2Vec) applied via Rapids
        model = args[0] if not isinstance(args[0], str) else DKV[args[0]]
        fr = args[1] if isinstance(args[1], Frame) else DKV[str(args[1])]
        return model.transform(fr)
    if op == "fairnessMetrics":
        # AstFairnessMetrics (model frame protected_cols reference
        # favourable_class) → per-protected-group metrics frame
        from h2o3_tpu_torch.models.infogram import fairness_metrics
        model = args[0] if not isinstance(args[0], str) else DKV[args[0]]
        fr = args[1] if isinstance(args[1], Frame) else DKV[str(args[1])]
        prot = args[2] if isinstance(args[2], list) else [args[2]]
        return fairness_metrics(model, fr, [str(c) for c in prot],
                                reference=[str(r) for r in args[3]]
                                if len(args) > 3 and isinstance(args[3], list)
                                else None,
                                favorable_class=str(args[4])
                                if len(args) > 4 else None)
    if op == "model.testJavaScoring":
        # AstTestJavaScoring: the reference checks in-cluster scoring
        # against the generated POJO; here against the generated numpy
        # scorer (genmodel/codegen.py), equal within eps
        from h2o3_tpu_torch.genmodel.codegen import generate_pojo
        model = args[0] if not isinstance(args[0], str) else DKV[args[0]]
        fr = args[1] if isinstance(args[1], Frame) else DKV[str(args[1])]
        eps = float(args[3]) if len(args) > 3 else 1e-6
        ns: dict = {}
        exec(compile(generate_pojo(model), "<pojo>", "exec"), ns)
        cols = []
        for c in model.output["x_cols"]:
            v = fr.vec(c)
            x = np.asarray(v.to_numpy(), np.float64)
            if v.is_categorical:
                x = np.where(x < 0, np.nan, x)
            cols.append(x)
        got = np.asarray(ns["score_batch"](np.stack(cols, axis=1)))
        ours = model.predict(fr)
        if model.is_classifier:
            a = np.stack([np.asarray(ours.vec(nm).to_numpy())
                          for nm in ours.names[1:]], axis=1)
            b = got[:, 1:] if got.shape[1] == a.shape[1] + 1 else got
        else:
            a = np.asarray(ours.vec("predict").to_numpy())
            b = got[:, 0] if got.ndim == 2 else got
        return float(np.allclose(a, b, atol=eps, rtol=eps))
    if op == "ls":                                 # AstLs → key listing
        keys = DKV.keys()
        return Frame(["key"], [Vec.from_numpy(
            np.array(keys, dtype=object), type=VecType.STR)])
    if op == "getTimeZone":
        return "UTC"      # device times are canonical UTC epoch ms
    if op == "listTimeZones":
        import zoneinfo
        return sorted(zoneinfo.available_timezones())
    if op == "setTimeZone":
        raise ValueError("time zone is fixed to UTC in this runtime "
                         "(reference ParseTime zone applies at parse)")
    if op in ("mod", "%%", "intDiv", "%/%"):     # ("%" routes via _BINOPS)
        fn = torch.remainder if op in ("mod", "%%") else floor_divide

        def asf(x):
            return _as_vec(x).as_float() if isinstance(x, Frame) else (
                x.as_float() if isinstance(x, Vec) else float(x))
        a, b = args[0], args[1]
        if isinstance(a, (Frame, Vec)):
            bb = asf(b)
            return _colwise(a, lambda v: _vec_binop(v, bb, fn))
        if isinstance(b, (Frame, Vec)):          # scalar on the left
            aa = float(a)
            return _colwise(b, lambda v: _vec_binop(
                v, aa, lambda x, y: fn(torch.full_like(x, y), x)))
        # a float32 scalar pair, as jnp computes it
        hfn = np.mod if op in ("mod", "%%") else np.floor_divide
        return float(hfn(np.float32(a), np.float32(b)))
    raise ValueError(f"unknown rapids op {op!r}")


def _colwise_or_scalar_moment(args):
    """AstMoment: (moment yr mo dy hr mi se ms) of scalars and/or columns
    → single TIME column."""
    from h2o3_tpu_torch.rapids import timeops as tt
    vals = list(args[:7]) + [0.0] * (7 - len(args))
    n = max((a.nrows for a in vals if isinstance(a, (Frame, Vec))), default=1)

    def as_v(x, default):
        if isinstance(x, Frame):
            x = _as_vec(x)
        if isinstance(x, Vec):
            return x
        return Vec.from_numpy(np.full(n, float(default if x is None else x),
                                      np.float32))
    y, mo, d, h, mi, s, ms = (as_v(vals[0], 1970), as_v(vals[1], 1),
                              as_v(vals[2], 1), as_v(vals[3], 0),
                              as_v(vals[4], 0), as_v(vals[5], 0),
                              as_v(vals[6], 0))
    t = tt.mktime(y, mo, d, h, mi, s)
    msec = ms.to_numpy().astype(np.float64)
    vals_ms = t.host_values[: t.nrows] + msec[: t.nrows]
    out = np.full(t.nrows, np.datetime64("NaT"), "datetime64[ms]")
    ok = ~np.isnan(vals_ms)
    out[ok] = vals_ms[ok].astype(np.int64).astype("datetime64[ms]")
    return Frame(["time"], [Vec.from_numpy(out, type=VecType.TIME,
                                           device=t.device)])


def _aslist(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, np.ndarray):
        return [float(v) for v in x]
    return [x]


def _vec_binop(v: Vec, b, fn) -> Vec:
    return Vec.from_device(fn(v.as_float(), b).to(torch.float32), VecType.NUM)


#: ops handled by the dispatch if-chain above (kept in sync by
#: tests/test_rapids.py::test_prims_inventory exercising /99/Rapids/help)
_CHAIN_OPS = (
    "tmp=", "assign", "rm", "h2o.rm", "ifelse", "cols", "rows", "nrow",
    "ncol", "rbind",
    "cbind", "unique", "sort", "merge", "h2o.runif", "strsplit", "quantile",
    "cumsum", "cumprod", "cummin", "cummax", "cut", "hist", "h2o.impute",
    "impute", "scale", "round", "signif", "table", "GB", "groupby", "pivot",
    "melt", "as.factor", "as.character", "as.numeric", "is.na", "is.factor",
    "is.numeric", "colnames", "colnames=", "levels",
    # prim closure (rapids/advprims.py)
    "cor", "spearman", "distance", "kfold_column", "modulo_kfold_column",
    "stratified_kfold_column", "h2o.random_stratified_split", "skewness",
    "kurtosis", "mode", "dropdup", "x", "t", "ddply", "h2o.fillna",
    "filterNACols", "na.omit", "nlevels", "rank_within_groupby", "relevel",
    "relevel.by.freq", "rename", "setDomain", "setLevel", "appendLevels",
    "any.factor", "columnsByType", "apply", "flatten", "getrow", "h2o.mad",
    "maxNA", "minNA", "sumNA", "prod.na", "naCnt", "any.na", "sumaxis",
    "topn", "seq", "seq_len", "rep_len", "match", "which", "which.max",
    "which.min", "countmatches", "strDistance", "tokenize", "difflag1",
    "isax", "perfectAUC", "mod", "%%", "intDiv", "%/%", ":=",
    "replaceall", "replacefirst", "num_valid_substrings", "append",
    "cols_py", "moment", "getTimeZone", "listTimeZones", "setTimeZone", "ls",
    "PermutationVarImp", "grouped_permute",
    # models family closure (ast/prims/models/)
    "makeLeaderboard", "model.reset.threshold", "segment_models_as_frame",
    "result", "transform", "fairnessMetrics", "model.testJavaScoring",
)


def known_prims() -> set[str]:
    """Every rapids primitive this engine evaluates (the `/99/Rapids/help`
    surface; reference: ast/prims/* file inventory)."""
    return (set(_BINOPS) | set(ops._UNARY) | set(_REDUCERS)
            | set(_STRING_OPS) | set(_TIME_OPS) | set(_CHAIN_OPS))


_STRING_OPS = {
    "toupper": "toupper", "tolower": "tolower", "trim": "trim",
    "lstrip": "lstrip", "rstrip": "rstrip", "nchar": "nchar",
    "substring": "substring", "sub": "sub", "gsub": "gsub",
    "grep": "grep", "entropy": "entropy",
    "startsWith": "startswith", "endsWith": "endswith",
}

_TIME_OPS = {
    "year": "year", "month": "month", "day": "day", "hour": "hour",
    "minute": "minute", "second": "second", "millis": "millis",
    "dayOfWeek": "day_of_week", "week": "week",
}
