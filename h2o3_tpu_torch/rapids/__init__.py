"""Rapids — the frame-munging layer — the port of ``h2o3_tpu/rapids/``
(reference: ``water/rapids/``: mungers, math, reducers, operators, string
and time functions, and the lisp expression engine).
"""

from __future__ import annotations

from h2o3_tpu_torch.rapids import ops, strings, timeops
from h2o3_tpu_torch.rapids.exec import Session, rapids
from h2o3_tpu_torch.rapids.munge import (cbind, filter_rows, gather_rows,
                                         group_by, melt, merge, pivot, rbind,
                                         sort, table, unique)
from h2o3_tpu_torch.rapids.ops import cut, hist, ifelse, impute, quantile, scale


class GroupBy:
    """The chained aggregation of h2o-py's ``H2OGroupBy``:
    ``frame.group_by("k").sum("x").mean(["y", "z"]).count().get_frame()``.
    Without columns, an aggregation takes every numeric column outside the
    keys."""

    def __init__(self, frame, by):
        self._frame = frame
        self._by = [by] if isinstance(by, str) else list(by)
        self._aggs: list[tuple[str, str]] = []

    def _add(self, op, cols):
        if cols is None:
            cols = [c for c in self._frame.names
                    if c not in self._by and self._frame.vec(c).is_numeric]
        for c in ([cols] if isinstance(cols, str) else cols):
            self._aggs.append((op, c))
        return self

    def count(self):
        self._aggs.append(("nrow", self._by[0]))
        return self

    def sum(self, cols=None): return self._add("sum", cols)
    def mean(self, cols=None): return self._add("mean", cols)
    def min(self, cols=None): return self._add("min", cols)
    def max(self, cols=None): return self._add("max", cols)
    def sd(self, cols=None): return self._add("sd", cols)
    def var(self, cols=None): return self._add("var", cols)
    def median(self, cols=None): return self._add("median", cols)

    def get_frame(self):
        return group_by(self._frame, self._by, self._aggs)


__all__ = [
    "GroupBy", "Session", "cbind", "cut", "filter_rows", "gather_rows",
    "group_by", "hist", "ifelse", "impute", "melt", "merge", "ops", "pivot",
    "quantile", "rapids", "rbind", "scale", "sort", "strings", "table",
    "timeops", "unique",
]
