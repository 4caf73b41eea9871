"""Leaderboard — ranked model container — the port of
``h2o3_tpu/orchestration/leaderboard.py``.

Reference: ``hex/leaderboard/Leaderboard.java``: ranks models by a sort
metric chosen from the problem type, from a shared leaderboard frame or
each model's CV, validation or training metrics, with the wire table's
columns (``Leaderboard.java:776``). ``as_frame`` builds ``model_id`` and
``algo`` through ``Frame.from_arrays``, which makes strings categorical
in the port (the JAX package's string type is not ported).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Model
from h2o3_tpu_torch.orchestration.grid import (default_metric,
                                               metric_higher_is_better)

#: the metrics a row holds, where the model's metrics have them
_ROW_METRICS = ("auc", "pr_auc", "logloss", "mean_per_class_error", "rmse",
                "mse", "mae", "r2", "accuracy", "rmsle",
                "mean_residual_deviance")


class Leaderboard:
    def __init__(self, sort_metric: str | None = None,
                 leaderboard_frame: Frame | None = None):
        self.sort_metric = sort_metric
        self.leaderboard_frame = leaderboard_frame
        self._rows: list[dict] = []

    def add(self, model: Model) -> None:
        if self.leaderboard_frame is not None and \
                model.response_column in self.leaderboard_frame:
            mm = model.model_performance(self.leaderboard_frame)
        else:
            mm = (model.cross_validation_metrics or model.validation_metrics
                  or model.training_metrics)
        if mm is None:
            return
        row = {"model_id": model.key, "algo": model.algo,
               "training_time_ms": model.run_time_ms, "_model": model}
        for f in _ROW_METRICS:
            if hasattr(mm, f):
                v = getattr(mm, f)
                row[f] = float(v() if callable(v) else v)
        self._rows.append(row)

    def _sorted(self) -> list[dict]:
        if not self._rows:
            return []
        metric = self.sort_metric or default_metric(self._rows[0]["_model"])
        dec = metric_higher_is_better(metric)
        return sorted(self._rows,
                      key=lambda r: (np.isnan(r.get(metric, np.nan)),
                                     -r.get(metric, np.nan) if dec
                                     else r.get(metric, np.nan)))

    @property
    def models(self) -> list[Model]:
        return [r["_model"] for r in self._sorted()]

    @property
    def leader(self) -> Model | None:
        ms = self.models
        return ms[0] if ms else None

    def as_frame(self) -> Frame:
        """The leaderboard as a Frame (reference:
        ``Leaderboard.toTwoDimTable``)."""
        rows = self._sorted()
        if not rows:
            return Frame([], [])
        cols = [k for k in rows[0] if k != "_model"]
        data = {c: np.array([r.get(c, np.nan) for r in rows],
                            dtype=object if c in ("model_id", "algo")
                            else float)
                for c in cols}
        return Frame.from_arrays(data)

    def table(self, extensions: Sequence[str] | None = None):
        """The wire table (reference ``Leaderboard.toTwoDimTable``,
        ``hex/leaderboard/Leaderboard.java:776``): column specs, row-major
        cells, the sort metric, its direction and values, and the ranked
        model ids. The metric columns follow ``defaultMetricsForModel``
        (``Leaderboard.java:681``); ``extensions`` ("ALL" or named) appends
        the extension columns."""
        rows = self._sorted()
        if not rows:
            return ([("model_id", "string", "%s")], [],
                    self.sort_metric or "auc", True, [], [])
        model = rows[0]["_model"]
        if model.nclasses == 2:
            metrics = ["auc", "logloss", "aucpr", "mean_per_class_error",
                       "rmse", "mse"]
        elif model.nclasses > 2:
            metrics = ["mean_per_class_error", "logloss", "rmse", "mse"]
        else:
            metrics = ["rmse", "mse", "mae", "rmsle",
                       "mean_residual_deviance"]
        sort_metric = self.sort_metric or default_metric(model)
        # the table shows wire names (aucpr), rows keep attribute names
        wire_sort = {"pr_auc": "aucpr"}.get(sort_metric, sort_metric)
        if wire_sort in metrics and metrics[0] != wire_sort:
            metrics.remove(wire_sort)
            metrics.insert(0, wire_sort)
        elif wire_sort not in metrics:
            metrics.insert(0, wire_sort)
        sort_metric = wire_sort
        ext = [e.lower() for e in (extensions or [])]
        known_ext = ("training_time_ms", "predict_time_per_row_ms", "algo")
        ext_cols = (list(known_ext) if "all" in ext
                    else [e for e in ext if e in known_ext])

        def cell(r, m):
            v = r.get({"aucpr": "pr_auc"}.get(m, m), np.nan)
            return float(v) if v is not None else np.nan

        cols = [("model_id", "string", "%s")]
        cols += [(m, "double", "%.6f") for m in metrics]
        cols += [(("algo", "string", "%s") if e == "algo" else
                  (e, "double", "%.1f")) for e in ext_cols]
        out_rows = []
        for r in rows:
            row = [r["model_id"]] + [cell(r, m) for m in metrics]
            for e in ext_cols:
                if e == "algo":
                    row.append(r.get("algo", ""))
                else:
                    v = r.get(e)
                    row.append(np.nan if v is None else float(v))
            out_rows.append(row)
        sort_vals = [cell(r, sort_metric) for r in rows]
        return (cols, out_rows, sort_metric,
                metric_higher_is_better(sort_metric), sort_vals,
                [r["model_id"] for r in rows])

    def __len__(self) -> int:
        return len(self._rows)

    def __repr__(self) -> str:
        rows = self._sorted()
        metric = self.sort_metric or (default_metric(rows[0]["_model"])
                                      if rows else "")
        lines = [f"Leaderboard({len(rows)} models, sort={metric})"]
        for r in rows[:10]:
            lines.append(f"  {r['model_id']}: "
                         f"{r.get(metric, float('nan')):.5f}")
        return "\n".join(lines)
