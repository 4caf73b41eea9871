"""Model explanations — the port of ``h2o3_tpu/explanation.py``.

Partial dependence, ICE curves, SHAP summaries, permutation importance,
varimp heatmaps and model correlations (reference: h2o-py
``h2o/explanation/_explain.py`` and ``hex/PartialDependence.java``), as
data: Frames, rows and dicts that a client renders.

A partial-dependence grid point replaces one column by a constant on the
device (``torch.full_like``) and scores the frame; the curve's statistics
are reduced on the device in float64 and fetched once per column. Row
samples and shuffles come from numpy's ``default_rng(seed)`` exactly as
in the JAX package, so both packages explain the same rows. The value
column of a categorical's curve is a host string column.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.rapids.munge import gather_rows


def _response_col(raw: torch.Tensor) -> torch.Tensor:
    """The curve's response from a prediction: p(class 1) for binomial,
    the largest class probability for multinomial, else the regression
    prediction."""
    if raw.dim() == 2 and raw.shape[1] == 2:
        return raw[:, 1]
    if raw.dim() == 2:
        return raw.max(dim=1).values
    return raw


def _grid_for(frame: Frame, col: str, nbins: int):
    """(grid values, labels): every level of a categorical, else ``nbins``
    points from the least to the greatest finite value."""
    v = frame.vec(col)
    if v.is_categorical:
        return list(range(len(v.domain))), list(v.domain)
    x = v.data
    fin = torch.isfinite(x)
    lo_hi = torch.stack([torch.where(fin, x, torch.inf).min(),
                         torch.where(fin, x, -torch.inf).max()])
    lo, hi = lo_hi.double().cpu().tolist()
    if not np.isfinite(lo):
        raise ValueError(f"column {col!r} has no finite values")
    grid = np.linspace(lo, hi, nbins)
    return list(grid), [float(g) for g in grid]


def _value_vec(frame: Frame, col: str, labels: list) -> Vec:
    if frame.vec(col).is_categorical:
        return Vec.from_numpy(np.array(labels, dtype=object), VecType.STR)
    return Vec.from_numpy(np.array(labels, np.float32), device=frame.device)


def _override(frame: Frame, col: str, value) -> Frame:
    """The frame with one column replaced by a constant, filled on the
    device."""
    vecs = []
    for name, v in zip(frame.names, frame.vecs):
        if name != col:
            vecs.append(v)
        elif v.is_categorical:
            vecs.append(Vec(torch.full_like(v.data, int(value)), VecType.CAT,
                            domain=v.domain))
        else:
            vecs.append(Vec(torch.full_like(v.data, float(value)), v.type))
    return Frame(list(frame.names), vecs)


def partial_dependence(model, frame: Frame, cols: list[str] | str,
                       nbins: int = 20, weight_column: str | None = None
                       ) -> list[Frame]:
    """Per-column PD tables (h2o-py ``model.partial_plot(..., plot=False)``):
    rows of (value, mean_response, stddev_response,
    std_error_mean_response), the sd over rows (weighted with
    ``weight_column``) and its standard error sd / sqrt(rows)."""
    if isinstance(cols, str):
        cols = [cols]
    w = None
    if weight_column is not None:
        w = frame.vec(weight_column).data.double()
    out = []
    for col in cols:
        grid, labels = _grid_for(frame, col, nbins)
        stats = []
        for gv in grid:
            resp = _response_col(model._score_raw(_override(frame, col, gv))
                                 ).double()
            if w is not None:
                m = (resp * w).sum() / w.sum()
                sd = torch.sqrt(((resp - m) ** 2 * w).sum() / w.sum())
            else:
                m = resp.mean()
                sd = torch.sqrt(((resp - m) ** 2).mean())
            stats.append(torch.stack([m, sd]))
        ms = torch.stack(stats).cpu().numpy()
        means, sds = ms[:, 0], ms[:, 1]
        ses = sds / np.sqrt(max(frame.nrows, 1))
        out.append(Frame(
            [col, "mean_response", "stddev_response",
             "std_error_mean_response"],
            [_value_vec(frame, col, labels)]
            + [Vec.from_numpy(np.asarray(a, np.float32), device=frame.device)
               for a in (means, sds, ses)]))
    return out


def ice(model, frame: Frame, col: str, nbins: int = 20,
        max_rows: int = 100, seed: int = 42) -> Frame:
    """Individual Conditional Expectation curves (h2o-py ``ice_plot``
    data): one row per (sampled row, grid value), the rows drawn by
    ``default_rng(seed)`` without replacement and sorted."""
    rng = np.random.default_rng(seed)
    n = min(max_rows, frame.nrows)
    row_ids = np.sort(rng.choice(frame.nrows, size=n, replace=False))
    rows_dev = torch.as_tensor(row_ids, device=frame.device)
    grid, labels = _grid_for(frame, col, nbins)
    resp = torch.stack([
        _response_col(model._score_raw(_override(frame, col, gv)))[rows_dev]
        for gv in grid]).cpu().numpy().reshape(-1)
    values = [lab for lab in labels for _ in range(n)]
    return Frame(["row", col, "response"],
                 [Vec.from_numpy(np.tile(row_ids, len(grid)).astype(
                     np.float32), device=frame.device),
                  _value_vec(frame, col, values),
                  Vec.from_numpy(resp.astype(np.float32),
                                 device=frame.device)])


def shap_summary(model, frame: Frame, top_n: int = 20):
    """(feature, mean |SHAP|, mean SHAP) per feature, largest first (the
    bars of h2o-py's shap_summary_plot); needs ``predict_contributions``."""
    if not hasattr(model, "predict_contributions"):
        raise ValueError(f"{model.algo} does not support SHAP contributions")
    contrib = model.predict_contributions(frame)
    names = [n for n in contrib.names if n != "BiasTerm"]
    phi = torch.stack([contrib.vec(n).data for n in names], dim=1).double()
    stats = torch.stack([phi.abs().mean(0), phi.mean(0)]).cpu().numpy()
    rows = [(n, float(a), float(m)) for n, a, m in zip(names, *stats)]
    rows.sort(key=lambda r: -r[1])
    return rows[:top_n]


def permutation_varimp(model, frame: Frame, metric: str | None = None,
                       n_repeats: int = 1, seed: int = -1,
                       features: list[str] | None = None,
                       n_samples: int = -1):
    """Permutation feature importance (reference
    ``AstPermutationVarImp``, h2o-py ``model.permutation_importance``):
    each feature's column shuffled, the frame rescored, and the metric's
    loss reported. ``n_repeats == 1`` gives rows (variable,
    relative_importance, scaled_importance, percentage); more give
    (variable, run_1..run_N). ``n_samples`` > 0 scores that many rows,
    drawn first. The shuffles are numpy's ``default_rng(seed)``
    permutations, applied on the device."""
    rng = np.random.default_rng(None if seed in (-1, None) else int(seed))
    if n_samples and 0 < n_samples < frame.nrows:
        idx = np.sort(rng.choice(frame.nrows, int(n_samples), replace=False))
        frame = gather_rows(frame, idx)
    if not metric or metric.upper() == "AUTO":
        metric = "logloss" if model.is_classifier else "rmse"
    higher_is_better = metric.lower() in ("auc", "pr_auc", "r2", "accuracy")

    def mval(mm):
        v = getattr(mm, metric.lower(), None)
        if v is None:
            raise ValueError(f"metric {metric!r} not available")
        return float(v() if callable(v) else v)

    base = mval(model.model_performance(frame))
    cols = features or [c for c in model.output.get("x_cols", frame.names)
                        if c in frame and c != model.response_column]
    reps = max(1, int(n_repeats))
    rows = []
    for c in cols:
        deltas = []
        v = frame.vec(c)
        for _ in range(reps):
            # the permutation numpy's shuffle applies to the values
            perm = np.arange(frame.nrows)
            rng.shuffle(perm)
            pv = (Vec(None, v.type, domain=v.domain,
                      host_values=v.host_values[perm]) if v.data is None
                  else Vec(v.data[torch.as_tensor(perm, device=frame.device)],
                           v.type, domain=v.domain))
            shuffled = Frame(list(frame.names),
                             [pv if n == c else frame.vec(n)
                              for n in frame.names])
            d = mval(model.model_performance(shuffled)) - base
            deltas.append(-d if higher_is_better else d)
        rows.append({"variable": c, "deltas": deltas,
                     "relative_importance": float(np.mean(deltas))})
    if reps > 1:
        return [{"variable": r["variable"],
                 **{f"run_{i + 1}": float(d)
                    for i, d in enumerate(r["deltas"])}} for r in rows]
    for r in rows:
        del r["deltas"]
    mx = max((r["relative_importance"] for r in rows), default=0.0)
    tot = sum(max(r["relative_importance"], 0.0) for r in rows) or 1.0
    for r in rows:
        r["scaled_importance"] = (r["relative_importance"] / mx
                                  if mx > 0 else 0.0)
        r["percentage"] = max(r["relative_importance"], 0.0) / tot
    rows.sort(key=lambda r: -r["relative_importance"])
    return rows


def varimp_heatmap(models) -> dict:
    """Scaled variable importances per model (h2o-py ``varimp_heatmap``
    data): {'columns': [...], 'models': [...], 'matrix': [[...]]}."""
    all_cols: list[str] = []
    per_model, names = [], []
    for m in models:
        vi = {r[0]: r[2] for r in m.varimp()}
        per_model.append(vi)
        names.append(m.key)
        for c in vi:
            if c not in all_cols:
                all_cols.append(c)
    matrix = [[vi.get(c, 0.0) for c in all_cols] for vi in per_model]
    return {"columns": all_cols, "models": names, "matrix": matrix}


def model_correlation(models, frame: Frame) -> dict:
    """Pairwise correlation of the models' predictions on a frame (h2o-py
    ``model_correlation_heatmap`` data), in float64 on the device."""
    P = torch.stack([_response_col(m._score_raw(frame)).double()
                     for m in models])
    C = torch.corrcoef(P).cpu().numpy()
    return {"models": [m.key for m in models], "matrix": C.tolist()}


def explain(models, frame: Frame, top_n_features: int = 5) -> dict:
    """One-call explanation bundle (h2o-py ``h2o.explain``): with several
    models the varimp heatmap and the model correlation; per model its
    varimp, partial dependence of its top features and, where it has
    contributions, the SHAP summary."""
    if not isinstance(models, (list, tuple)):
        models = [models]
    result: dict = {}
    with_vi = [m for m in models if hasattr(m, "varimp")]
    if len(models) > 1:
        if with_vi:
            result["varimp_heatmap"] = varimp_heatmap(with_vi)
        result["model_correlation"] = model_correlation(models, frame)
    per_model = {}
    for m in models:
        entry: dict = {}
        if hasattr(m, "varimp"):
            vi = m.varimp()
            entry["varimp"] = vi
            top = [r[0] for r in vi[:top_n_features]]
            entry["partial_dependence"] = dict(
                zip(top, partial_dependence(m, frame, top)))
        try:
            entry["shap_summary"] = shap_summary(m, frame)
        except (ValueError, KeyError):
            pass
        per_model[m.key] = entry
    result["models"] = per_model
    return result
