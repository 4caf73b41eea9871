"""Serving schema — the request-sized input contract of a trained model —
the port of ``h2o3_tpu/serving/schema.py``.

Reference: ``hex.genmodel.GenModel`` exposes ``getNames``/``getDomainValues``
so external scorers (the EasyPredict wrapper, Steam, the REST scoring
servlets) can map a row of user values onto the model's training layout
without a Frame. Here the same contract is derived once per model and
reused by the scoring tier (:mod:`h2o3_tpu_torch.serving.service`): ordered
feature columns, each numeric or categorical with its train-time domain.

Two derivation paths cover every servable family:

- models carrying a :class:`~h2o3_tpu_torch.models.data_info.DataInfo`
  (GLM, DL, GAM, …) — ``cat_cols``/``cat_domains``/``num_cols``;
- tree ensembles (GBM/DRF/XGBoost/IF) — ``output["x_cols"]`` +
  ``output["feat_domains"]``.

Generic/MOJO wrappers unwrap to the decoded inner model. Models with
scoring-time preprocessors (TargetEncoder pipelines) are NOT servable here
— their transform is frame-shaped; ``/3/Predictions`` remains their path.

:meth:`ServingSchema.build_frame` runs inside a CUDA graph capture
(:mod:`~h2o3_tpu_torch.serving.scorer`): it wraps tensors already on the
device, with the model's own domain objects (so no scorer remaps codes on
the host), and computes nothing.
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import CAT_NA, VecType
from h2o3_tpu_torch.frame.vec import Vec


class NotServable(ValueError):
    """The model has no request-sized scoring contract (routes to HTTP 400)."""


def _unwrap(model):
    """Peel Generic → MojoModel → decoded inner model; the innermost object
    is the one whose feature metadata is real."""
    seen = 0
    while seen < 4:
        seen += 1
        mojo = (getattr(model, "output", None) or {}).get("mojo") \
            if hasattr(model, "output") else None
        if mojo is not None and hasattr(mojo, "_score_raw"):
            model = mojo
            continue
        inner = getattr(model, "_inner", None)
        if inner is not None and hasattr(inner, "_score_raw"):
            model = inner
            continue
        break
    return model


class ServingSchema:
    """Ordered (name, kind, domain) feature columns + row adaptation."""

    __slots__ = ("names", "cat_cols", "num_cols", "domains", "_level_maps")

    def __init__(self, names: list[str], cat_cols: list[str],
                 num_cols: list[str], domains: dict[str, tuple]):
        self.names = list(names)
        self.cat_cols = list(cat_cols)
        self.num_cols = list(num_cols)
        self.domains = dict(domains)
        # label -> code lookup per categorical column, built once: row
        # adaptation is on the request hot path
        self._level_maps = {c: {lvl: i for i, lvl in enumerate(dom)}
                            for c, dom in self.domains.items()}

    def to_dict(self) -> dict:
        return {"columns": [
            {"name": n, "type": "enum" if n in self._level_maps else "numeric",
             "domain": list(self.domains[n]) if n in self._level_maps else None}
            for n in self.names]}

    # -- request adaptation (host side) --------------------------------------

    def adapt_rows(self, rows, columns=None) -> tuple[np.ndarray, np.ndarray]:
        """JSON rows → ``(num [n, n_num] f32, cat [n, n_cat] i32)`` in schema
        order. ``rows`` is a list of dicts (column-keyed) or a list of lists
        ordered by ``columns`` (default: schema order). Missing values /
        unseen levels become NaN / -1 — exactly the NA codes training used."""
        if not isinstance(rows, (list, tuple)) or not rows:
            raise ValueError("rows must be a non-empty JSON array")
        n = len(rows)
        if isinstance(rows[0], dict):
            def cell(row, col):   # noqa: E306
                return row.get(col)
        else:
            order = list(columns) if columns else list(self.names)
            idx = {c: i for i, c in enumerate(order)}
            missing = [c for c in self.names if c not in idx]
            if missing:
                raise ValueError(f"rows lack model columns {missing}; "
                                 f"pass 'columns' naming the row order")
            def cell(row, col):   # noqa: E306
                i = idx[col]
                return row[i] if i < len(row) else None
        num = np.zeros((n, len(self.num_cols)), dtype=np.float32)
        cat = np.full((n, len(self.cat_cols)), CAT_NA, dtype=np.int32)
        for r, row in enumerate(rows):
            try:
                for j, c in enumerate(self.num_cols):
                    v = cell(row, c)
                    num[r, j] = np.nan if v is None or v == "" else float(v)
                for j, c in enumerate(self.cat_cols):
                    v = cell(row, c)
                    if v is None or v == "":
                        continue
                    code = self._level_maps[c].get(str(v))
                    if code is None and not isinstance(v, str):
                        # numeric payloads for enum columns are raw codes
                        # (the wire form genmodel's RowData also accepts);
                        # out-of-range codes are UNSEEN values → NA, same
                        # as an unknown label
                        try:
                            code = int(v)
                        except (TypeError, ValueError):
                            code = None
                        if code is not None and not (
                                0 <= code < len(self.domains[c])):
                            code = None
                    cat[r, j] = CAT_NA if code is None else code
            except (TypeError, KeyError, IndexError, AttributeError) as e:
                # a bad cell (nested object, mixed list/dict rows) is a
                # CLIENT payload error — 400, never a 500/404 masquerade
                raise ValueError(
                    f"row {r} is malformed: {type(e).__name__}: {e}") \
                    from None
        return num, cat

    # -- frame reconstruction (captured: called inside a CUDA graph) ---------

    def build_frame(self, num, cat, nrows: int) -> Frame:
        """Columns → a Frame matching the training layout. ``num`` [bucket,
        n_num] float32 and ``cat`` [bucket, n_cat] int32 are already on the
        device; every constructor here is shape-only Python (no sync, no
        rollup), so a graph capture records nothing of it. The Vecs carry
        the model's own domain objects, so scorers see the training domain
        and never remap codes."""
        names, vecs = [], []
        for j, c in enumerate(self.cat_cols):
            vecs.append(Vec(cat[:nrows, j], VecType.CAT,
                            domain=self.domains[c]))
            names.append(c)
        for j, c in enumerate(self.num_cols):
            vecs.append(Vec(num[:nrows, j], VecType.NUM))
            names.append(c)
        return Frame(names, vecs)


def serving_schema(model) -> ServingSchema:
    """Derive the model's request-sized input contract (raises
    :class:`NotServable` when none exists)."""
    target = _unwrap(model)
    if getattr(model, "preprocessors", None) or \
            getattr(target, "preprocessors", None):
        raise NotServable(
            "model has scoring-time preprocessors (frame-shaped transform); "
            "score it through /3/Predictions")
    out = getattr(target, "output", None) or {}
    di = getattr(target, "data_info", None)
    extra_num: list[str] = []
    oc = (getattr(target, "params", None) or {}).get("offset_column")
    if oc:
        extra_num.append(oc)
    if di is not None and getattr(di, "cat_cols", None) is not None:
        if out.get("sparse"):
            raise NotServable("sparse-trained GLM scores SparseFrame inputs; "
                              "no row-payload contract")
        cat_cols = list(di.cat_cols)
        num_cols = list(di.num_cols) + extra_num
        domains = dict(zip(di.cat_cols, di.cat_domains))
        names = cat_cols + num_cols
        return ServingSchema(names, cat_cols, num_cols, domains)
    if out.get("x_cols"):
        names = list(out["x_cols"]) + extra_num
        feat_domains = out.get("feat_domains") or {}
        cat_cols = [c for c in names if feat_domains.get(c)]
        num_cols = [c for c in names if not feat_domains.get(c)]
        domains = {c: feat_domains[c] for c in cat_cols}
        return ServingSchema(names, cat_cols, num_cols, domains)
    raise NotServable(
        f"{type(target).__name__} carries neither a DataInfo nor x_cols "
        "feature metadata; no row-payload scoring contract")
