"""Segment models — one model per partition of a frame — the port of
``h2o3_tpu/orchestration/segments.py``.

Reference: ``hex/segments/SegmentModelsBuilder.java`` and
``SegmentModels.java`` (h2o-py ``estimator.train_segments``): the observed
combinations of the segment columns, the same algorithm and parameters
trained on each segment's rows, and each segment's model key, status and
errors. As in the JAX package, a segment is the whole frame with weight 0
outside it, so every segment's fit has the frame's shapes; a row with a
missing segment value belongs to no segment. The weights are one
comparison of the columns' codes on the frame's device.
"""

from __future__ import annotations

import traceback
import uuid

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.utils.registry import DKV


class SegmentModels:
    """Per-segment training results (reference:
    ``hex/segments/SegmentModels.java``), put into the DKV under ``key``."""

    def __init__(self, key: str, segment_cols: list[str], rows: list[dict]):
        self.key = key
        self.segment_cols = segment_cols
        self.rows = rows      # dicts: segment values, model_id, status, errors
        DKV.put(key, self)

    def as_frame(self) -> Frame:
        """Columns: the segment columns, model_id, status, errors (h2o-py
        ``H2OSegmentModels.as_frame``), as host string columns."""
        names, vecs = [], []
        for c in self.segment_cols:
            names.append(c)
            vecs.append(Vec.from_numpy(np.array(
                [str(r["segment"][c]) for r in self.rows], dtype=object),
                VecType.STR))
        for field in ("model_id", "status", "errors"):
            names.append(field)
            vecs.append(Vec.from_numpy(np.array(
                [r.get(field) or "" for r in self.rows], dtype=object),
                VecType.STR))
        return Frame(names, vecs)

    def get_model(self, **segment_values):
        for r in self.rows:
            if all(str(r["segment"].get(k)) == str(v)
                   for k, v in segment_values.items()):
                if r["model_id"]:
                    return DKV.get(r["model_id"])
                return None
        raise KeyError(f"no segment {segment_values}")

    def __len__(self):
        return len(self.rows)


def _is_na(e) -> bool:
    return e is None or (isinstance(e, (float, np.floating)) and np.isnan(e))


def train_segments(builder, segments: list[str], frame: Frame, y: str,
                   x: list[str] | None = None,
                   segment_models_id: str | None = None) -> SegmentModels:
    """Train ``builder``'s algorithm once per observed segment combination
    (a fresh builder of its parameters each), in the combinations' order as
    strings, as the JAX package sorts them."""
    seg_cols = list(segments)
    if not seg_cols:
        raise ValueError("segments must name at least one column")
    xs = [c for c in (x if x is not None else frame.names)
          if c != y and c not in seg_cols]
    # each column's values on the host, as the JAX package enumerates them
    seg_vals = []
    for c in seg_cols:
        v = frame.vec(c)
        seg_vals.append(v.labels() if v.is_categorical else
                        np.asarray(v.to_numpy(), dtype=object))
    combos = sorted({tuple(t) for t in zip(*seg_vals)
                     if not any(_is_na(e) for e in t)}, key=str)

    rows = []
    for combo in combos:
        mask = torch.ones(frame.nrows, dtype=torch.bool, device=frame.device)
        for c, want in zip(seg_cols, combo):
            v = frame.vec(c)
            code = v.domain.index(want) if v.is_categorical else float(want)
            mask &= v.data == code
        entry = dict(segment=dict(zip(seg_cols, combo)), model_id=None,
                     status="PENDING", errors=None)
        try:
            b = type(builder)(**builder.params)
            model = b.train(x=xs, y=y, training_frame=frame,
                            weights=mask.float())
            entry["model_id"] = model.key
            entry["status"] = "SUCCEEDED"
        except Exception as e:                        # noqa: BLE001
            entry["status"] = "FAILED"
            entry["errors"] = f"{type(e).__name__}: {e}"
            entry["traceback"] = traceback.format_exc()
        rows.append(entry)
    key = segment_models_id or f"segment_models_{uuid.uuid4().hex[:8]}"
    return SegmentModels(key, seg_cols, rows)
