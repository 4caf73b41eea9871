"""Frame snapshots and CSV export — the port of
``h2o3_tpu/persist/frame_io.py``.

Reference: ``water/fvec/persist/FramePersist.java`` writes each column and
a metadata record; ``h2o.export_file`` writes CSV. A snapshot is a folder
of two files, the format the JAX package writes, so a snapshot taken by
either package loads in the other:

- ``columns.npz`` (``np.savez_compressed``): ``c<i>`` holds column i
  without padding: float32 numbers, int32 categorical codes, exact float64
  epoch milliseconds for a TIME column, and for a string column its values
  as strings beside a missing mask ``m<i>``;
- ``frame.json``: the magic, the row count, the names, the type names and
  the categorical domains.

:func:`export_file` writes CSV to a path or, through
:data:`h2o3_tpu_torch.persist.cloud.MANAGER`, to an ``s3://``, ``gs://``
or ``hdfs://`` URI.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec

_MAGIC = "h2o3_tpu-frame-v1"

#: URI schemes the persist backends serve
CLOUD_SCHEMES = ("s3", "s3a", "s3n", "gs", "gcs", "hdfs")


def snapshot_bytes(path: str) -> int:
    """On-disk size of a frame snapshot (what the Cleaner registers under
    the ``spilled`` kind)."""
    total = 0
    for name in ("columns.npz", "frame.json"):
        try:
            total += os.path.getsize(os.path.join(path, name))
        except OSError:
            pass
    return total


def save_frame(frame: Frame, path: str) -> str:
    """Write a snapshot of ``frame`` into the folder ``path``; returns the
    path (reference: ``FramePersist.saveTo``)."""
    os.makedirs(path, exist_ok=True)
    meta = {"magic": _MAGIC, "nrows": frame.nrows, "names": frame.names,
            "types": [v.type.name for v in frame.vecs],
            "domains": [list(v.domain) if v.domain else None
                        for v in frame.vecs]}
    arrays = {}
    for i, v in enumerate(frame.vecs):
        if v.type.on_device:
            # TIME: the exact float64 ms; otherwise float32 or int32 codes
            arrays[f"c{i}"] = v.to_numpy()
        else:
            arrays[f"c{i}"] = np.asarray(["" if s is None else s
                                          for s in v.host_values])
            arrays[f"m{i}"] = np.array([s is None for s in v.host_values])
    np.savez_compressed(os.path.join(path, "columns.npz"), **arrays)
    with open(os.path.join(path, "frame.json"), "w") as fh:
        json.dump(meta, fh)
    return path


def load_frame(path: str, key: str | None = None,
               device: str | torch.device | None = None) -> Frame:
    """Load a snapshot onto ``device``; a keyed frame goes into the DKV
    (reference: ``FramePersist.loadFrom``)."""
    from h2o3_tpu_torch.utils.registry import DKV
    dev = resolve_device(device)
    with open(os.path.join(path, "frame.json")) as fh:
        meta = json.load(fh)
    if meta.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a frame snapshot")
    data = np.load(os.path.join(path, "columns.npz"), allow_pickle=False)
    vecs = []
    for i, (tname, dom) in enumerate(zip(meta["types"], meta["domains"])):
        t = VecType[tname]
        arr = data[f"c{i}"]
        if t is VecType.CAT:
            vecs.append(Vec(torch.as_tensor(arr.astype(np.int32)).to(dev),
                            t, domain=tuple(dom or ())))
        elif t is VecType.TIME:
            vecs.append(_time_vec(arr.astype(np.float64), dev))
        elif t.on_device:
            vecs.append(Vec(torch.as_tensor(arr.astype(np.float32)).to(dev),
                            t))
        else:
            na = data[f"m{i}"]
            vals = np.array([None if m else str(s) for s, m in zip(arr, na)],
                            dtype=object)
            vecs.append(Vec(None, t, host_values=vals))
    fr = Frame(meta["names"], vecs, key=key)
    if key:
        DKV.put(key, fr)
    return fr


def _time_vec(ms: np.ndarray, dev) -> Vec:
    """A TIME column from exact float64 epoch ms (NaN = missing), with the
    offset ``Vec.from_numpy`` takes: the least finite value."""
    offset = float(np.nanmin(ms)) if np.isfinite(ms).any() else 0.0
    rel = torch.as_tensor((ms - offset).astype(np.float32)).to(dev)
    return Vec(rel, VecType.TIME, host_values=ms, time_offset=offset)


def export_file(frame: Frame, path: str, header: bool = True,
                sep: str = ",") -> str:
    """Write ``frame`` as CSV to a path or a cloud URI; returns ``path``
    (reference: ``h2o.export_file`` → ``Frame.export``)."""
    scheme = path.split("://", 1)[0].lower() if "://" in path else ""
    text = csv_text(frame, header=header, sep=sep)
    if scheme in CLOUD_SCHEMES:
        from h2o3_tpu_torch.persist.cloud import MANAGER
        MANAGER.put(path, text.encode())
        return path
    with open(path, "w", newline="") as fh:
        fh.write(text)
    return path


def csv_text(frame: Frame, header: bool = True, sep: str = ",") -> str:
    """The CSV text of ``frame`` as pandas' ``to_csv(index=False)`` writes
    the frame's ``to_pandas()``."""
    df = frame.to_pandas()
    return df.to_csv(index=False, header=header, sep=sep)
