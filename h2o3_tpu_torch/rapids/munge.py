"""Row gathers — ``gather_rows`` of ``h2o3_tpu/rapids/munge.py``.

A gather builds a new Frame from source rows picked by index, the
reference's row-slice and merge materialization step; an index of -1 gives
an all-missing row (NaN, ``CAT_NA``, or None in a host column). The rest
of the reference's rapids layer is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import CAT_NA, VecType
from h2o3_tpu_torch.frame.vec import Vec


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
    row), as a new Frame on the frame's device."""
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
