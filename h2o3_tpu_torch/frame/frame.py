"""Frame — a named list of equal-length columns — the port of
``h2o3_tpu/frame/frame.py``.

All on-device columns of a Frame live on one device and carry no padding;
host-resident string columns sit beside them. :meth:`Frame.from_pandas`
and :meth:`Frame.to_pandas` convert from and to pandas. The reference's
mesh views, DKV registration, Cleaner and compression are left out.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec, _factorize, _guess_type


class Frame:
    """Columnar table on one device (reference: ``water.fvec.Frame``)."""

    def __init__(self, names: Sequence[str], vecs: Sequence[Vec],
                 key: str | None = None):
        if len(names) != len(vecs):
            raise ValueError("names/vecs length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        if len({v.nrows for v in vecs}) > 1:
            raise ValueError("vecs disagree on nrows")
        if len({v.device for v in vecs if v.data is not None}) > 1:
            raise ValueError("vecs live on different devices")
        self.names: list[str] = list(names)
        self.vecs: list[Vec] = list(vecs)
        self.key = key

    @staticmethod
    def from_arrays(cols: Mapping[str, np.ndarray],
                    types: Mapping[str, VecType] | None = None,
                    key: str | None = None,
                    device: str | torch.device | None = None) -> "Frame":
        """Build a frame from host columns, uploading all numeric columns as
        one [ncols, nrows] float32 transfer; categorical columns (strings,
        or any column typed CAT) are factorized to sorted domains."""
        dev = resolve_device(device)
        types = types or {}
        names = list(cols.keys())
        vecs: dict[str, Vec] = {}
        floats: list[tuple[str, np.ndarray, VecType]] = []
        for k in names:
            v = np.asarray(cols[k])
            t = types.get(k) or _guess_type(v)
            if t is VecType.CAT and v.dtype.kind not in "iu":
                codes, dom = _factorize(v)
                vecs[k] = Vec(torch.as_tensor(codes).to(dev), VecType.CAT,
                              domain=tuple(dom))
            elif t in (VecType.NUM, VecType.INT) and v.dtype.kind in "fiub":
                floats.append((k, v, t))
            else:
                vecs[k] = Vec.from_numpy(v, type=t, device=dev)
        if floats:
            mat = np.empty((len(floats), len(floats[0][1])), np.float32)
            for i, (_, v, _) in enumerate(floats):
                mat[i] = v
            dmat = torch.as_tensor(mat).to(dev)
            for i, (k, _, t) in enumerate(floats):
                vecs[k] = Vec(dmat[i], t)
        return Frame(names, [vecs[k] for k in names], key=key)

    @staticmethod
    def from_pandas(df, key: str | None = None,
                    device: str | torch.device | None = None) -> "Frame":
        """A pandas DataFrame as a Frame, with the parser's type guessing:
        object and string columns become categorical (sorted domains),
        datetimes TIME, booleans INT (0/1) and numbers NUM or INT, through
        :meth:`from_arrays`' batched upload."""
        dev = resolve_device(device)
        cols: dict[str, np.ndarray] = {}
        types: dict[str, VecType] = {}
        times: dict[str, np.ndarray] = {}
        for col in df.columns:
            s, name = df[col], str(col)
            if s.dtype.kind in "OUS" or str(s.dtype) in ("category", "str"):
                # a category column is factorized again: sorted domain
                cols[name] = (s.astype(object).to_numpy()
                              if str(s.dtype) == "category"
                              else s.to_numpy(dtype=object))
            elif s.dtype.kind == "M":
                times[name] = s.to_numpy()
            elif s.dtype.kind == "b":
                cols[name] = s.to_numpy().astype(np.float32)
                types[name] = VecType.INT
            else:
                cols[name] = s.to_numpy(dtype=np.float32, na_value=np.nan)
        fr = Frame.from_arrays(cols, types=types, device=dev)
        vecs = [Vec.from_numpy(times[str(c)], type=VecType.TIME, device=dev)
                if str(c) in times else fr.vec(str(c)) for c in df.columns]
        return Frame([str(c) for c in df.columns], vecs, key=key)

    def to_pandas(self):
        """The frame as a pandas DataFrame: categorical columns as their
        labels (None for missing), string columns as objects, TIME columns
        as datetimes, numbers as float32."""
        import pandas as pd
        out = {}
        for n, v in zip(self.names, self.vecs):
            if v.is_categorical:
                out[n] = pd.Series(v.labels(), dtype=object)
            elif v.type is VecType.TIME:
                out[n] = pd.to_datetime(pd.Series(v.to_numpy()), unit="ms")
            elif v.data is not None:
                out[n] = v.to_numpy()
            else:
                out[n] = pd.Series(v.host_values, dtype=object)
        return pd.DataFrame(out)

    @property
    def nrows(self) -> int:
        return self.vecs[0].nrows if self.vecs else 0

    @property
    def ncols(self) -> int:
        return len(self.vecs)

    @property
    def device(self) -> torch.device:
        """The device of the on-device columns (the CPU for a frame of
        host columns alone)."""
        return next((v.device for v in self.vecs if v.data is not None),
                    torch.device("cpu"))

    @property
    def types(self) -> dict[str, str]:
        return {n: str(v.type) for n, v in zip(self.names, self.vecs)}

    def vec(self, col: int | str) -> Vec:
        if isinstance(col, (int, np.integer)):
            return self.vecs[int(col)]
        try:
            return self.vecs[self.names.index(col)]
        except ValueError:
            raise KeyError(f"no column {col!r}; have {self.names}") from None

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def row_mask(self) -> torch.Tensor:
        """Boolean [nrows] mask of logical rows: all True, since the port's
        columns carry no padding (kept so row-weight code reads as in the
        reference)."""
        return torch.ones(self.nrows, dtype=torch.bool, device=self.device)

    def __repr__(self) -> str:
        return f"Frame({self.nrows} rows x {self.ncols} cols: {self.names})"
