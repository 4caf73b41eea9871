"""Vec — one column — the port of ``h2o3_tpu/frame/vec.py``.

A Vec is one tensor on one device, with no padding: float32 for numeric
columns (NaN = missing) and int32 codes for categoricals (-1 = missing) with
a sorted host-side domain. A string column (``VecType.STR``, or ``UUID``)
has no tensor: its values stay on the host as an object array (None =
missing). A time column (``VecType.TIME``) holds float32 milliseconds
relative to ``time_offset`` on the device (epoch milliseconds overflow a
float32 mantissa) and the exact float64 epoch milliseconds on the host.
The reference's mesh sharding and compression are left out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.rollups import Rollups, cat_rollups, numeric_rollups
from h2o3_tpu_torch.frame.types import CAT_NA, VecType


class Vec:
    """One named, typed column of a Frame."""

    def __init__(self, data: torch.Tensor | None, type: VecType,
                 domain: tuple[str, ...] | None = None,
                 host_values: np.ndarray | None = None,
                 time_offset: float = 0.0):
        self.data = data        # [nrows] float32 (numeric) or int32 (codes)
        self.type = type
        self.domain = domain    # categorical level names, sorted
        # the values of a host-resident column (STR, UUID), with data None;
        # a TIME column's exact float64 epoch milliseconds
        self.host_values = host_values
        # a TIME column's device data is milliseconds after time_offset
        self.time_offset = time_offset
        self._rollups: Rollups | None = None

    @staticmethod
    def from_numpy(values: np.ndarray, type: VecType | None = None,
                   domain: Sequence[str] | None = None,
                   device: str | torch.device | None = None) -> "Vec":
        """Build a Vec from a host array, guessing the type if not given."""
        if type is None:
            type = _guess_type(values)
        if type in (VecType.STR, VecType.UUID):
            return Vec(None, type,
                       host_values=np.asarray(values, dtype=object))
        dev = resolve_device(device)
        if type is VecType.TIME and np.asarray(values).dtype.kind == "M":
            ns = np.asarray(values).astype("datetime64[ns]")
            ms = ns.astype(np.int64).astype(np.float64) / 1e6
            ms = np.where(np.isnat(ns), np.nan, ms)
            offset = float(np.nanmin(ms)) if np.isfinite(ms).any() else 0.0
            rel = torch.as_tensor((ms - offset).astype(np.float32)).to(dev)
            return Vec(rel, VecType.TIME, host_values=ms, time_offset=offset)
        if type is VecType.CAT:
            if domain is None:
                codes, domain = _factorize(values)
            else:
                codes = np.asarray(values, dtype=np.int32)
            return Vec(torch.as_tensor(codes.astype(np.int32)).to(dev),
                       type, domain=tuple(domain))
        if not type.on_device:
            raise ValueError(f"{type} columns are not supported by the port yet")
        host = np.ascontiguousarray(values, dtype=np.float32)
        return Vec(torch.as_tensor(host).to(dev), type)

    @staticmethod
    def from_device(data: torch.Tensor, type: VecType = VecType.NUM,
                    domain: tuple[str, ...] | None = None) -> "Vec":
        """Wrap an existing device tensor."""
        return Vec(data, type, domain=domain)

    @property
    def nrows(self) -> int:
        if self.data is None:
            return len(self.host_values)
        return self.data.shape[0]

    @property
    def device(self) -> torch.device | None:
        """The tensor's device; None for a host-resident column."""
        return None if self.data is None else self.data.device

    @property
    def is_categorical(self) -> bool:
        return self.type is VecType.CAT

    @property
    def is_numeric(self) -> bool:
        return self.type.is_numeric

    def cardinality(self) -> int:
        """Number of categorical levels (reference: ``Vec.cardinality()``)."""
        return len(self.domain) if self.domain is not None else -1

    def rollups(self) -> Rollups:
        if self._rollups is None:
            if self.data is None:
                # a host column: its count of missing values alone
                na = int(sum(v is None for v in self.host_values))
                nan = float("nan")
                self._rollups = Rollups(self.nrows, na, nan, nan, nan, nan,
                                        0, False, 0, 0)
            else:
                self._rollups = (cat_rollups(self.data)
                                 if self.is_categorical
                                 else numeric_rollups(self.data))
        return self._rollups

    def mean(self) -> float:
        """Mean of the finite values (NaN when there are none)."""
        return self.rollups().mean

    def min(self) -> float:
        """Least finite value (-inf where the column holds one)."""
        return self.rollups().min

    def max(self) -> float:
        """Greatest finite value (inf where the column holds one)."""
        return self.rollups().max

    def sigma(self) -> float:
        """Sample standard deviation of the finite values (n - 1)."""
        return self.rollups().sigma

    def to_numpy(self) -> np.ndarray:
        """The column on the host (a TIME column: exact epoch ms)."""
        if self.data is None:
            return self.host_values
        if self.type is VecType.TIME and self.host_values is not None:
            return self.host_values
        return self.data.cpu().numpy()

    def labels(self) -> np.ndarray:
        """A categorical column as its level strings (NA → None)."""
        if not self.is_categorical:
            raise ValueError("labels() requires a categorical Vec")
        codes = self.to_numpy()
        out = np.full(len(codes), None, dtype=object)
        ok = codes >= 0
        out[ok] = np.array(self.domain, dtype=object)[codes[ok]]
        return out

    def as_float(self) -> torch.Tensor:
        """Column as float32 with NaN for missing (cats → code floats)."""
        if self.is_categorical:
            return torch.where(self.data < 0, torch.nan, self.data.float())
        return self.data

    def __repr__(self) -> str:
        dom = f", card={self.cardinality()}" if self.is_categorical else ""
        return f"Vec({self.type}, nrows={self.nrows}{dom})"


def _guess_type(values: np.ndarray) -> VecType:
    values = np.asarray(values)
    if values.dtype.kind in "fc":
        finite = values[np.isfinite(values)]
        return VecType.INT if finite.size and np.all(finite == np.round(finite)) \
            else VecType.NUM
    if values.dtype.kind in "iub":
        return VecType.INT
    if values.dtype.kind == "M":
        return VecType.TIME
    return VecType.CAT


def _factorize(values: np.ndarray) -> tuple[np.ndarray, list[str]]:
    """Categorical codes with a lexicographically sorted domain (reference:
    the parser sorts domains, so codes are stable across chunk orders).
    Missing values (None, NaN) get ``CAT_NA``. Fixed-width string arrays
    take a vectorised path with the same result as the per-element one."""
    arr = np.asarray(values)
    if arr.dtype.kind in "US":
        domain, codes = np.unique(arr.astype(str), return_inverse=True)
        return codes.astype(np.int32), domain.tolist()
    arr = np.asarray(values, dtype=object)
    mask = np.array([v is None or (isinstance(v, (float, np.floating))
                                   and np.isnan(v)) for v in arr], dtype=bool)
    strs = np.array([str(v) for v in arr[~mask]])
    domain = sorted(set(strs.tolist()))
    lut = {s: i for i, s in enumerate(domain)}
    codes = np.full(len(arr), CAT_NA, dtype=np.int32)
    codes[~mask] = np.array([lut[s] for s in strs], dtype=np.int32)
    return codes, domain
