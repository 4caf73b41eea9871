"""Vec — one column — the port of ``h2o3_tpu/frame/vec.py``.

A Vec is one tensor on one device, with no padding: float32 for numeric
columns (NaN = missing) and int32 codes for categoricals (-1 = missing) with
a sorted host-side domain. A string column (``VecType.STR``, or ``UUID``)
has no tensor: its values stay on the host as an object array (None =
missing). A time column (``VecType.TIME``) holds float32 milliseconds
relative to ``time_offset`` on the device (epoch milliseconds overflow a
float32 mantissa) and the exact float64 epoch milliseconds on the host.
The element-wise operators (arithmetic, comparisons, ``& | ~``) give
float32 NUM columns with NaN where an operand is missing, as the
reference's do. The reference's mesh sharding is left out.

A column of the streaming parse (:meth:`Vec.from_compressed`) keeps a
compressed host payload (:mod:`h2o3_tpu_torch.ingest.encode`); its tensor
is a derived view that ``data`` builds on first access, once, under the
Vec's lock (two builds may read a column from two threads), by copying the
narrow payload to the device and widening it there. :meth:`Vec.drop_device`
lets the view go again (the Cleaner's cheapest eviction); a build that
still holds the tensor keeps it alive until it lets go. ``nrows``,
``device``, ``nbytes`` and ``to_numpy`` never build the view.
"""

from __future__ import annotations

import threading
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
                 time_offset: float = 0.0, compressed=None,
                 device: torch.device | None = None):
        self._data = data       # [nrows] float32 (numeric) or int32 (codes)
        # a compressed host payload (ingest/encode.CompressedChunk), with the
        # device its view is built on; _data is then the derived view
        self._compressed = compressed
        self._device = device
        self._view_lock = threading.Lock() if compressed is not None \
            else None
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

    @staticmethod
    def from_compressed(chunk, type: VecType,
                        domain: tuple[str, ...] | None = None,
                        device: str | torch.device | None = None) -> "Vec":
        """Wrap a compressed host payload; the tensor is built on
        ``device`` at the first ``data`` access."""
        return Vec(None, type, domain=domain, compressed=chunk,
                   device=resolve_device(device))

    @property
    def data(self) -> torch.Tensor | None:
        """The column's tensor. For a compressed Vec a derived view, built
        on first access and kept until :meth:`drop_device`."""
        arr = self._data    # a concurrent drop_device must not make this None
        if arr is None and self._compressed is not None:
            with self._view_lock:
                arr = self._data
                if arr is None:
                    arr = self._compressed.to_tensor(self._device)
                    self._data = arr
        return arr

    @data.setter
    def data(self, value: torch.Tensor | None) -> None:
        self._data = value

    @property
    def compressed(self):
        """The compressed host payload, if the Vec has one."""
        return self._compressed

    @property
    def device_resident(self) -> bool:
        """Whether the tensor exists now (never builds it)."""
        return self._data is not None

    def drop_device(self) -> int:
        """Let a compressed Vec's derived tensor go; returns its bytes (0
        where there is nothing the payload can build again). A caller that
        still holds the tensor keeps its memory until it lets go."""
        if self._compressed is None:
            return 0
        with self._view_lock:
            arr, self._data = self._data, None
        return 0 if arr is None else arr.numel() * arr.element_size()

    @property
    def nbytes(self) -> int:
        """Resident bytes: the tensor if it exists now (never built for the
        count), the compressed payload and the host values."""
        arr = self._data
        total = 0 if arr is None else arr.numel() * arr.element_size()
        if self._compressed is not None:
            total += int(self._compressed.nbytes)
        if self.host_values is not None:
            total += int(self.host_values.nbytes)
        return total

    @property
    def nrows(self) -> int:
        if self._data is not None:
            return self._data.shape[0]
        if self._compressed is not None:
            return self._compressed.nrows
        return len(self.host_values)

    @property
    def device(self) -> torch.device | None:
        """The tensor's device (a compressed Vec's, built or not); None
        for a host-resident column."""
        if self._data is not None:
            return self._data.device
        return self._device

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
            if self._data is None and self._compressed is not None:
                # a transient tensor of the payload on the Vec's device, so
                # the numbers equal the eager column's bit for bit; the
                # view itself stays unbuilt
                t = self._compressed.to_tensor(self._device)
                self._rollups = (cat_rollups(t) if self.is_categorical
                                 else numeric_rollups(t))
            elif self.data is None:
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
        if self._data is None and self._compressed is not None:
            # a fresh copy: the identity codec decodes to its payload
            return self._compressed.decode().copy()
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

    def __len__(self) -> int:
        return self.nrows

    def __repr__(self) -> str:
        dom = f", card={self.cardinality()}" if self.is_categorical else ""
        return f"Vec({self.type}, nrows={self.nrows}{dom})"

    # -- element-wise operators (reference: water/rapids/ast/prims/operators/)
    #
    # Results are NUM Vecs on the column's device; NA propagates through NaN
    # arithmetic. Comparisons give 0.0/1.0, NaN where an operand is NA.

    def _operand(self, other):
        if isinstance(other, Vec):
            if other.nrows != self.nrows:
                raise ValueError("Vec length mismatch")
            o = other.as_float()
            # a TIME column's device data is relative to its own offset:
            # align the operand into this column's frame
            if self.type is VecType.TIME or other.type is VecType.TIME:
                o = o + (other.time_offset - self.time_offset)
            return o
        if isinstance(other, str):
            if not self.is_categorical:
                raise TypeError("string comparand requires a categorical Vec")
            try:
                return float(self.domain.index(other))
            except ValueError:
                return float("nan")   # unknown level: matches nothing
        o = float(other)
        if self.type is VecType.TIME:
            o = o - self.time_offset   # scalars are absolute epoch ms
        return o

    def _time_pair_host(self, other):
        """Both-TIME operand pair as exact float64 host ms, or None: a
        25-year offset difference overflows the float32 relative values,
        so TIME-TIME arithmetic runs on the exact host payload."""
        if (isinstance(other, Vec) and self.type is VecType.TIME
                and other.type is VecType.TIME
                and self.host_values is not None
                and other.host_values is not None):
            return (np.asarray(self.host_values, np.float64),
                    np.asarray(other.host_values, np.float64))
        return None

    def _ew(self, other, fn, host_fn, swap: bool = False):
        pair = self._time_pair_host(other)
        if pair is not None:
            a, o = pair
            out = np.asarray(host_fn(o, a) if swap else host_fn(a, o),
                             np.float32)
            return Vec.from_numpy(out, type=VecType.NUM, device=self.device)
        o = self._operand(other)
        a = self.as_float()
        if swap:
            if not isinstance(o, torch.Tensor):
                o = torch.full_like(a, o)
            out = fn(o, a)
        else:
            out = fn(a, o)
        return Vec(out.to(torch.float32), VecType.NUM)

    def __add__(self, o): return self._ew(o, torch.add, np.add)
    def __radd__(self, o): return self._ew(o, torch.add, np.add)
    def __sub__(self, o): return self._ew(o, torch.sub, np.subtract)
    def __rsub__(self, o): return self._ew(o, torch.sub, np.subtract, True)
    def __mul__(self, o): return self._ew(o, torch.mul, np.multiply)
    def __rmul__(self, o): return self._ew(o, torch.mul, np.multiply)
    def __truediv__(self, o): return self._ew(o, torch.div, np.divide)

    def __rtruediv__(self, o):
        return self._ew(o, torch.div, np.divide, True)

    def __pow__(self, o): return self._ew(o, torch.pow, np.power)
    def __rpow__(self, o): return self._ew(o, torch.pow, np.power, True)
    def __mod__(self, o): return self._ew(o, torch.remainder, np.mod)

    def __rmod__(self, o):
        return self._ew(o, torch.remainder, np.mod, True)

    def __floordiv__(self, o):
        return self._ew(o, floor_divide, np.floor_divide)

    def __rfloordiv__(self, o):
        return self._ew(o, floor_divide, np.floor_divide, True)

    def __neg__(self): return self._ew(-1.0, torch.mul, np.multiply)

    def _cmp(self, other, fn):
        pair = self._time_pair_host(other)
        if pair is not None:
            a, o = pair
            out = np.where(np.isnan(a) | np.isnan(o), np.nan,
                           np.asarray(fn(a, o), np.float32))
            return Vec.from_numpy(out.astype(np.float32), type=VecType.NUM,
                                  device=self.device)
        o = self._operand(other)
        a = self.as_float()
        valid = ~torch.isnan(a)
        if isinstance(o, torch.Tensor):
            valid = valid & ~torch.isnan(o)
        out = torch.where(valid, fn(a, o).to(torch.float32), torch.nan)
        return Vec(out, VecType.NUM)

    def __lt__(self, o): return self._cmp(o, lambda a, b: a < b)
    def __le__(self, o): return self._cmp(o, lambda a, b: a <= b)
    def __gt__(self, o): return self._cmp(o, lambda a, b: a > b)
    def __ge__(self, o): return self._cmp(o, lambda a, b: a >= b)
    def __eq__(self, o): return self._cmp(o, lambda a, b: a == b)
    def __ne__(self, o): return self._cmp(o, lambda a, b: a != b)
    __hash__ = object.__hash__   # __eq__ returns a Vec, not a bool

    def __and__(self, o):
        return self._cmp(o, lambda a, b: (a != 0) & (b != 0))

    def __or__(self, o):
        return self._cmp(o, lambda a, b: (a != 0) | (b != 0))

    def __invert__(self): return self._cmp(0.0, lambda a, b: a == b)

    def isna(self) -> "Vec":
        """1.0 where the value is missing."""
        return Vec(torch.isnan(self.as_float()).to(torch.float32),
                   VecType.NUM)


def floor_divide(a: torch.Tensor, b) -> torch.Tensor:
    """Float floor division as ``jnp.floor_divide``: NaN where the divisor
    (a tensor or a number) is 0, where ``torch.floor_divide`` gives ±inf."""
    if not isinstance(b, torch.Tensor):
        return torch.full_like(a, torch.nan) if b == 0 else \
            torch.floor_divide(a, b)
    return torch.where(b == 0, torch.nan, torch.floor_divide(a, b))


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
