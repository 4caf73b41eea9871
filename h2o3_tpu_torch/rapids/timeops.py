"""Time functions on TIME columns — the port of ``h2o3_tpu/rapids/timeops.py``.

Reference: ``water/rapids/ast/prims/time/`` (``AstYear``, ``AstMonth``,
``AstDay``, ``AstDayOfWeek``, ``AstHour`` ..., ``AstAsDate``,
``AstMktime``). A TIME Vec keeps its exact float64 epoch milliseconds on
the host (its device data is float32 milliseconds after ``time_offset``),
so the calendar fields are computed there with numpy's datetime64 and come
back as float32 NUM columns on the column's device.
"""

from __future__ import annotations

import datetime

import numpy as np

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec


def _ms(vec: Vec) -> np.ndarray:
    if vec.type is not VecType.TIME:
        raise TypeError(f"time op on {vec.type} column")
    return np.asarray(vec.to_numpy(), np.float64)   # epoch ms, NaN for NA


def _device(vec: Vec):
    return vec.device if vec.data is not None else resolve_device()


def ms_to_datetime64(ms: np.ndarray) -> np.ndarray:
    """float64 epoch ms (NaN = missing) → datetime64[ms] (NaT = missing)."""
    out = np.full(len(ms), np.datetime64("NaT"), "datetime64[ms]")
    ok = ~np.isnan(ms)
    out[ok] = ms[ok].astype(np.int64).view("datetime64[ms]")
    return out


def time_vec(ms: np.ndarray, device=None) -> Vec:
    """A TIME Vec from float64 epoch ms (NaN = missing), through datetime64
    nanoseconds as a parsed column is built: whole milliseconds exactly
    (int64), the sub-millisecond part rounded to a nanosecond."""
    ms = np.asarray(ms, np.float64)
    ns = np.full(len(ms), np.datetime64("NaT"), "datetime64[ns]")
    fin = np.isfinite(ms)
    whole = np.floor(ms[fin])
    ns[fin] = (whole.astype(np.int64) * 1_000_000
               + np.round((ms[fin] - whole) * 1e6).astype(np.int64)
               ).astype("datetime64[ns]")
    return Vec.from_numpy(ns, type=VecType.TIME, device=device)


def _dt(vec: Vec) -> np.ndarray:
    return ms_to_datetime64(_ms(vec))


def _field(vec: Vec, values: np.ndarray) -> Vec:
    return Vec.from_numpy(values.astype(np.float32), type=VecType.NUM,
                          device=_device(vec))


def _decompose(vec: Vec, unit_hi: str, unit_lo: str,
               offset: float = 0.0) -> Vec:
    dt = _dt(vec)
    hi = dt.astype(f"datetime64[{unit_hi}]")
    val = (dt - hi).astype(f"timedelta64[{unit_lo}]").astype(np.float64)
    val[np.isnat(dt)] = np.nan
    return _field(vec, val + offset)


def year(vec: Vec) -> Vec:
    dt = _dt(vec)
    y = dt.astype("datetime64[Y]").astype(np.float64) + 1970.0
    y[np.isnat(dt)] = np.nan
    return _field(vec, y)


def month(vec: Vec) -> Vec:
    return _decompose(vec, "Y", "M", offset=1.0)        # 1..12


def day(vec: Vec) -> Vec:
    return _decompose(vec, "M", "D", offset=1.0)        # 1..31


def hour(vec: Vec) -> Vec:
    return _decompose(vec, "D", "h")


def minute(vec: Vec) -> Vec:
    return _decompose(vec, "h", "m")


def second(vec: Vec) -> Vec:
    return _decompose(vec, "m", "s")


def millis(vec: Vec) -> Vec:
    return _decompose(vec, "s", "ms")


def day_of_week(vec: Vec) -> Vec:
    """0 = Monday .. 6 = Sunday (reference ``AstDayOfWeek``)."""
    dt = _dt(vec)
    days = dt.astype("datetime64[D]").astype(np.float64)
    dow = np.mod(days + 3.0, 7.0)                        # 1970-01-01: Thursday
    dow[np.isnat(dt)] = np.nan
    return _field(vec, dow)


def week(vec: Vec) -> Vec:
    dt = _dt(vec)
    doy = (dt.astype("datetime64[D]") - dt.astype("datetime64[Y]")
           ).astype(np.float64)
    val = np.floor(doy / 7.0) + 1.0
    val[np.isnat(dt)] = np.nan
    return _field(vec, val)


def as_date(vec: Vec, fmt: str) -> Vec:
    """A STR or CAT column parsed into a TIME Vec (reference:
    ``AstAsDate``; Java-style yyyy/MM/dd/HH/mm/ss tokens); a string that
    does not parse is missing."""
    py_fmt = (fmt.replace("yyyy", "%Y").replace("yy", "%y")
              .replace("MM", "%m").replace("dd", "%d")
              .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S"))
    vals = vec.labels() if vec.is_categorical else vec.host_values
    out = np.full(len(vals), np.datetime64("NaT"), "datetime64[ms]")
    for i, s in enumerate(vals):
        if s is not None:
            try:
                out[i] = np.datetime64(
                    datetime.datetime.strptime(s, py_fmt), "ms")
            except ValueError:
                pass
    return Vec.from_numpy(out, type=VecType.TIME, device=_device(vec))


def mktime(year_v, month_v=None, day_v=None, hour_v=None, minute_v=None,
           second_v=None) -> Vec:
    """A TIME column from numeric component columns (reference:
    ``AstMktime``; month and day 1-based); missing where any is."""
    n = year_v.nrows

    def arr(v, default):
        return np.asarray(v.to_numpy(), np.float64) if v is not None \
            else np.full(n, default, np.float64)
    y, mo, d = arr(year_v, 1970), arr(month_v, 1), arr(day_v, 1)
    h, mi, s = arr(hour_v, 0), arr(minute_v, 0), arr(second_v, 0)
    ok = ~(np.isnan(y) | np.isnan(mo) | np.isnan(d) | np.isnan(h)
           | np.isnan(mi) | np.isnan(s))
    out = np.full(n, np.datetime64("NaT"), "datetime64[ms]")
    yi = y[ok].astype(np.int64)
    base = (yi - 1970).astype("timedelta64[Y]") + np.zeros(ok.sum(),
                                                           "datetime64[Y]")
    months = base.astype("datetime64[M]") + (mo[ok].astype(np.int64) - 1)
    days = months.astype("datetime64[D]") + (d[ok].astype(np.int64) - 1)
    ms = (days.astype("datetime64[ms]")
          + (h[ok] * 3600_000 + mi[ok] * 60_000 + s[ok] * 1000
             ).astype("timedelta64[ms]"))
    out[ok] = ms
    return Vec.from_numpy(out, type=VecType.TIME, device=_device(year_v))
