"""Column summary statistics — the port of ``h2o3_tpu/frame/rollups.py``.

min/max/mean/sigma/NA-count/zero-count of a column, computed on its device
and cached by the Vec (reference: ``RollupStats``). The port's columns carry
no padding, so every element is a row.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Rollups:
    """Column summary statistics (reference: ``RollupStats``)."""

    nrows: int
    na_cnt: int
    min: float
    max: float
    mean: float
    sigma: float       # sample standard deviation (H2O semantics, n-1)
    nzero: int         # count of exact zeros among non-missing values
    is_int: bool       # every non-missing value is integral
    pinfs: int
    ninfs: int


def numeric_rollups(data: torch.Tensor) -> Rollups:
    """One pass over a float32 column; NaN is missing, infs count apart
    and bound min/max like the reference's."""
    finite = torch.isfinite(data)
    cnt = finite.sum()
    x = torch.where(finite, data, 0.0)
    mean = x.sum() / cnt
    # centered second pass: the naive sum of squares cancels in float32
    d = torch.where(finite, data - mean, 0.0)
    var = (d * d).sum() / (cnt - 1).clamp_min(1)
    mn = torch.where(finite, data, torch.inf).amin() if data.numel() else mean
    mx = torch.where(finite, data, -torch.inf).amax() if data.numel() else mean
    frac = torch.where(finite, data - torch.round(data), 0.0)
    (n, na, mn, mx, mean, var, nzero, frac_max, pinfs, ninfs) = torch.stack([
        cnt.float(), torch.isnan(data).sum().float(), mn, mx, mean, var,
        (finite & (data == 0.0)).sum().float(), frac.abs().amax()
        if data.numel() else mean, torch.isposinf(data).sum().float(),
        torch.isneginf(data).sum().float()]).tolist()
    return Rollups(
        nrows=data.numel(), na_cnt=int(na),
        min=-float("inf") if ninfs else (mn if n else float("nan")),
        max=float("inf") if pinfs else (mx if n else float("nan")),
        mean=mean if n else float("nan"), sigma=var ** 0.5 if n > 1 else 0.0,
        nzero=int(nzero), is_int=bool(n) and frac_max == 0.0,
        pinfs=int(pinfs), ninfs=int(ninfs))


def cat_rollups(codes: torch.Tensor) -> Rollups:
    """One pass over int32 categorical codes; -1 is missing."""
    valid = codes >= 0
    cnt = int(valid.sum())
    if cnt == 0:
        return Rollups(codes.numel(), codes.numel(), float("nan"),
                       float("nan"), float("nan"), float("nan"), 0, True, 0, 0)
    c = codes[valid]
    return Rollups(nrows=codes.numel(), na_cnt=codes.numel() - cnt,
                   min=float(c.min()), max=float(c.max()),
                   mean=float(c.sum()) / cnt, sigma=float("nan"),
                   nzero=int((c == 0).sum()), is_int=True, pinfs=0, ninfs=0)
