"""Element-wise math, reducers, quantiles, cumulative ops and frame
utilities — the port of ``h2o3_tpu/rapids/ops.py``.

Reference: ``water/rapids/ast/prims/math/``, ``reducers/`` and
``advmath/``, each a small AST node over a column's chunks. Here each op is
a few torch ops over the column's tensor. Quantiles and medians sort the
valid values once and interpolate on the host's float64 (``torch.
quantile`` refuses more than 2^24 elements); sums, means and variances
accumulate in float64 (the reference adds float32), a variance about the
mean in two passes (the reference's one-pass formula cancels).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec

# -- element-wise math -------------------------------------------------------


def _sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _nonpos_int(x):
    return (x <= 0) & (x == torch.floor(x))


def _digamma(x):
    # jax.scipy's digamma is NaN at 0 and the negative integers
    return torch.where(_nonpos_int(x), torch.nan, torch.digamma(x))


def _trigamma(x):
    # jax.scipy's polygamma(1, x): inf at 0 and the negative integers and
    # at -inf, NaN at +inf
    out = torch.where(_nonpos_int(x), torch.inf, torch.polygamma(1, x))
    return torch.where(torch.isinf(x),
                       torch.where(x > 0, torch.nan, torch.inf), out)


_UNARY = {
    "abs": torch.abs, "sign": _sign, "sqrt": torch.sqrt,
    "floor": torch.floor, "ceiling": torch.ceil, "trunc": torch.trunc,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "exp": torch.exp, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "lgamma": torch.lgamma, "digamma": _digamma, "trigamma": _trigamma,
    "cospi": lambda x: torch.cos(math.pi * x),
    "sinpi": lambda x: torch.sin(math.pi * x),
    "tanpi": lambda x: torch.tan(math.pi * x),
    "logistic": torch.sigmoid,
    "not": lambda x: (x == 0).to(torch.float32),
    "none": lambda x: x,                       # AstNoOp
}


def math_op(name: str, vec: Vec) -> Vec:
    """A named unary math op (reference: one ``AstUniOp`` per name)."""
    try:
        fn = _UNARY[name]
    except KeyError:
        raise ValueError(f"unknown math op {name!r}; have "
                         f"{sorted(_UNARY)}") from None
    return Vec(fn(vec.as_float()).to(torch.float32), VecType.NUM)


def __getattr__(name):   # ops.log(v), ops.exp(v), ...
    if name in _UNARY:
        return lambda vec: math_op(name, vec)
    raise AttributeError(name)


def round_(vec: Vec, digits: int = 0) -> Vec:
    s = 10.0 ** digits
    return Vec(torch.round(vec.as_float() * s) / s, VecType.NUM)


def signif(vec: Vec, digits: int = 6) -> Vec:
    x = vec.as_float()
    mag = torch.pow(10.0, digits - 1 - torch.floor(torch.log10(x.abs())))
    out = torch.where(x == 0, 0.0, torch.round(x * mag) / mag)
    return Vec(out.to(torch.float32), VecType.NUM)


def ifelse(cond: Vec, yes, no) -> Vec:
    """Vectorized conditional (reference: ``AstIfElse``); NA test → NA."""
    c = cond.as_float()
    yv = yes.as_float() if isinstance(yes, Vec) else float(yes)
    nv = no.as_float() if isinstance(no, Vec) else float(no)
    if not isinstance(yv, torch.Tensor):
        yv = torch.full_like(c, yv)
    out = torch.where(torch.isnan(c), torch.nan, torch.where(c != 0, yv, nv))
    return Vec(out.to(torch.float32), VecType.NUM)


# -- reducers (host scalars) --------------------------------------------------


def _valid(vec: Vec):
    x = vec.as_float()
    return x, ~torch.isnan(x)


def vsum(vec: Vec) -> float:
    x, ok = _valid(vec)
    return float(torch.where(ok, x, 0.0).sum(dtype=torch.float64))


def vmean(vec: Vec) -> float:
    x, ok = _valid(vec)
    s, n = torch.stack([torch.where(ok, x, 0.0).sum(dtype=torch.float64),
                        ok.sum().double()]).tolist()
    return s / max(n, 1.0)


def _masked_extreme(vec: Vec, how: str) -> float:
    x, ok = _valid(vec)
    fill = torch.inf if how == "min" else -torch.inf
    m = torch.where(ok, x, fill)
    val = m.amin() if how == "min" else m.amax()
    v, n = torch.stack([val.double(), ok.sum().double()]).tolist() \
        if x.numel() else (0.0, 0.0)
    return v if n else float("nan")


def vmin(vec: Vec) -> float:
    return _masked_extreme(vec, "min")


def vmax(vec: Vec) -> float:
    return _masked_extreme(vec, "max")


def vvar(vec: Vec) -> float:
    """Sample variance (n - 1), NaN below two values."""
    x, ok = _valid(vec)
    xv = torch.where(ok, x, 0.0).double()
    cnt = ok.sum().double()
    d = torch.where(ok, xv - xv.sum() / cnt.clamp_min(1.0), 0.0)
    cnt, ss = torch.stack([cnt, (d * d).sum()]).tolist()
    return ss / (cnt - 1) if cnt >= 2 else float("nan")


def vsd(vec: Vec) -> float:
    return float(np.sqrt(max(vvar(vec), 0.0)))


def vprod(vec: Vec) -> float:
    x, ok = _valid(vec)
    return float(torch.where(ok, x, 1.0).prod())


def sorted_valid(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The non-NaN values of ``x`` sorted ascending (at the front of the
    returned tensor), and their count."""
    nan = torch.isnan(x)
    return (torch.sort(torch.where(nan, torch.inf, x)).values,
            int(x.numel() - nan.sum()))


def quantiles_sorted(s: torch.Tensor, n: int, probs) -> np.ndarray:
    """TYPE_7 quantiles (linear interpolation, as ``numpy.quantile``) of the
    ``n`` sorted values at the front of ``s``: positions in float64 on the
    host, the two neighbours gathered, interpolated in float64."""
    p = np.asarray(probs, np.float64)
    if n == 0:
        return np.full(len(p), np.nan)
    pos = p * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    idx = torch.as_tensor(np.concatenate([lo, hi]), device=s.device)
    v = s[idx].double().cpu().numpy()
    a, b = v[: len(p)], v[len(p):]
    return a + (b - a) * (pos - lo)


def vmedian(vec: Vec) -> float:
    s, n = sorted_valid(vec.as_float())
    return float(quantiles_sorted(s, n, [0.5])[0])


def vany(vec: Vec) -> bool:
    x, ok = _valid(vec)
    return bool((torch.where(ok, x, 0.0) != 0).any())


def vall(vec: Vec) -> bool:
    x, ok = _valid(vec)
    return bool(torch.where(ok, x != 0, True).all())


def quantile(frame: Frame, probs: Sequence[float] = (
        0.001, 0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99, 0.999)
        ) -> Frame:
    """Per-column quantiles of the numeric columns (reference:
    ``hex/quantile/Quantile.java``, TYPE_7 linear interpolation): one sort
    of each column's values, at any row count."""
    probs = list(probs)
    cols = {"Probs": np.asarray(probs, np.float64)}
    for n, v in zip(frame.names, frame.vecs):
        if v.data is not None and not v.is_categorical:
            cols[n] = quantiles_sorted(*sorted_valid(v.as_float()), probs)
    return Frame.from_arrays(cols, device=frame.device)


# -- cumulative ---------------------------------------------------------------


def _cum(vec: Vec, fn, neutral) -> Vec:
    x = vec.as_float()
    nan = torch.isnan(x)
    out = torch.where(nan, torch.nan, fn(torch.where(nan, neutral, x)))
    return Vec(out.to(torch.float32), VecType.NUM)


def cumsum(vec: Vec) -> Vec:
    return _cum(vec, lambda x: torch.cumsum(x, 0), 0.0)


def cumprod(vec: Vec) -> Vec:
    return _cum(vec, lambda x: torch.cumprod(x, 0), 1.0)


def cummin(vec: Vec) -> Vec:
    return _cum(vec, lambda x: torch.cummin(x, 0).values, torch.inf)


def cummax(vec: Vec) -> Vec:
    return _cum(vec, lambda x: torch.cummax(x, 0).values, -torch.inf)


# -- advmath utilities --------------------------------------------------------


def cut(vec: Vec, breaks: Sequence[float], labels: Sequence[str] | None = None,
        include_lowest: bool = False, right: bool = True) -> Vec:
    """Numeric → categorical binning (reference: ``AstCut``): right=True
    bins are (b[i], b[i+1]], the lowest break itself out of range unless
    ``include_lowest``."""
    br = np.asarray(breaks, np.float64)
    x = vec.as_float()
    e = torch.as_tensor(br.astype(np.float32), device=x.device)
    code = torch.searchsorted(e, x.contiguous(), right=not right) - 1
    b0, b1 = float(np.float32(br[0])), float(np.float32(br[-1]))
    oob = torch.isnan(x) | (x < b0) | (x > b1)
    if right and not include_lowest:
        oob = oob | (x == b0)
    if not right:
        oob = oob | (x == b1)
    if include_lowest and right:
        code = torch.where(x == b0, 0, code)
    code = torch.where(oob, -1, code.clamp(0, len(br) - 2)).to(torch.int32)
    if labels is None:
        op, cl = ("(", "]") if right else ("[", ")")
        labels = [f"{op}{br[i]:g},{br[i + 1]:g}{cl}"
                  for i in range(len(br) - 1)]
    return Vec(code, VecType.CAT, domain=tuple(labels))


def hist(vec: Vec, breaks: int | Sequence[float] = 20):
    """(counts, edges) histogram (reference: ``AstHist``)."""
    from h2o3_tpu_torch.rapids.munge import segment_sum
    x = vec.as_float()
    if isinstance(breaks, int):
        edges = np.linspace(vmin(vec), vmax(vec), breaks + 1)
    else:
        edges = np.asarray(breaks, np.float64)
    e = torch.as_tensor(edges.astype(np.float32), device=x.device)
    nb = len(edges) - 1
    idx = (torch.searchsorted(e, x.contiguous(), right=True) - 1).clamp(
        0, nb - 1)
    ok = ~torch.isnan(x) & (x >= e[0]) & (x <= e[-1])
    counts = segment_sum(ok.to(torch.float32), torch.where(ok, idx, nb),
                         nb + 1)[:nb]
    return counts.cpu().numpy(), edges


def impute(frame: Frame, column: str, method: str = "mean",
           by: Sequence[str] | None = None) -> Frame:
    """Fill NAs in place (reference: ``AstImpute``; h2o-py
    ``H2OFrame.impute``). Numeric: mean, median, min or max (grouped: mean
    or median), the column made NUM; categorical: the mode (grouped or
    not), type and domain kept. A group with no value takes the fill of
    the whole column."""
    from h2o3_tpu_torch.rapids.munge import (_group_median, frame_group_ids,
                                             segment_sum)
    v = frame.vec(column)
    if v.is_categorical:
        if method != "mode":
            raise ValueError("categorical impute requires method='mode'")
        K = max(v.cardinality(), 1)
        codes = v.data.long()
        ok = codes >= 0
        glob = segment_sum(ok.to(torch.int64),
                           torch.where(ok, codes.clamp(0, K - 1), K),
                           K + 1)[:K]
        gmode = glob.argmax()
        if by:
            gid, ng, _ = frame_group_ids(frame, list(by))
            comb = torch.where(ok, gid * K + codes.clamp(0, K - 1), ng * K)
            counts = segment_sum(ok.to(torch.int64), comb,
                                 ng * K + 1)[: ng * K].reshape(ng, K)
            mode_g = torch.where(counts.sum(1) > 0, counts.argmax(1), gmode)
            fill = mode_g[gid.clamp(0, max(ng - 1, 0))]
        else:
            fill = gmode
        new = torch.where(ok, codes, fill).to(torch.int32)
        frame.replace_vec(column, Vec(new, VecType.CAT, domain=v.domain))
        return frame

    x = v.as_float()
    if by:
        if method not in ("mean", "median"):
            raise ValueError("grouped numeric impute supports mean|median")
        gid, ng, _ = frame_group_ids(frame, list(by))
        ok = ~torch.isnan(x)
        c = segment_sum(ok.to(torch.float64), gid, ng + 1)
        if method == "mean":
            s = segment_sum(torch.where(ok, x, 0.0).double(), gid, ng + 1)
            per_group = (s / c.clamp_min(1.0)).to(torch.float32)
        else:
            per_group = _group_median(frame, column, gid, ng + 1)
        glob = vmean(v) if method == "mean" else vmedian(v)
        fill = torch.where(c > 0, per_group, glob)[gid]
    else:
        fill = {"mean": vmean, "median": vmedian, "min": vmin,
                "max": vmax}[method](v)
    out = torch.where(torch.isnan(x), fill, x)
    frame.replace_vec(column, Vec(out.to(torch.float32), VecType.NUM))
    return frame


def scale(frame: Frame, center: bool = True, scale_: bool = True) -> Frame:
    """Standardize the numeric columns (reference: ``AstScale``)."""
    vecs = []
    for v in frame.vecs:
        if v.data is not None and not v.is_categorical:
            x = v.as_float()
            if center:
                x = x - vmean(v)
            if scale_:
                x = x / max(vsd(v), 1e-30)
            vecs.append(Vec(x.to(torch.float32), VecType.NUM))
        else:
            vecs.append(v)
    return Frame(list(frame.names), vecs)
