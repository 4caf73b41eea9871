"""The math, reducers, quantiles, cumulative ops, ``cut``, ``hist``,
``impute`` and ``scale`` of the port (``h2o3_tpu_torch/rapids/ops.py``)
and its time functions (``rapids/timeops.py``) against the JAX package's
(``h2o3_tpu/rapids/ops.py``, ``timeops.py``), on the same columns with
missing values, zeros, negatives and infinities.

Exact: ``cut`` codes and labels, ``hist`` counts, floor/ceiling/trunc/
sign/abs/not/round, cummin/cummax, min/max/any/all, the imputed
categorical cells and the calendar fields. Within rtol 1e-6 (atol 1e-6):
the transcendental functions, where XLA's float32 and torch's differ in
the last bits (the gamma family within 1e-5; trigamma of negative numbers,
wrong in the JAX package, is held to scipy's); means, sums and
variances, which the port adds in float64 and the JAX package in float32,
within 1e-5; quantiles and medians within 1e-6 (the port interpolates in
float64, the JAX package in float32); cumsum and cumprod within 1e-5
(another order of additions); imputed numeric cells (a float64 mean)
within rtol 1e-5 plus atol 1e-6."""

import numpy as np
import pytest

from rapids_pair import _cpu_port, pair, same_frame, same_vec  # noqa: F401
from h2o3_tpu.rapids import ops as jops
from h2o3_tpu.rapids import timeops as jtime
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.rapids import ops, timeops
from jax_reference import _jax_compile_cache  # noqa: F401

N = 120
rng = np.random.default_rng(21)
X = (rng.normal(size=N) * 3).astype(np.float32)
X[[1, 9, 40]] = np.nan
X[[2, 3]] = 0.0
X[4], X[5] = 2.5, -2.5
P = rng.uniform(0.05, 3.0, N).astype(np.float32)      # positive
P[[7, 60]] = np.nan
U = rng.uniform(-0.95, 0.95, N).astype(np.float32)     # in (-1, 1)
G = rng.choice(["a", "b", "c"], size=N).astype(object)
C = rng.choice(["u", "v", "w"], size=N, p=[0.2, 0.5, 0.3]).astype(object)
C[rng.choice(N, 20, replace=False)] = None
XA = X.copy()
XA[G == "c"] = np.nan                   # group c: nothing to impute from
T = (np.datetime64("1999-12-30T22:10:05.250", "ms")
     + (rng.integers(0, 4 * 10 ** 10, N)).astype("timedelta64[ms]"))
T[[0, 50]] = np.datetime64("NaT")
COLS = {"x": X, "p": P, "u": U, "g": G, "c": C, "xa": XA, "t": T,
        "s": np.array([f"2021-0{i % 9 + 1}-1{i % 9}" if i % 7 else "bad"
                       for i in range(N)], dtype=object)}
TYPES = {"t": VecType.TIME, "s": VecType.STR}


@pytest.fixture(scope="module")
def frames():
    return pair(COLS, types=TYPES)


EXACT = ("abs", "sign", "floor", "ceiling", "trunc", "not", "none")
GAMMA = ("gamma", "lgamma", "digamma", "trigamma")
DOMAIN = {"sqrt": "p", "log": "p", "log2": "p", "log10": "p", "log1p": "p",
          "asin": "u", "acos": "u", "atanh": "u", "acosh": "p",
          "gamma": "p", "lgamma": "x", "digamma": "x", "trigamma": "p"}


@pytest.mark.parametrize("name", sorted(jops._UNARY))
def test_math_op(frames, name):
    jf, pf = frames
    col = DOMAIN.get(name, "x")
    rtol = 0.0 if name in EXACT else 1e-5 if name in GAMMA else 1e-6
    same_vec(jops.math_op(name, jf.vec(col)), getattr(ops, name)(
        pf.vec(col)), rtol=rtol, atol=rtol, what=name)


def test_math_edges_follow_jax():
    """sign(NaN) is NaN; digamma is NaN and trigamma inf at 0 and the
    negative integers; trigamma NaN at +inf, inf at -inf."""
    v = np.float32([np.nan, 0.0, -2.0, np.inf, -np.inf, 1.5])
    jf, pf = pair({"v": v})
    for name in ("sign", "digamma", "trigamma"):
        same_vec(jops.math_op(name, jf.vec("v")),
                 ops.math_op(name, pf.vec("v")), rtol=1e-5, what=name)
    with pytest.raises(ValueError, match="unknown math op"):
        ops.math_op("cube", pf.vec("v"))
    with pytest.raises(AttributeError):
        ops.cube


def test_trigamma_of_negative_numbers_is_scipys():
    """At negative non-integers the JAX package's trigamma is wrong (at
    -8.821296 it gives -1258.9; trigamma is positive; ROADMAP queue C);
    the port's is scipy's within 1e-5."""
    import scipy.special as sp
    v = np.float32([-8.821296, -0.5, -1.5, -3.25])
    jf, pf = pair({"v": v})
    got = ops.math_op("trigamma", pf.vec("v")).to_numpy()
    np.testing.assert_allclose(got, sp.polygamma(1, v.astype(np.float64)),
                               rtol=1e-5)
    ref = jops.math_op("trigamma", jf.vec("v")).to_numpy()
    assert ref[0] < 0


@pytest.mark.parametrize("digits", [0, 1, 2, -1])
def test_round_and_signif(frames, digits):
    jf, pf = frames
    same_vec(jops.round_(jf.vec("x"), digits), ops.round_(pf.vec("x"),
                                                          digits))
    same_vec(jops.signif(jf.vec("x"), digits + 2),
             ops.signif(pf.vec("x"), digits + 2), rtol=1e-6)


def test_ifelse(frames):
    jf, pf = frames
    for yes, no in ((1.0, -1.0), ("p", 0.0), (2.0, "u"), ("p", "u")):
        jy, py = (jf.vec(yes), pf.vec(yes)) if isinstance(yes, str) \
            else (yes, yes)
        jn, pn = (jf.vec(no), pf.vec(no)) if isinstance(no, str) else (no, no)
        same_vec(jops.ifelse(jf.vec("x") > 0, jy, jn),
                 ops.ifelse(pf.vec("x") > 0, py, pn))


@pytest.mark.parametrize("name,rtol", [
    ("vsum", 1e-5), ("vmean", 1e-5), ("vmin", 0), ("vmax", 0),
    ("vvar", 1e-5), ("vsd", 1e-5), ("vprod", 1e-5), ("vmedian", 1e-6),
    ("vany", 0), ("vall", 0)])
@pytest.mark.parametrize("col", ["x", "p", "g"])
def test_reducers(frames, name, rtol, col):
    jf, pf = frames
    j, p = getattr(jops, name)(jf.vec(col)), getattr(ops, name)(pf.vec(col))
    assert type(p) is type(j)
    assert p == pytest.approx(j, rel=rtol, abs=rtol), (name, col)


def test_reducers_on_no_values():
    jf, pf = pair({"v": np.float32([np.nan, np.nan])})
    for name in ("vsum", "vmean", "vmin", "vmax", "vvar", "vmedian", "vany",
                 "vall", "vprod"):
        j, p = getattr(jops, name)(jf.vec("v")), getattr(ops, name)(
            pf.vec("v"))
        assert (np.isnan(p) and np.isnan(j)) or p == j, name


@pytest.mark.parametrize("probs", [None, [0.5], [0.0, 0.333, 1.0]])
def test_quantile(frames, probs):
    jf, pf = frames
    sub_j, sub_p = jf[["x", "p", "g", "u"]], pf[["x", "p", "g", "u"]]
    if probs is None:
        same_frame(sub_j.quantile(), sub_p.quantile(), rtol=1e-6,
                   exact=["Probs"])
    else:
        same_frame(jops.quantile(sub_j, probs), ops.quantile(sub_p, probs),
                   rtol=1e-6, exact=["Probs"])


def test_quantile_past_torchs_limit():
    """More than 2^24 values (``torch.quantile`` refuses them): one sort,
    equal to numpy's float64 TYPE_7 quantiles of the same float32
    values."""
    n = (1 << 24) + 1000
    x = np.random.default_rng(0).random(n, dtype=np.float32)
    x[::1001] = np.nan
    fr = Frame.from_arrays({"x": x})
    probs = [0.001, 0.25, 0.5, 0.999]
    got = ops.quantile(fr, probs).vec("x").to_numpy()
    want = np.nanquantile(x.astype(np.float64), probs)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-7)
    assert ops.vmedian(fr.vec("x")) == pytest.approx(want[2], rel=1e-12)


@pytest.mark.parametrize("name", ["cumsum", "cumprod", "cummin", "cummax"])
def test_cumulative(frames, name):
    jf, pf = frames
    col = "u" if name == "cumprod" else "x"
    rtol = 1e-5 if name in ("cumsum", "cumprod") else 0.0
    same_vec(getattr(jops, name)(jf.vec(col)),
             getattr(ops, name)(pf.vec(col)), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("kw", [
    dict(), dict(include_lowest=True), dict(right=False),
    dict(labels=["lo", "mid", "hi"])])
def test_cut(frames, kw):
    jf, pf = frames
    br = [-2.5, 0.0, 2.5, 9.0]
    same_vec(jops.cut(jf.vec("x"), br, **kw), ops.cut(pf.vec("x"), br, **kw))


@pytest.mark.parametrize("breaks", [5, [-3.0, -1.0, 0.0, 2.5, 5.0]])
def test_hist(frames, breaks):
    jf, pf = frames
    jc, je = jops.hist(jf.vec("x"), breaks)
    pc, pe = ops.hist(pf.vec("x"), breaks)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pe, je)


@pytest.mark.parametrize("method", ["mean", "median", "min", "max"])
def test_impute_numeric(frames, method):
    jf, pf = frames
    j, p = jf[["x", "g"]], pf[["x", "g"]]
    jops.impute(j, "x", method)
    ops.impute(p, "x", method)
    same_frame(j, p, rtol=1e-5, atol=1e-6)
    assert np.isnan(pf.vec("x").to_numpy()).any()   # a copy was imputed


@pytest.mark.parametrize("method", ["mean", "median"])
def test_impute_grouped_numeric_with_an_empty_group(frames, method):
    """Group c has no value: it takes the column's fill."""
    jf, pf = frames
    j, p = jf[["xa", "g"]], pf[["xa", "g"]]
    j.impute("xa", method, by=["g"])
    p.impute("xa", method, by=["g"])
    same_frame(j, p, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="mean|median"):
        ops.impute(pf[["xa", "g"]], "xa", "min", by=["g"])


@pytest.mark.parametrize("by", [None, ["g"]])
def test_impute_categorical_mode(frames, by):
    jf, pf = frames
    j, p = jf[["c", "g"]], pf[["c", "g"]]
    jops.impute(j, "c", "mode", by)
    ops.impute(p, "c", "mode", by)
    same_frame(j, p)
    with pytest.raises(ValueError, match="mode"):
        ops.impute(pf[["c"]], "c", "mean")


@pytest.mark.parametrize("center,scale", [(True, True), (True, False),
                                          (False, True)])
def test_scale(frames, center, scale):
    jf, pf = frames
    cols = ["x", "p", "g", "s"]
    same_frame(jf[cols].scale(center, scale), pf[cols].scale(center, scale),
               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["year", "month", "day", "hour", "minute",
                                  "second", "millis", "day_of_week", "week"])
def test_time_fields(frames, name):
    jf, pf = frames
    same_vec(getattr(jtime, name)(jf.vec("t")),
             getattr(timeops, name)(pf.vec("t")), what=name)


def test_time_functions_refuse_other_columns(frames):
    _, pf = frames
    with pytest.raises(TypeError, match="time op"):
        timeops.year(pf.vec("x"))


def test_as_date_and_mktime(frames):
    jf, pf = frames
    same_vec(jtime.as_date(jf.vec("s"), "yyyy-MM-dd"),
             timeops.as_date(pf.vec("s"), "yyyy-MM-dd"))
    jg, pg = pair({"g": np.array(["2020-01-15", "x", None], dtype=object)})
    same_vec(jtime.as_date(jg.vec("g"), "yyyy-MM-dd"),
             timeops.as_date(pg.vec("g"), "yyyy-MM-dd"))
    ymd = {"y": np.float32([2020, 2021, np.nan, 1969]),
           "m": np.float32([1, 6, 3, 12]), "d": np.float32([15, 30, 1, 31]),
           "h": np.float32([0, 23, 1, 5])}
    jy, py = pair(ymd)
    same_vec(jtime.mktime(jy.vec("y"), jy.vec("m"), jy.vec("d"), jy.vec("h")),
             timeops.mktime(py.vec("y"), py.vec("m"), py.vec("d"),
                            py.vec("h")))
    same_vec(jtime.mktime(jy.vec("y")), timeops.mktime(py.vec("y")))
