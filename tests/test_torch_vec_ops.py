"""The element-wise Vec operators of the port (``h2o3_tpu_torch/frame/
vec.py``) against the JAX package's (``h2o3_tpu/frame/vec.py:303-400``):
the same columns (with missing values, zeros, negatives, a categorical
column and two TIME columns 25 years apart) through both. Arithmetic,
comparisons, ``& | ~``, ``isna`` and negation equal exactly (float32, NaN
where NaN); ``**`` within rtol 1e-6 (the two libraries' pow differ in the
last bit); TIME-TIME arithmetic runs on the exact float64 host values in
both."""

import numpy as np
import pytest

from rapids_pair import _cpu_port, pair, same_vec  # noqa: F401
from h2o3_tpu_torch.frame.types import VecType

N = 40
rng = np.random.default_rng(7)
A = rng.normal(size=N).astype(np.float32) * 3
A[[3, 11, 20]] = np.nan
A[[5, 6]] = 0.0
B = np.round(rng.normal(size=N) * 4).astype(np.float32)
B[[2, 11, 30]] = np.nan
B[[7, 8, 9]] = 0.0
G = rng.choice(["a", "b", "c"], size=N).astype(object)
G[[4, 13]] = None
T1 = (np.datetime64("2024-01-01T00:00:00", "ms")
      + rng.integers(0, 10 ** 9, N).astype("timedelta64[ms]"))
T2 = (np.datetime64("1999-06-01T00:00:00", "ms")
      + rng.integers(0, 10 ** 9, N).astype("timedelta64[ms]"))
T2[[1, 17]] = np.datetime64("NaT")


@pytest.fixture(scope="module")
def frames():
    return pair({"a": A, "b": B, "g": G, "t1": T1, "t2": T2},
                types={"t1": VecType.TIME, "t2": VecType.TIME})


OPS = ["__add__", "__sub__", "__mul__", "__truediv__", "__mod__",
       "__floordiv__", "__lt__", "__le__", "__gt__", "__ge__", "__eq__",
       "__ne__", "__and__", "__or__"]
ROPS = ["__radd__", "__rsub__", "__rmul__", "__rtruediv__", "__rmod__",
        "__rfloordiv__"]


@pytest.mark.parametrize("op", OPS + ["__pow__"])
def test_vec_by_vec(frames, op):
    jf, pf = frames
    rtol = 1e-6 if op == "__pow__" else 0.0
    same_vec(getattr(jf.vec("a"), op)(jf.vec("b")),
             getattr(pf.vec("a"), op)(pf.vec("b")), rtol=rtol, what=op)


@pytest.mark.parametrize("op", OPS + ROPS + ["__pow__", "__rpow__"])
@pytest.mark.parametrize("scalar", [2.5, -3.0, 0.0])
def test_vec_by_scalar(frames, op, scalar):
    jf, pf = frames
    rtol = 1e-6 if "pow" in op else 0.0
    same_vec(getattr(jf.vec("a"), op)(scalar),
             getattr(pf.vec("a"), op)(scalar), rtol=rtol,
             what=f"{op} {scalar}")


@pytest.mark.parametrize("which", ["neg", "invert", "isna"])
def test_unary(frames, which):
    jf, pf = frames
    fn = {"neg": lambda v: -v, "invert": lambda v: ~v,
          "isna": lambda v: v.isna()}[which]
    for c in ("a", "g"):
        same_vec(fn(jf.vec(c)), fn(pf.vec(c)), what=f"{which} {c}")


@pytest.mark.parametrize("level", ["a", "c", "zz"])
def test_categorical_compares_to_a_level(frames, level):
    """A string comparand is a level; an unknown one matches nothing (0,
    not NaN) and a missing row stays NaN."""
    jf, pf = frames
    same_vec(jf.vec("g") == level, pf.vec("g") == level, what=level)
    same_vec(jf.vec("g") != level, pf.vec("g") != level, what=level)


def test_string_comparand_needs_a_categorical(frames):
    _, pf = frames
    with pytest.raises(TypeError, match="categorical"):
        pf.vec("a") == "x"


@pytest.mark.parametrize("op", ["__sub__", "__add__", "__lt__", "__ge__",
                                "__eq__"])
def test_time_by_time_on_exact_host_values(frames, op):
    """Offsets 25 years apart: TIME-TIME results come from the float64
    epoch ms, equal in both packages and to numpy's."""
    jf, pf = frames
    got = getattr(pf.vec("t1"), op)(pf.vec("t2"))
    same_vec(getattr(jf.vec("t1"), op)(jf.vec("t2")), got, what=op)
    if op == "__sub__":
        want = (T1 - T2).astype("timedelta64[ms]").astype(np.float64)
        want[np.isnat(T2)] = np.nan
        np.testing.assert_array_equal(got.to_numpy(),
                                      want.astype(np.float32))


@pytest.mark.parametrize("op", ["__gt__", "__le__", "__sub__"])
def test_time_by_absolute_scalar(frames, op):
    """A scalar beside a TIME column is absolute epoch ms."""
    jf, pf = frames
    cut = float(np.datetime64("2024-01-06T00:00:00", "ms").astype(np.int64))
    same_vec(getattr(jf.vec("t1"), op)(cut), getattr(pf.vec("t1"), op)(cut),
             what=op)


def test_time_by_number_column(frames):
    """A TIME column beside a number column: the device values, aligned to
    the TIME column's offset."""
    jf, pf = frames
    same_vec(jf.vec("t1") > jf.vec("a"), pf.vec("t1") > pf.vec("a"))
    same_vec(jf.vec("a") < jf.vec("t2"), pf.vec("a") < pf.vec("t2"))


def test_vec_stays_hashable(frames):
    """``__eq__`` returns a Vec, so a Vec hashes by identity and can key a
    dict or a set; a length mismatch raises."""
    _, pf = frames
    a, b = pf.vec("a"), pf.vec("b")
    assert {a: 1, b: 2}[a] == 1 and len({a, b, a}) == 2
    with pytest.raises(ValueError, match="length"):
        a + pf[[0]].filter(a > 0).vec(0)
