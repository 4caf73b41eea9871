"""The string functions and ``tokenize`` in the port
(``h2o3_tpu_torch/rapids/strings.py``, ``rapids/advprims.py``) against the
JAX package's (``h2o3_tpu/rapids/strings.py``, ``advprims.py:756``): the
same STR and CAT columns (with missing values, empty strings and non-ASCII
text) through both, string results equal exactly, numeric results equal
in float32 with NaN where the string is missing, categorical results with
the same domain and codes."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.types import VecType as JType
from h2o3_tpu.frame.vec import Vec as JVec
from h2o3_tpu.rapids import advprims as jadv
from h2o3_tpu.rapids import strings as jstr
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.rapids import advprims, strings
from jax_reference import _jax_compile_cache  # noqa: F401

VALUES = np.array(["  Hello World ", "héllo wörld", None, "", "ABC abc",
                   "data,science", "Ünïcödé  TEXT", "x", "aaa bbb aaa",
                   None, "MiXeD CaSe", "tab\tsep"], dtype=object)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8
    cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def _pair(kind: str):
    if kind == "str":
        return (JVec.from_numpy(VALUES, type=JType.STR),
                Vec.from_numpy(VALUES, type=VecType.STR))
    return JVec.from_numpy(VALUES, type=JType.CAT), \
        Vec.from_numpy(VALUES, type=VecType.CAT)


def _strings(v) -> list:
    """A column's strings (None = missing), of either package."""
    if v.is_categorical:
        return list(v.labels()[:v.nrows])
    return list(v.host_values[:v.nrows])


def _same(jv, pv):
    assert str(jv.type) == str(pv.type)
    if pv.type in (VecType.STR, VecType.CAT):
        assert _strings(pv) == _strings(jv)
        if pv.is_categorical:
            assert tuple(pv.domain) == tuple(jv.domain)
            np.testing.assert_array_equal(pv.to_numpy(),
                                          jv.to_numpy()[:jv.nrows])
    else:
        np.testing.assert_array_equal(
            pv.to_numpy(), np.asarray(jv.to_numpy())[:jv.nrows])


STR_FNS = [
    ("toupper", (), {}), ("tolower", (), {}), ("trim", (), {}),
    ("lstrip", (), {}), ("lstrip", (" H",), {}), ("rstrip", (), {}),
    ("rstrip", ("e ",), {}), ("substring", (1, 4), {}),
    ("substring", (2,), {}), ("sub", ("a", "Z"), {}),
    ("sub", ("[aeiou]", "_"), {"ignore_case": True}),
    ("gsub", ("a", "Z"), {}), ("gsub", ("\\s+", "-"), {}),
    ("gsub", ("l", "L"), {"ignore_case": True}),
]
NUM_FNS = [
    ("nchar", (), {}), ("grep", ("a",), {}),
    ("grep", ("A",), {"ignore_case": True}),
    ("grep", ("o",), {"invert": True}), ("startswith", ("h",), {}),
    ("endswith", ("d",), {}), ("entropy", (), {}),
    ("num_valid_substrings", (["a", "ll", "ö", "zz"],), {}),
]


@pytest.mark.parametrize("kind", ["str", "cat"])
@pytest.mark.parametrize("name,args,kw", STR_FNS + NUM_FNS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(STR_FNS + NUM_FNS)])
def test_string_function_equals_reference(kind, name, args, kw):
    """Each function on the same column equals the reference exactly
    (numbers compared in float32, NaN at missing strings)."""
    jv, pv = _pair(kind)
    _same(getattr(jstr, name)(jv, *args, **kw),
          getattr(strings, name)(pv, *args, **kw))


def test_collapsing_levels_refactorize_like_the_reference():
    """tolower merging "A" and "a" into one level factorizes again, to the
    same sorted domain and codes."""
    vals = np.array(["A", "a", "B", None, "b", "a"], dtype=object)
    _same(jstr.tolower(JVec.from_numpy(vals, type=JType.CAT)),
          strings.tolower(Vec.from_numpy(vals, type=VecType.CAT)))


@pytest.mark.parametrize("kind", ["str", "cat"])
@pytest.mark.parametrize("pattern", [" ", "\\s+", "[,\\s]"])
def test_strsplit_equals_reference(kind, pattern):
    jv, pv = _pair(kind)
    jcols, pcols = jstr.strsplit(jv, pattern), strings.strsplit(pv, pattern)
    assert len(pcols) == len(jcols)
    for a, b in zip(jcols, pcols):
        _same(a, b)


def test_numeric_results_are_device_tensors():
    """A numeric result of a STR column is a float32 tensor on the chosen
    device; of a CAT column, on the column's device."""
    pv = _pair("str")[1]
    out = strings.nchar(pv, device="cpu")
    assert out.data.dtype == torch.float32 and out.data.device.type == "cpu"
    cv = _pair("cat")[1]
    assert strings.nchar(cv).data.device == cv.device
    with pytest.raises(TypeError, match="string op"):
        strings.toupper(Vec.from_numpy(np.float32([1, 2]), device="cpu"))


@pytest.mark.parametrize("split", [" ", "\\s+", "[ ,]"])
@pytest.mark.parametrize("kinds", [("str",), ("cat",), ("str", "cat")])
def test_tokenize_equals_reference(split, kinds):
    """One token a row and a missing row after each string (a missing
    string gives the missing row alone), column by column; empty tokens
    dropped."""
    jcols, pcols, jt, pt = {}, {}, {}, {}
    for i, k in enumerate(kinds):
        vals = VALUES if i == 0 else VALUES[::-1].copy()
        jcols[f"c{i}"] = vals
        pcols[f"c{i}"] = vals
        jt[f"c{i}"] = JType.STR if k == "str" else JType.CAT
        pt[f"c{i}"] = VecType.STR if k == "str" else VecType.CAT
    jf = JFrame.from_arrays(jcols, types=jt)
    pf = Frame.from_arrays(pcols, types=pt)
    jtok, ptok = jadv.tokenize(jf, split), advprims.tokenize(pf, split)
    assert ptok.names == jtok.names == ["token"]
    assert ptok.vec("token").type is VecType.STR
    assert list(ptok.vec("token").host_values) == \
        list(jtok.vec("token").host_values)
