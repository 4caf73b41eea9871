"""Shared by the Rapids tests of the port (``tests/test_torch_vec_ops.py``,
``_munge.py``, ``_rapids_ops.py``, ``_advprims.py``, ``_rapids_exec.py``):
the same numpy columns as a JAX-package frame and a port frame on the CPU,
and the comparison of their results. Not a test module of its own."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType


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


def pair(cols: dict, types: dict | None = None, key: str | None = None):
    """(JAX frame, port frame) of the same host columns."""
    jt = None
    if types:
        from h2o3_tpu.frame.types import VecType as JType
        jt = {k: JType(v.value) for k, v in types.items()}
    return (JFrame.from_arrays(cols, types=jt, key=key),
            Frame.from_arrays(cols, types=types, key=key))


def host(v) -> np.ndarray:
    """A column's values on the host, of either package: labels of a
    categorical column, strings of a host column, epoch ms of a TIME
    column, else float32 values."""
    n = v.nrows
    if v.is_categorical:
        return np.asarray(v.labels()[:n], dtype=object)
    if v.data is None:
        return np.asarray(v.host_values[:n], dtype=object)
    return np.asarray(v.to_numpy()[:n])


def same_vec(jv, pv, rtol: float = 0.0, atol: float = 0.0, what: str = "",
             time_atol: float = 0.0):
    """One column of each package alike: type, row count, domain, and
    values exactly (NaN where NaN) or within rtol/atol; TIME columns within
    ``time_atol`` ms (the JAX package's row gathers truncate epoch ms,
    ROADMAP queue C)."""
    assert str(pv.type) == str(jv.type), (what, pv.type, jv.type)
    assert pv.nrows == jv.nrows, (what, pv.nrows, jv.nrows)
    if pv.is_categorical:
        assert tuple(pv.domain) == tuple(jv.domain), what
        np.testing.assert_array_equal(pv.to_numpy(),
                                      jv.to_numpy()[:jv.nrows], what)
        return
    a, b = host(pv), host(jv)
    if pv.type is VecType.TIME and time_atol:
        np.testing.assert_allclose(a, b, rtol=0, atol=time_atol,
                                   equal_nan=True, err_msg=what)
    elif a.dtype == object:
        assert list(a) == list(b), what
    elif rtol == 0.0 and atol == 0.0:
        np.testing.assert_array_equal(a, b, what)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=what)


def same_frame(jf, pf, rtol: float = 0.0, atol: float = 0.0,
               exact=(), what: str = "", time_atol: float = 0.0):
    """Two frames alike: names, and every column by :func:`same_vec` —
    those in ``exact`` exactly, the others within rtol/atol."""
    assert pf.names == jf.names, (what, pf.names, jf.names)
    assert pf.nrows == jf.nrows, (what, pf.nrows, jf.nrows)
    for n in pf.names:
        tol = (0.0, 0.0) if n in exact else (rtol, atol)
        same_vec(jf.vec(n), pf.vec(n), *tol, what=f"{what}:{n}",
                 time_atol=time_atol)


def same_value(j, p, rtol: float = 0.0, atol: float = 0.0, what: str = ""):
    """Any result of either package alike: frames and columns as above,
    lists, strings and numbers (NaN equal to NaN)."""
    from h2o3_tpu.frame.vec import Vec as JVec
    if isinstance(j, JFrame):
        assert isinstance(p, Frame), (what, type(p))
        same_frame(j, p, rtol, atol, what=what)
    elif isinstance(j, JVec):
        same_vec(j, p, rtol, atol, what)
    elif isinstance(j, (list, tuple)):
        assert len(p) == len(j), what
        for a, b in zip(j, p):
            same_value(a, b, rtol, atol, what)
    elif isinstance(j, np.ndarray):
        np.testing.assert_allclose(np.asarray(p, np.float64),
                                   np.asarray(j, np.float64), rtol=rtol,
                                   atol=atol, equal_nan=True, err_msg=what)
    elif isinstance(j, str) or j is None:
        assert p == j, (what, p, j)
    else:
        a, b = float(p), float(j)
        if np.isnan(b):
            assert np.isnan(a), (what, a)
        else:
            assert a == pytest.approx(b, rel=rtol, abs=atol), (what, a, b)


__all__ = ["VecType", "pair", "same_frame", "same_value", "same_vec",
           "host", "_cpu_port"]
