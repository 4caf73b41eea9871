"""Grep in the port (``h2o3_tpu_torch/models/grep_algo.py``) against the
JAX package's (``h2o3_tpu/models/grep_algo.py``): on STR and CAT columns
(missing values, empty strings, non-ASCII text) the matches frame's rows,
texts and offsets equal the reference's exactly, with its column types;
the model goes into the port's DKV; ``convert.grep_model`` carries a JAX
model's matches."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.types import VecType as JType
from h2o3_tpu.models.grep_algo import Grep as JGrep
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.models.grep_algo import Grep, GrepModel
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

TEXT = np.array(["the cat sat on the mat", None, "", "cats and dogs",
                 "ünïcödé cat", "concatenate", "no match here",
                 "cat cat cat"], dtype=object)


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


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


def _matches(m) -> tuple:
    fr = m.output["matches"]
    return (np.asarray(fr.vec("row").to_numpy())[:fr.nrows],
            list(fr.vec("match").host_values[:fr.nrows]),
            np.asarray(fr.vec("offset").to_numpy())[:fr.nrows],
            fr.types)


def _both(kind, regex, x=None):
    jt = {"t": JType.STR} if kind == "str" else {"t": JType.CAT}
    pt = {"t": VecType.STR} if kind == "str" else {"t": VecType.CAT}
    cols = {"n": np.arange(len(TEXT), dtype=np.float32), "t": TEXT}
    jf, pf = JFrame.from_arrays(cols, types=jt), \
        Frame.from_arrays(cols, types=pt)
    return (JGrep(regex=regex).train(x=x or ["t"], training_frame=jf),
            Grep(regex=regex).train(x=x or ["t"], training_frame=pf))


@pytest.mark.parametrize("kind", ["str", "cat"])
@pytest.mark.parametrize("regex", ["cat", "c.t", "\\bcat\\b", "[aeiou]+",
                                   "ü.", "^$", "zzz"])
def test_matches_rows_and_offsets_equal_reference(kind, regex):
    jm, pm = _both(kind, regex)
    jr, jt, jo, jtypes = _matches(jm)
    pr, pt, po, ptypes = _matches(pm)
    np.testing.assert_array_equal(pr, jr)
    assert pt == jt
    np.testing.assert_array_equal(po, jo)
    assert ptypes == jtypes
    assert isinstance(pm, GrepModel) and DKV.get(pm.key) is pm
    assert pm.matches is pm.output["matches"]
    assert pm.model_performance(None) is None


def test_column_choice_and_refusals():
    """``x`` as a name or list; a numeric column is refused; the frame's
    first column by default."""
    cols = {"t": TEXT, "n": np.arange(len(TEXT), dtype=np.float32)}
    pf = Frame.from_arrays(cols, types={"t": VecType.STR})
    a = Grep(regex="cat").train(x="t", training_frame=pf)
    b = Grep(regex="cat").train(training_frame=pf)
    assert _matches(a)[1] == _matches(b)[1]
    with pytest.raises(ValueError, match="string or categorical"):
        Grep(regex="1").train(x=["n"], training_frame=pf)
    with pytest.raises(ValueError, match="training_frame"):
        Grep().train(x=["t"])


def test_converted_model_keeps_the_matches():
    jm, _ = _both("str", "cat")
    fr = jm.output["matches"]
    n = fr.nrows
    pm = convert.grep_model({"matches": {
        "row": np.asarray(fr.vec("row").to_numpy())[:n],
        "match": list(fr.vec("match").host_values[:n]),
        "offset": np.asarray(fr.vec("offset").to_numpy())[:n]}},
        device="cpu")
    (pr, pt, po, _), (jr, jt, jo, _) = _matches(pm), _matches(jm)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(po, jo)
    assert pt == jt and len(pt) == 7
