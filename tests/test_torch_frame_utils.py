"""Frame utilities in the port (``h2o3_tpu_torch/frame/utils.py``) against
the JAX package's (``h2o3_tpu/frame/utils.py``): ``split_frame`` row for
row (the same ``np.random.default_rng(seed)`` draws), ``create_frame``
column for column (the same generator, drawn in the same order),
``interaction``, ``tf_idf`` and ``rebalance`` with equal names, types,
domains and values (numbers exactly in float32)."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame import utils as jutils
from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.types import VecType as JType
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame import utils
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


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


def _host(v):
    if v.is_categorical:
        return list(v.labels()[:v.nrows])
    if v.data is None:
        return list(v.host_values[:v.nrows])
    return np.asarray(v.to_numpy())[:v.nrows]


def _same(jf, pf):
    assert pf.names == jf.names and pf.nrows == jf.nrows
    for n in jf.names:
        jv, pv = jf.vec(n), pf.vec(n)
        assert str(pv.type) == str(jv.type), n
        if pv.is_categorical:
            assert tuple(pv.domain) == tuple(jv.domain), n
        a, b = _host(pv), _host(jv)
        if isinstance(a, list):
            assert a == b, n
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)


def _cols(n=300, seed=5):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=n).astype(np.float32),
            "k": rng.integers(0, 9, n).astype(np.float32),
            "c": np.array(["u", "v", "w", None], dtype=object)[
                rng.integers(0, 4, n)],
            "d": np.array(["p", "q", None], dtype=object)[
                rng.integers(0, 3, n)],
            "s": np.array([f"t{i % 7}" for i in range(n)], dtype=object)}


def _frames(n=300, seed=5):
    cols = _cols(n, seed)
    return (JFrame.from_arrays(cols, types={"s": JType.STR}),
            Frame.from_arrays(cols, types={"s": VecType.STR}))


@pytest.mark.parametrize("ratios,seed", [((0.75,), 1), ((0.5, 0.3), 42),
                                         ((0.8,), 7)])
def test_split_frame_row_for_row(ratios, seed):
    jf, pf = _frames()
    jparts = jutils.split_frame(jf, ratios, seed=seed)
    parts = utils.split_frame(pf, ratios, seed=seed)
    assert len(parts) == len(jparts) == len(ratios) + 1
    for a, b in zip(jparts, parts):
        _same(a, b)
    assert sum(p.nrows for p in parts) == pf.nrows


def test_split_frame_destination_keys_and_errors():
    _, pf = _frames()
    a, b = utils.split_frame(pf, (0.6,), destination_frames=["tr", "va"],
                             seed=3)
    assert DKV.get("tr") is a and DKV.get("va") is b
    for bad in ((), (0.0,), (0.6, 0.5)):
        with pytest.raises(ValueError):
            utils.split_frame(pf, bad)
    with pytest.raises(ValueError, match="destination_frames"):
        utils.split_frame(pf, (0.5,), destination_frames=["a"])


@pytest.mark.parametrize("kw", [
    dict(rows=200, cols=10, seed=3),
    dict(rows=150, cols=8, seed=11, has_response=True, response_factors=3,
         categorical_fraction=0.25, missing_fraction=0.1),
    dict(rows=100, cols=6, seed=2, has_response=True, response_factors=1,
         positive_response=True, string_fraction=0.2, time_fraction=0.2,
         integer_fraction=0.2, categorical_fraction=0.1),
    dict(rows=50, cols=4, randomize=False, value=2.5, seed=1),
], ids=["default", "cat_response", "str_time", "constant"])
def test_create_frame_equals_reference(kw):
    _same(jutils.create_frame(**kw), utils.create_frame(**kw))


def test_create_frame_refuses_fractions_over_one():
    with pytest.raises(ValueError, match="fractions"):
        utils.create_frame(categorical_fraction=0.6, integer_fraction=0.6)


@pytest.mark.parametrize("kw", [
    dict(factors=["c", "d"]),
    dict(factors=["c", "d"], max_factors=3),
    dict(factors=["c", "d"], min_occurrence=30),
    dict(factors=[["c", "d"], ["d", "c"]]),
    dict(factors=["c", "d"], pairwise=True),
], ids=["two", "max_factors", "min_occurrence", "groups", "pairwise"])
def test_interaction_equals_reference(kw):
    jf, pf = _frames()
    _same(jutils.interaction(jf, **kw), utils.interaction(pf, **kw))


def test_interaction_refuses_numeric_and_single_columns():
    _, pf = _frames()
    with pytest.raises(ValueError, match="categorical"):
        utils.interaction(pf, ["x", "c"])
    with pytest.raises(ValueError, match=">= 2"):
        utils.interaction(pf, [["c"]])


@pytest.mark.parametrize("doc_kind", ["num", "cat"])
@pytest.mark.parametrize("kw", [dict(), dict(case_sensitive=False),
                                dict(preprocess=False)])
def test_tf_idf_equals_reference(doc_kind, kw):
    texts = np.array(["The cat sat", "the Cat ran fast", None,
                      "dogs and cats", "The dog sat sat", "ÜBER über"],
                     dtype=object)
    docs = (np.float32([1, 2, 2, 3, 4, 5]) if doc_kind == "num"
            else np.array(["d1", "d2", "d2", "d3", None, "d5"],
                          dtype=object))
    cols = {"doc": docs, "text": texts}
    jf = JFrame.from_arrays(cols, types={"text": JType.STR})
    pf = Frame.from_arrays(cols, types={"text": VecType.STR})
    _same(jutils.tf_idf(jf, "doc", "text", **kw),
          utils.tf_idf(pf, "doc", "text", **kw))


def test_rebalance_copies_every_column():
    jf, pf = _frames()
    out = utils.rebalance(pf, key="rb")
    _same(jutils.rebalance(jf), out)
    assert out.key == "rb"
    assert out.vec("x").data.data_ptr() != pf.vec("x").data.data_ptr()
