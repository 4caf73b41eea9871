"""The MOJO pipeline runtime of the port (``h2o3_tpu_torch/genmodel/
pipeline.py``) against the JAX package's (``h2o3_tpu/genmodel/
pipeline.py``): the cases of ``tests/test_pipeline.py`` on both packages'
frames of the same columns, every output column equal (numeric at rtol
1e-6: float32 transcendental functions of two libraries; string and time
columns exactly), and a pipeline artifact (transforms and a GBM's MOJO)
saved by either package loads and predicts in the other, equal to the
saver's predictions at rtol 1e-5, atol 1e-6 (``tests/test_mojo_v2.py``'s
tolerance).
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.types import VecType as JType
from h2o3_tpu.genmodel import pipeline as jpipe
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.genmodel import pipeline as ppipe
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
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


COLS = {
    "a": np.float32([1.0, 4.0, 9.0, np.nan, -2.5, 0.0, 0.3, 7.0]),
    "b": np.float32([2.0, 2.0, 3.0, 4.0, -1.0, 0.5, 0.0, 3.0]),
    "s": np.array(["  Hello World ", "foo", None, "a b c", "x", "",
                   "Tab\tsep", "o o"], dtype=object),
    "n": np.array(["1.5", "x", "3", None, "-2", "1e3", " 4", "nan"],
                  dtype=object),
}


def frames():
    return (JFrame.from_arrays(COLS, types={"s": JType.STR, "n": JType.STR}),
            Frame.from_arrays(COLS, types={"s": VecType.STR,
                                           "n": VecType.STR}))


def same_frames(p, j, rtol: float = 1e-6) -> None:
    assert p.names == j.names
    n = p.nrows
    for c in p.names:
        pv, jv = p.vec(c), j.vec(c)
        if pv.type in (VecType.STR,):
            assert list(pv.host_values[:n]) == list(jv.host_values[:n]), c
        else:
            np.testing.assert_allclose(pv.to_numpy(), jv.to_numpy()[:n],
                                       rtol=rtol, atol=1e-7, err_msg=c)


STEPS = {
    "math": [("math_unary", "sqrt", ["a"], "sq", None),
             ("math_binary", "*", ["sq", "b"], "prod", None),
             ("math_binary", "+", ["a"], "plus5", {"constant": 5.0}),
             ("math_binary", "-", ["a"], "rev", {"constant": 5.0,
                                                 "reverse": True}),
             ("math_binary", "%", ["a", "b"], "mod", None),
             ("math_binary", "intDiv", ["a", "b"], "idiv", None),
             ("math_binary", ">=", ["a", "b"], "ge", None),
             ("math_binary", "max", ["a"], "mx", {"constant": 1.0}),
             ("math_unary", "signif", ["a"], "sig", {"digits": 2}),
             ("math_unary", "lgamma", ["b"], "lg", None),
             ("math_unary", "cospi", ["b"], "cp", None),
             ("math_unary", "round", ["b"], "rd", None)],
    "strings": [("string_unary", "trim", ["s"], "t", None),
                ("string_unary", "tolower", ["t"], "l", None),
                ("string_prop", "length", ["l"], "len", None),
                ("string_prop", "entropy", ["s"], "ent", None),
                ("string_grep", "grep", ["s"], "has_o", {"regex": "o"}),
                ("to_numeric", "as.numeric", ["n"], "num", None),
                ("to_string", "as.character", ["a"], "astr", None)],
    "split": [("string_split", "split", ["s"], "w",
               {"pattern": r"\s+"})],
    "in_place": [("math_unary", "sqrt", ["a"], "a", None)],
}


def _pipes(steps):
    return (jpipe.MojoPipeline([jpipe.Transform(*s) for s in steps]),
            ppipe.MojoPipeline([ppipe.Transform(*s) for s in steps]))


@pytest.mark.parametrize("case", list(STEPS))
def test_transforms_as_the_reference(case):
    jf, pf = frames()
    jp, pp = _pipes(STEPS[case])
    same_frames(pp.transform(pf), jp.transform(jf))
    if case == "in_place":
        assert pp.transform(pf).names.count("a") == 1


def test_time_transforms_as_the_reference():
    ts = np.array(["2024-02-29T13:45:30", "1999-12-31T23:59:59",
                   "2000-01-03T00:00:00"], dtype="datetime64[ms]")
    steps = [("time_unary", op, ["t"], op, None)
             for op in ppipe.TIME_UNARY]
    jp, pp = _pipes(steps)
    j = jp.transform(JFrame.from_arrays({"t": ts}, types={"t": JType.TIME}))
    p = pp.transform(Frame.from_arrays({"t": ts},
                                       types={"t": VecType.TIME}))
    for op in ppipe.TIME_UNARY:
        assert p.vec(op).to_numpy().tolist() == \
            j.vec(op).to_numpy()[:3].tolist(), op


def test_unknown_op_rejected():
    with pytest.raises(ValueError, match="unsupported"):
        ppipe.Transform("math_unary", "frobnicate", ["a"], "out")
    with pytest.raises(ValueError, match="unsupported time op"):
        ppipe.Transform("time_unary", "fortnight", ["t"], "out")


@pytest.fixture(scope="module")
def train_cols():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(256, 2)).astype(np.float32)
    return {"x0": x[:, 0], "x1": x[:, 1],
            "y": np.where(x[:, 0] * x[:, 0] + x[:, 1] > 1, "t", "f")}


PRE = [("math_unary", "abs", ["x0"], "x0_abs", None),
       ("math_binary", "*", ["x0", "x0"], "x0_sq", None)]


def test_a_port_pipeline_loads_in_the_reference(train_cols, tmp_path):
    from h2o3_tpu_torch.models.gbm import GBM
    pre = [ppipe.Transform(*s) for s in PRE]
    tf = Frame.from_arrays(train_cols)
    m = GBM(ntrees=4, max_depth=3, seed=2).train(
        y="y", training_frame=ppipe.MojoPipeline(pre).transform(tf))
    pipe = ppipe.MojoPipeline(pre, model=m)
    want = pipe.predict(tf).vec("pt").to_numpy()
    path = pipe.save(str(tmp_path / "pipe.zip"))
    back = ppipe.MojoPipeline.load(path, device="cpu")
    assert len(back.transforms) == 2
    assert np.array_equal(back.predict(tf).vec("pt").to_numpy(), want)
    jback = jpipe.MojoPipeline.load(path)
    got = jback.predict(JFrame.from_arrays(train_cols)).vec("pt").to_numpy()
    np.testing.assert_allclose(got[:256], want, rtol=1e-5, atol=1e-6)


def test_a_reference_pipeline_loads_in_the_port(train_cols, tmp_path):
    from h2o3_tpu.genmodel.mojo import MojoModel as JMojo
    from h2o3_tpu_torch.models.gbm import GBM
    pre = [ppipe.Transform(*s) for s in PRE]
    pf = Frame.from_arrays(train_cols)
    m = GBM(ntrees=4, max_depth=3, seed=2).train(
        y="y", training_frame=ppipe.MojoPipeline(pre).transform(pf))
    # the JAX package's pipeline around the same model, as that package
    # reads it from the port's MOJO
    jm = JMojo.load(m.download_mojo(str(tmp_path / "m.mojo")))._inner
    jp = jpipe.MojoPipeline([jpipe.Transform(*s) for s in PRE], model=jm)
    path = jp.save(str(tmp_path / "jpipe.zip"))
    want = jp.predict(JFrame.from_arrays(train_cols)).vec("pt").to_numpy()
    back = ppipe.MojoPipeline.load(path, device="cpu")
    got = back.predict(pf).vec("pt").to_numpy()
    np.testing.assert_allclose(got, want[:256], rtol=1e-5, atol=1e-6)
