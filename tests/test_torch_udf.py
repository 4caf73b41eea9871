"""Uploaded custom metrics and distributions in the port
(``h2o3_tpu_torch/utils/udf.py``, ``models/model_base.py``,
``models/gbm.py``, ``models/xgboost.py``) against the JAX package's
(``h2o3_tpu/utils/udf.py`` and its GBM), with the zips h2o-py generates
(tests/test_udf.py's sources):

- the loader, its bad references, the ``water.udf`` stand-in shared with
  the JAX package's in one process, and the distribution cache;
- the MAE metric on training and validation frames: equal to numpy's MAE
  of the port's predictions at rtol 1e-6, and to the reference's value at
  rtol 1e-5 (the two GBMs' leaves differ in float32's last bits);
- the custom gaussian GBM, batched, against the port's built-in gaussian
  (predictions at rtol 1e-5 plus atol 1e-5: f0 and the leaves sum in
  another order) and the reference's custom GBM (atol 1e-5, as
  tests/test_torch_gbm.py holds GBMs); XGBoost's gbtree alike, DART refused
  by both packages;
- the log-link distribution (a UDF using ``math.exp``: the row loop, so
  recorded) scoring in response space like the reference's;
- batched ``grad_hess`` against the row loop; a batched UDF that computes
  otherwise than its row loop raises;
- a JAX custom-distribution GBM converted, scoring alike."""

import io
import sys
import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.parse import RawFile as JRawFile
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.xgboost import XGBoost as JXGBoost
from h2o3_tpu.utils import udf as judf
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.parse import RawFile
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.models.xgboost import XGBoost
from h2o3_tpu_torch.utils import udf
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

MAE_METRIC_SRC = """# Generated code
import water.udf.CMetricFunc as MetricFunc

class CustomMaeFunc:
    def map(self, pred, act, w, o, model):
        return [w * abs(act[0] - pred[0]), w]

    def reduce(self, l, r):
        return [l[0] + r[0], l[1] + r[1]]

    def metric(self, l):
        return l[0] / l[1]

class CustomMaeFuncWrapper(CustomMaeFunc, MetricFunc, object):
    pass
"""

GAUSS_DIST_SRC = """# Generated code
import water.udf.CDistributionFunc as DistributionFunc

class CustomGaussianFunc:
    def link(self):
        return "identity"

    def init(self, w, o, y):
        return [w * (y - o), w]

    def gradient(self, y, f):
        return y - f

    def gamma(self, w, y, z, f):
        return [w * z, w]

class CustomGaussianFuncWrapper(CustomGaussianFunc, DistributionFunc, object):
    pass
"""

POISSON_MATH_SRC = """\
import water.udf.CDistributionFunc as DistributionFunc
class P:
    def link(self):
        return "log"
    def init(self, w, o, y):
        return [w * y, w]
    def gradient(self, y, f):
        import math
        return y - math.exp(min(f, 30.0))
    def gamma(self, w, y, z, f):
        import math
        return [w * z, w * math.exp(min(f, 30.0))]
class PWrapper(P, DistributionFunc, object):
    pass
"""

# computes on floats and on tensors, but not alike
TWOFACED_SRC = """\
import water.udf.CDistributionFunc as DistributionFunc
class T:
    def link(self):
        return "identity"
    def init(self, w, o, y):
        return [w * y, w]
    def gradient(self, y, f):
        return (y - f) if isinstance(y, float) else 2 * (y - f)
    def gamma(self, w, y, z, f):
        return [w * z, w]
class TWrapper(T, DistributionFunc, object):
    pass
"""

GAUSS_REF = "python:gauss=distributions.CustomGaussianFuncWrapper"
N = 320    # a multiple of 64: no pad rows in the reference's columns


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


def zip_bytes(fname: str, src: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(fname, src)
    return buf.getvalue()


def upload(key: str, fname: str, src: str) -> None:
    """The same zip under ``key`` in both packages' DKVs."""
    data = zip_bytes(fname, src)
    DKV.put(key, RawFile(data, name="func.jar"))
    JDKV.put(key, JRawFile(data, name="func.jar"))


def reg_cols(n=N, seed=42):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.1 * rng.normal(size=n)).astype(np.float32)
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "y": y}


def both(cols):
    return JFrame.from_arrays(cols), Frame.from_arrays(cols)


def preds(m, fr):
    out = m.predict(fr).vec("predict")
    return np.asarray(out.to_numpy())[:fr.nrows]


def test_loader_and_bad_references():
    upload("mae", "metrics.py", MAE_METRIC_SRC)
    obj = udf.load_cfunc("python:mae=metrics.CustomMaeFuncWrapper")
    assert obj.metric(obj.map([1.0], [3.0], 2.0, 0.0, None)) == 2.0
    DKV.put("raw_bytes", zip_bytes("metrics.py", MAE_METRIC_SRC))
    assert udf.load_cfunc("python:raw_bytes=metrics.CustomMaeFuncWrapper")
    with pytest.raises(ValueError, match="malformed"):
        udf.load_cfunc("not-a-ref")
    with pytest.raises(KeyError, match="PutKey"):
        udf.load_cfunc("python:absent=m.C")
    DKV.put("notzip", RawFile(b"plain bytes", name="x"))
    with pytest.raises(Exception):
        udf.load_cfunc("python:notzip=m.C")
    with pytest.raises(ValueError, match="language"):
        udf.load_cfunc("java:mae=metrics.CustomMaeFuncWrapper")
    with pytest.raises(ValueError, match="class name"):
        udf.load_cfunc("python:mae=metrics")
    with pytest.raises(KeyError, match="not defined"):
        udf.load_cfunc("python:mae=metrics.Nope")
    DKV.put("frame_key", object())
    with pytest.raises(TypeError, match="raw uploaded bytes"):
        udf.load_cfunc("python:frame_key=m.C")


def test_shim_is_shared_with_the_reference():
    """The port reuses a ``water.udf`` package already installed, so both
    packages load UDFs in one process, in either order."""
    upload("mae", "metrics.py", MAE_METRIC_SRC)
    judf.load_cfunc("python:mae=metrics.CustomMaeFuncWrapper")
    installed = sys.modules["water.udf"]
    udf.load_cfunc("python:mae=metrics.CustomMaeFuncWrapper")
    assert sys.modules["water.udf"] is installed
    judf.load_cfunc("python:mae=metrics.CustomMaeFuncWrapper")


def test_distribution_cache_by_reference_and_upload():
    upload("gauss", "distributions.py", GAUSS_DIST_SRC)
    a, b = udf.resolve_distribution(GAUSS_REF), \
        udf.resolve_distribution(GAUSS_REF)
    assert a is b and a.link_name == "identity"
    upload("gauss", "distributions.py", GAUSS_DIST_SRC + "\n# new\n")
    assert udf.resolve_distribution(GAUSS_REF) is not a


@pytest.mark.parametrize("kind", ["regression", "binomial"])
def test_mae_metric_on_training_and_validation(kind):
    upload("mae", "metrics.py", MAE_METRIC_SRC)
    cols, vcols = reg_cols(), reg_cols(seed=7)
    if kind == "binomial":
        for c in (cols, vcols):
            c["y"] = np.where(c["y"] > 0, "s", "b").astype(object)
    (jtr, ptr), (jva, pva) = both(cols), both(vcols)
    ref = "python:mae=metrics.CustomMaeFuncWrapper"
    jm = JGBM(ntrees=5, max_depth=3, seed=1, custom_metric_func=ref).train(
        y="y", training_frame=jtr, validation_frame=jva)
    pm = GBM(ntrees=5, max_depth=3, seed=1, custom_metric_func=ref).train(
        y="y", training_frame=ptr, validation_frame=pva)
    for jmm, pmm, fr, c in ((jm.training_metrics, pm.training_metrics, ptr,
                             cols),
                            (jm.validation_metrics, pm.validation_metrics,
                             pva, vcols)):
        assert pmm.custom_metric_name == jmm.custom_metric_name == "mae"
        assert pmm.custom_metric_value == pytest.approx(
            jmm.custom_metric_value, rel=1e-5)
        if kind == "regression":
            want = np.abs(c["y"] - preds(pm, fr)).mean()
        else:
            p = pm.predict(fr)
            label = p.vec("predict").to_numpy().astype(np.float64)
            want = np.abs((c["y"] == "s") - label).mean()
        assert pmm.custom_metric_value == pytest.approx(float(want),
                                                        rel=1e-6)


def test_metric_callable_directly():
    """A callable ``custom_metric_func`` is applied as given."""
    def rmse(p, y, w):
        return float(np.sqrt((w * (p - y) ** 2).sum() / w.sum()))
    _, ptr = both(reg_cols())
    m = GBM(ntrees=3, max_depth=2, custom_metric_func=rmse).train(
        y="y", training_frame=ptr)
    assert m.training_metrics.custom_metric_name == "rmse"
    assert m.training_metrics.custom_metric_value == pytest.approx(
        m.training_metrics.rmse, rel=1e-5)


@pytest.fixture(scope="module")
def gauss_models():
    """The custom gaussian GBM of both packages and the port's built-in
    gaussian, on the same frame."""
    upload("gauss", "distributions.py", GAUSS_DIST_SRC)
    jf, pf = both(reg_cols())
    kw = dict(ntrees=8, max_depth=3, seed=7)
    jm = JGBM(**kw, distribution="custom",
              custom_distribution_func=GAUSS_REF).train(y="y",
                                                        training_frame=jf)
    pm = GBM(**kw, distribution="custom",
             custom_distribution_func=GAUSS_REF).train(y="y",
                                                       training_frame=pf)
    builtin = GBM(**kw).train(y="y", training_frame=pf)
    return jf, pf, jm, pm, builtin


def test_custom_gaussian_equals_builtin_and_reference(gauss_models):
    jf, pf, jm, pm, builtin = gauss_models
    assert pm.output["custom_link"] == "identity"
    assert pm.output["custom_vectorized"] is True
    for a, b in zip(pm.output["trees"], builtin.output["trees"]):
        for k in ("feat", "thresh_bin", "na_left", "is_split"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    np.testing.assert_allclose(preds(pm, pf), preds(builtin, pf), rtol=1e-5,
                               atol=1e-5)
    assert pm.output["f0"] == pytest.approx(jm.output["f0"], rel=1e-12)
    for a, b in zip(pm.output["trees"], jm.output["trees"]):
        for k in ("feat", "thresh_bin", "na_left", "is_split"):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))
    np.testing.assert_allclose(preds(pm, pf), preds(jm, jf), atol=1e-5)
    assert pm.training_metrics.mse == pytest.approx(
        jm.training_metrics.mse, rel=1e-5)


def test_converted_custom_model_scores_alike(gauss_models):
    """A JAX custom-distribution GBM carries its link and reference; the
    reference's key must be in the port's DKV."""
    jf, pf, jm, _, _ = gauss_models
    upload("gauss", "distributions.py", GAUSS_DIST_SRC)
    out = dict(jm.output)
    out["trees"] = [{k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
                    for t in jm.output["trees"]]
    out["edges"] = np.asarray(out["edges"])
    cm = convert.gbm_model(out, response_column="y", params=jm.params,
                           device="cpu")
    assert cm.output["custom_link"] == "identity"
    np.testing.assert_allclose(preds(cm, pf), preds(jm, jf), rtol=1e-6,
                               atol=1e-6)
    DKV.remove("gauss")
    with pytest.raises(KeyError, match="gauss"):
        convert.gbm_model(out, response_column="y",
                          params=dict(jm.params, custom_distribution_func=
                                      "python:gauss=x.Y"), device="cpu")
    with pytest.raises(ValueError, match="custom_distribution_func"):
        convert.gbm_model(out, response_column="y", params={}, device="cpu")


def test_custom_requires_its_function():
    _, pf = both(reg_cols())
    with pytest.raises(ValueError, match="custom_distribution_func"):
        GBM(ntrees=2, distribution="custom").train(y="y", training_frame=pf)


def test_xgboost_custom_like_the_reference():
    """gbtree trains the custom distribution as GBM does, in both packages;
    DART refuses it in both (the reference's DART finds no registered
    distribution)."""
    upload("gauss", "distributions.py", GAUSS_DIST_SRC)
    jf, pf = both(reg_cols())
    kw = dict(ntrees=4, max_depth=3, seed=2, distribution="custom",
              custom_distribution_func=GAUSS_REF)
    jm = JXGBoost(**kw).train(y="y", training_frame=jf)
    pm = XGBoost(**kw).train(y="y", training_frame=pf)
    assert pm.output["custom_link"] == jm.output["custom_link"]
    np.testing.assert_allclose(preds(pm, pf), preds(jm, jf), atol=1e-5)
    with pytest.raises(Exception):
        JXGBoost(**kw, booster="dart").train(y="y", training_frame=jf)
    with pytest.raises(ValueError, match="dart"):
        XGBoost(**kw, booster="dart").train(y="y", training_frame=pf)


def test_log_link_scores_in_response_space_on_the_row_loop():
    """tests/test_udf.py:166's poisson UDF (``math.exp``): the row loop
    runs and is recorded; predictions are in response space, near the
    built-in poisson's, and equal the reference's custom GBM's."""
    upload("pois", "distributions.py", POISSON_MATH_SRC)
    rng = np.random.default_rng(42)
    x = rng.normal(size=N).astype(np.float32)
    t = rng.poisson(np.exp(0.5 * x)).astype(np.float32)
    jf, pf = both({"x": x, "t": t})
    kw = dict(ntrees=10, max_depth=3, seed=3, stopping_rounds=2,
              stopping_metric="deviance")
    ref = GBM(**kw, distribution="poisson").train(y="t", training_frame=pf)
    cus = GBM(**kw, distribution="custom",
              custom_distribution_func="python:pois=distributions.PWrapper"
              ).train(y="t", training_frame=pf)
    jcus = JGBM(**kw, distribution="custom",
                custom_distribution_func="python:pois=distributions.PWrapper"
                ).train(y="t", training_frame=jf)
    assert cus.output["custom_vectorized"] is False
    assert cus.output["custom_link"] == "log"
    pc = preds(cus, pf)
    assert pc.min() >= 0.0
    np.testing.assert_allclose(pc, preds(ref, pf), rtol=0.15, atol=0.3)
    assert cus.output["ntrees"] == jcus.output["ntrees"]
    np.testing.assert_allclose(pc, preds(jcus, jf), rtol=1e-4, atol=1e-5)


def test_batched_grad_hess_equals_the_row_loop():
    """On whole columns (weights 0 included): g and h of the batched path
    equal the row loop's, and the initial margin."""
    upload("gauss", "distributions.py", GAUSS_DIST_SRC)
    cd = udf.CustomDistribution(udf.load_cfunc(GAUSS_REF), GAUSS_REF)
    rng = np.random.default_rng(1)
    F, y = (torch.tensor(rng.normal(size=500).astype(np.float32))
            for _ in range(2))
    w = torch.tensor((rng.random(500) * (rng.random(500) > 0.2)
                      ).astype(np.float32))
    g, h = cd.grad_hess(F, y, w)
    assert cd.vectorized is True
    rg, rh = cd._gh_rows(*(t.double().numpy() for t in (F, y, w)))
    np.testing.assert_array_equal(g.numpy(), rg.astype(np.float32))
    np.testing.assert_array_equal(h.numpy(), rh.astype(np.float32))
    assert (h[w == 0] == np.float32(1e-10)).all() and (g[w == 0] == 0).all()
    jcd = judf.CustomDistribution(udf.load_cfunc(GAUSS_REF), GAUSS_REF)
    jg, jh = jcd.grad_hess(F.numpy(), y.numpy(), w.numpy())
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(h.numpy(), jh)
    assert cd.f0(y, w) == pytest.approx(jcd.f0(y.numpy(), w.numpy()),
                                        rel=1e-12)


def test_a_disagreeing_batched_udf_raises():
    upload("two", "distributions.py", TWOFACED_SRC)
    _, pf = both(reg_cols())
    with pytest.raises(ValueError, match="differs from its row loop"):
        GBM(ntrees=2, distribution="custom",
            custom_distribution_func="python:two=distributions.TWrapper"
            ).train(y="y", training_frame=pf)
