"""The parameters that name a DKV key (``h2o3_tpu_torch/utils/
registry.py``) against the JAX package's: ``checkpoint`` by key (also for
cross-validation, where every fold resumes from the key), GBM's
``calibration_frame`` and GLM's ``plug_values`` by key; and the finished
model in the DKV under its key, its build holding the write lock on its
``model_id``.

Row counts are multiples of 64, so the reference's frames carry no pad
rows (tests/conftest.py's 8 devices). The checkpoint is the JAX
package's model carried into the port by ``convert`` under its own key,
so both packages resume the same trees. Tolerances are
tests/test_torch_cv.py's: pooled out-of-fold probabilities at atol 1e-5,
CV AUC within 1e-4, logloss at rtol 1e-4; calibration's Platt
coefficients at rtol 1e-4 (fitted on the two packages' scores of the same
trees, which differ in float32 ulps); GLM tests/test_torch_glm.py's
``assert_same_fit`` (coefficients rtol 1e-4, predictions rtol 1e-5).
Within the port, a key and the object it names give the same bits.
"""

import threading

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.utils.registry import DKV, LOCKS
from jax_reference import _jax_compile_cache  # noqa: F401

N = 512
X = ["x0", "x1", "x2"]
KW = dict(max_depth=3, nbins=16, learn_rate=0.2, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    """Each test starts and ends with an empty port DKV (other files'
    models may share this process)."""
    DKV.clear()
    yield
    DKV.clear()


def cols_of(n=N, seed=11):
    rng = np.random.default_rng(seed)
    Xn = rng.normal(size=(n, 3)).astype(np.float32)
    logit = 1.4 * Xn[:, 0] - Xn[:, 1] + 0.5 * Xn[:, 2] * Xn[:, 0]
    yb = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    yg = (Xn @ np.float32([1.0, -0.5, 0.3])
          + 0.2 * rng.normal(size=n)).astype(np.float32)
    cols = {f"x{i}": Xn[:, i].copy() for i in range(3)}
    cols["x1"][rng.random(n) < 0.05] = np.nan
    cols.update(yb=yb, yg=yg)
    return cols


def carried_gbm(jm, params):
    """The JAX GBM in the port, under the JAX model's key."""
    o = jm.output
    out = dict(trees=[{k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
                      for t in o["trees"]],
               edges=np.asarray(o["edges"]), f0=o["f0"],
               learn_rate=o["learn_rate"], distribution=o["distribution"],
               x_cols=o["x_cols"], feat_domains=o["feat_domains"],
               ntrees=o["ntrees"])
    pm = convert.gbm_model(out, response_column=jm.response_column,
                           response_domain=jm.response_domain,
                           params=params)
    pm.key = jm.key
    return pm


def test_a_finished_model_is_in_the_dkv_under_its_key():
    fr = Frame.from_arrays(cols_of())
    named = GBM(ntrees=2, model_id="gbm_named", **KW).train(
        x=X, y="yb", training_frame=fr)
    anon = GLM(family="binomial").train(x=X, y="yb", training_frame=fr)
    cv = GBM(ntrees=2, nfolds=3, **KW).train(x=X, y="yb", training_frame=fr)
    assert named.key == "gbm_named" and DKV["gbm_named"] is named
    assert DKV[anon.key] is anon and DKV[cv.key] is cv
    # the main models only: a fold's model is not kept
    assert sorted(DKV.keys()) == sorted([named.key, anon.key, cv.key])


def test_a_build_holds_the_write_lock_on_its_model_id():
    """A second thread's write lock on the model id waits for the build's
    DKV put: when it gets the lock, the model is there."""
    fr = Frame.from_arrays(cols_of())
    seen = {}
    started = threading.Event()
    builder = GBM(ntrees=3, model_id="locked_gbm", **KW)
    inner = builder._fit

    def slow_fit(*a, **k):
        started.set()
        return inner(*a, **k)

    builder._fit = slow_fit

    def deleter():
        started.wait(10)
        with LOCKS.write("locked_gbm"):
            seen["model"] = DKV.get("locked_gbm")

    t = threading.Thread(target=deleter, daemon=True)
    t.start()
    m = builder.train(x=X, y="yb", training_frame=fr)
    t.join(30)
    assert not t.is_alive() and seen["model"] is m


def test_resume_from_a_key_equals_resume_from_the_model():
    fr = Frame.from_arrays(cols_of())
    half = GBM(ntrees=3, sample_rate=0.7, **KW).train(x=X, y="yb",
                                                       training_frame=fr)
    by_model, by_key = (GBM(ntrees=6, sample_rate=0.7, checkpoint=cp,
                            **KW).train(x=X, y="yb", training_frame=fr)
                        for cp in (half, half.key))
    assert by_key.params["checkpoint"] == half.key
    for a, b in zip(by_model.output["trees"], by_key.output["trees"]):
        for f in HEAP_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert by_model.training_metrics.auc == by_key.training_metrics.auc


def test_an_unknown_checkpoint_key_raises_as_the_reference():
    cols = cols_of()
    with pytest.raises(ValueError, match="not found in DKV") as jerr:
        JGBM(ntrees=2, checkpoint="no_such_model").train(
            x=X, y="yb", training_frame=JFrame.from_arrays(cols))
    with pytest.raises(ValueError, match="not found in DKV") as perr:
        GBM(ntrees=2, checkpoint="no_such_model").train(
            x=X, y="yb", training_frame=Frame.from_arrays(cols))
    assert str(perr.value) == str(jerr.value)


def test_cv_with_a_checkpoint_matches_the_reference():
    """Each fold resumes the checkpoint's trees, by key, in both
    packages."""
    cols = cols_of()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jhalf = JGBM(ntrees=2, **KW).train(x=X, y="yb", training_frame=jf)
    DKV.put(jhalf.key, carried_gbm(jhalf, dict(KW, ntrees=2)))
    cv = dict(ntrees=4, nfolds=3, keep_cross_validation_predictions=True,
              checkpoint=jhalf.key, **KW)
    jm = JGBM(**cv).train(x=X, y="yb", training_frame=jf)
    pm = GBM(**cv).train(x=X, y="yb", training_frame=pf)
    n = pf.nrows
    np.testing.assert_array_equal(pm.cv_holdout_mask.numpy(),
                                  np.asarray(jm.cv_holdout_mask)[:n])
    np.testing.assert_allclose(pm.cv_holdout_predictions.numpy(),
                               np.asarray(jm.cv_holdout_predictions)[:n],
                               atol=1e-5)
    jc, pc = jm.cross_validation_metrics, pm.cross_validation_metrics
    assert abs(pc.auc - jc.auc) < 1e-4
    np.testing.assert_allclose(pc.logloss, jc.logloss, rtol=1e-4)
    assert len(pm.output["trees"]) == len(jm.output["trees"]) == 4


def test_calibration_frame_by_key_matches_the_reference():
    cols, ccols = cols_of(), cols_of(256, seed=12)
    pcf = Frame.from_arrays(ccols)
    JDKV.put("calib.hex", JFrame.from_arrays(ccols))
    DKV.put("calib.hex", pcf)
    kw = dict(ntrees=4, calibrate_model=True, **KW)
    jm = JGBM(calibration_frame="calib.hex", **kw).train(
        x=X, y="yb", training_frame=JFrame.from_arrays(cols))
    pf = Frame.from_arrays(cols)
    by_key = GBM(calibration_frame="calib.hex", **kw).train(
        x=X, y="yb", training_frame=pf)
    by_frame = GBM(calibration_frame=pcf, **kw).train(x=X, y="yb",
                                                      training_frame=pf)
    assert by_key.output["calibration"] == by_frame.output["calibration"]
    for k in ("a", "b"):
        np.testing.assert_allclose(by_key.output["calibration"][k],
                                   jm.output["calibration"][k], rtol=1e-4)


def test_plug_values_by_key_match_the_reference():
    from test_torch_glm import assert_same_fit
    cols = cols_of()
    plug = {"x0": np.float32([0.1]), "x1": np.float32([0.7]),
            "x2": np.float32([-0.2])}
    JDKV.put("plugs.hex", JFrame.from_arrays(plug))
    DKV.put("plugs.hex", Frame.from_arrays(plug))
    kw = dict(family="gaussian", missing_values_handling="PlugValues")
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = JGLM(plug_values="plugs.hex", **kw).train(x=X, y="yg",
                                                    training_frame=jf)
    pm = GLM(plug_values="plugs.hex", **kw).train(x=X, y="yg",
                                                   training_frame=pf)
    assert_same_fit(jm, pm, jf, pf)
    by_dict = GLM(plug_values={c: float(v[0]) for c, v in plug.items()},
                  **kw).train(x=X, y="yg", training_frame=pf)
    assert torch.equal(pm.output["beta"], by_dict.output["beta"])
    # a key of a frame of more than one row is refused by both
    two = {c: np.repeat(v, 2) for c, v in plug.items()}
    JDKV.put("two.hex", JFrame.from_arrays(two))
    DKV.put("two.hex", Frame.from_arrays(two))
    for cls, fr in ((JGLM, jf), (GLM, pf)):
        with pytest.raises(ValueError, match="exactly 1 row"):
            cls(plug_values="two.hex", **kw).train(x=X, y="yg",
                                                   training_frame=fr)
