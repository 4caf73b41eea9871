"""StackedEnsemble in the port (``h2o3_tpu_torch/orchestration/
stacked_ensemble.py``) against the JAX package's, for binomial,
multinomial and regression responses. The base models are the JAX
package's (a GBM and a GLM, 3-fold CV with kept out-of-fold predictions),
carried into the port with ``convert`` (tests/test_torch_carry.py), so
both packages stack the same level-one columns: the port's metalearner
(AUTO: a non-negative GLM at lambda 0) is held to the reference's, and
the ensemble's predictions too. ``convert.stacked_ensemble_model`` carries
the reference's whole ensemble, which then scores as it does there. The
refusals match: base models without CV, and a base model trained on
another response.

Row counts are multiples of 64 (no pad rows). Tolerances: metalearner
coefficients at rtol 1e-4 with an atol of 1e-5 x their largest
(tests/test_torch_glm.py's); ensemble probabilities and predictions at
atol 1e-5 (the base models' scores are float32 ulps apart, as
tests/test_torch_gbm.py holds them); the carried ensemble's at atol 1e-5;
a GBM metalearner's probabilities at atol 1e-4 (trees on level-one
columns float32 ulps apart).
"""

import copy
import functools

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.orchestration.stacked_ensemble import \
    StackedEnsemble as JStackedEnsemble
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.orchestration.stacked_ensemble import (
    StackedEnsemble, StackedEnsembleModel)
from h2o3_tpu_torch.utils.registry import DKV
from test_torch_carry import carry

N = 512
X = ["x0", "x1", "x2"]
FAMILY = {"yb": "binomial", "ym": "multinomial", "yg": "gaussian"}


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _clear_port_dkv():
    """The module starts and ends with an empty port DKV (other files'
    models may share this process; the module's fixtures train models
    that its tests share)."""
    DKV.clear()
    yield
    DKV.clear()


def se_cols(n=N, seed=6):
    rng = np.random.default_rng(seed)
    Xn = rng.normal(size=(n, 3)).astype(np.float32)
    z = 1.1 * Xn[:, 0] - 0.7 * Xn[:, 1] + 0.8 * Xn[:, 1] * Xn[:, 2]
    yb = np.where(rng.random(n) < 1 / (1 + np.exp(-z)), "yes", "no")
    ym = np.array(["c0", "c1", "c2"])[np.digitize(
        z + 0.5 * rng.normal(size=n), [-0.6, 0.6])]
    yg = (z + 0.3 * rng.normal(size=n)).astype(np.float32)
    return {**{f"x{i}": Xn[:, i] for i in range(3)}, "yb": yb, "ym": ym,
            "yg": yg}


@functools.lru_cache(maxsize=None)
def _stacked(y):
    cols = se_cols()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    cv = dict(nfolds=3, keep_cross_validation_predictions=True, seed=3)
    jbase = [JGBM(ntrees=4, max_depth=3, nbins=16, **cv).train(
                 x=X, y=y, training_frame=jf),
             JGLM(family=FAMILY[y], lambda_=0.0, **cv).train(
                 x=X, y=y, training_frame=jf)]
    jse = JStackedEnsemble(base_models=jbase).train(y=y, training_frame=jf)
    pbase = [carry(jm, N) for jm in jbase]
    pse = StackedEnsemble(base_models=pbase).train(y=y, training_frame=pf)
    return y, cols, jf, pf, jbase, pbase, jse, pse


@pytest.fixture(scope="module", params=["yb", "ym", "yg"])
def stacked(request):
    yield _stacked(request.param)
    _stacked.cache_clear()


def _coef(m):
    c = m.coef()
    if isinstance(next(iter(c.values())), dict):    # multinomial: per class
        return {f"{k}/{n}": v for k, cc in c.items() for n, v in cc.items()}
    return c


def test_metalearner_matches_the_reference(stacked):
    y, _, _, _, _, _, jse, pse = stacked
    jml, pml = jse.output["metalearner"], pse.output["metalearner"]
    assert pse.output["levelone_names"] == jse.output["levelone_names"]
    assert pml.params["non_negative"] and pml.params["lambda_"] == 0.0
    jc, pc = _coef(jml), _coef(pml)
    assert list(pc) == list(jc)
    want = np.float64(list(jc.values()))
    np.testing.assert_allclose(np.float64(list(pc.values())), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())
    if y != "ym":
        assert all(v >= 0 for k, v in pc.items() if k != "Intercept")


def test_ensemble_predictions_match_the_reference(stacked):
    y, _, jf, pf, _, _, jse, pse = stacked
    np.testing.assert_allclose(pse._score_raw(pf).numpy(),
                               np.asarray(jse._score_raw(jf))[:N],
                               atol=1e-5)
    jp, pp = jse.predict(jf), pse.predict(pf)
    assert pp.names == jp.names
    if y != "yg":
        np.testing.assert_array_equal(
            pp.vec("predict").labels(),
            jp.vec("predict").labels()[:N])
    for which in ("training_metrics",):
        jm, pm = getattr(jse, which), getattr(pse, which)
        np.testing.assert_allclose(pm.mse, jm.mse, rtol=1e-4)


def test_a_carried_ensemble_scores_as_the_reference(stacked):
    y, _, jf, pf, jbase, pbase, jse, _ = stacked
    jml = jse.output["metalearner"]
    meta = carry(jml, N)
    se = convert.stacked_ensemble_model(
        dict(levelone_names=jse.output["levelone_names"]), pbase, meta,
        response_column=y, response_domain=jse.response_domain)
    assert isinstance(se, StackedEnsembleModel)
    np.testing.assert_allclose(se._score_raw(pf).numpy(),
                               np.asarray(jse._score_raw(jf))[:N],
                               atol=1e-5)


def test_carried_out_of_fold_predictions_are_cut_to_the_rows(stacked):
    _, _, _, _, jbase, pbase, _, _ = stacked
    for jm, pm in zip(jbase, pbase):
        assert pm.cv_holdout_predictions.shape[0] == N
        np.testing.assert_array_equal(pm.cv_holdout_predictions.numpy(),
                                      np.asarray(jm.cv_holdout_predictions)
                                      [:N])
        np.testing.assert_array_equal(pm.cv_holdout_mask.numpy(),
                                      np.asarray(jm.cv_holdout_mask)[:N])


def test_a_gbm_metalearner_matches_the_reference():
    y, _, jf, pf, jbase, pbase, _, _ = _stacked("yb")
    kw = dict(metalearner_algorithm="GBM",
              metalearner_params=dict(ntrees=3, max_depth=2, nbins=16))
    jse = JStackedEnsemble(base_models=jbase, **kw).train(
        y=y, training_frame=jf)
    pse = StackedEnsemble(base_models=pbase, **kw).train(y=y,
                                                         training_frame=pf)
    assert pse.output["metalearner"].algo == "gbm"
    np.testing.assert_allclose(pse._score_raw(pf).numpy(),
                               np.asarray(jse._score_raw(jf))[:N],
                               atol=1e-4)


def test_refusals_match_the_reference():
    """A base model without kept out-of-fold predictions, no base models,
    and base models trained on another response (the 3-class ones, for
    the binary response)."""
    _, _, jf, pf, jbase, pbase, _, _ = _stacked("ym")
    for cls, base, fr in ((JStackedEnsemble, jbase, jf),
                          (StackedEnsemble, pbase, pf)):
        no_cv = copy.copy(base[0])
        no_cv.cv_holdout_predictions = None
        with pytest.raises(ValueError,
                           match="keep_cross_validation_predictions"):
            cls(base_models=[no_cv]).train(y="yb", training_frame=fr)
        with pytest.raises(ValueError, match="base_models is required"):
            cls().train(y="yb", training_frame=fr)
        with pytest.raises(ValueError, match="trained on response 'ym'"):
            cls(base_models=base).train(y="yb", training_frame=fr)


def test_base_models_score_through_their_preprocessors():
    """An ensemble over a base model that carries a target encoder (as
    AutoML's tree steps do) scores the raw frame: each base model scores
    through its ``preprocessors``, where the JAX package's ensemble hands
    it the frame as given (ROADMAP queue C)."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.glm import GLM
    from h2o3_tpu_torch.models.target_encoder import TargetEncoder
    rng = np.random.default_rng(9)
    n = 384
    city = rng.choice([f"c{i:02d}" for i in range(15)], n)
    x1 = rng.normal(size=n).astype(np.float32)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-(x1 + (city < "c07")))),
                 "yes", "no")
    fr = Frame.from_arrays({"city": city, "x1": x1, "y": y})
    te = TargetEncoder(data_leakage_handling="KFold", seed=1).train(
        x=["city"], y="y", training_frame=fr)
    cv = dict(nfolds=2, keep_cross_validation_predictions=True)
    tree = GBM(ntrees=3, max_depth=3, **cv).train(
        x=["x1", "city_te"], y="y", training_frame=te.transform(fr))
    tree.preprocessors.append(te)
    lin = GLM(family="binomial", **cv).train(x=["x1"], y="y",
                                             training_frame=fr)
    se = StackedEnsemble(base_models=[tree, lin]).train(y="y",
                                                        training_frame=fr)
    raw = se.predict(fr).vec("pyes").data
    assert raw.shape == (n,) and bool(torch.isfinite(raw).all())
    assert se.training_metrics.auc > 0.6
