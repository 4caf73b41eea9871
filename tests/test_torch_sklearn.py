"""The scikit-learn adapters of the port (``h2o3_tpu_torch/sklearn_adapter.py``)
against the JAX package's (``h2o3_tpu/sklearn_adapter.py``): every wrapper
under the JAX package's name, the protocol (``get_params`` /
``set_params``, ``fit``, ``predict``, ``predict_proba``, ``score``) and
its outputs on the same numpy inputs (640 rows, a multiple of 64: no
reference pad rows); the randomised builders' cases are in
tests/test_torch_sklearn_random.py.

Tolerances: the deterministic builders (GBM, XGBoost, GLM) give
probabilities at atol 1e-5 (tree leaves differ in the last bits, as in
tests/test_torch_gbm.py; GLM's at tests/test_torch_glm.py's rtol 1e-5),
labels alike on at least 99% of rows and scores within 1e-2; the builders
that draw from random streams the port does not share (DRF's bootstrap,
DeepLearning's initial weights and shuffles, KMeans' first centre) are
held by their score, within 0.05 of the reference's; DeepLearning at 20
epochs, where both packages' fits have converged (at 5 epochs the
regressor's R² still follows the initial weights: 0.33 in the port,
-0.11 in the reference).
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import sklearn_adapter as jsk
from h2o3_tpu_torch import set_device, sklearn_adapter as psk
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from jax_reference import _jax_compile_cache  # noqa: F401

N = 640
WRAPPERS = sorted(n for n in dir(jsk) if n.startswith("H2O"))


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, 4))
    yc = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=N) > 0).astype(int)
    yr = 2 * X[:, 0] - X[:, 2] + rng.normal(scale=0.1, size=N)
    return X, yc, yr


def test_every_wrapper_of_the_reference_is_ported():
    assert len(WRAPPERS) == 11
    assert sorted(n for n in dir(psk) if n.startswith("H2O")) == WRAPPERS
    for n in WRAPPERS:
        assert hasattr(getattr(psk, n), "predict_proba") == \
            hasattr(getattr(jsk, n), "predict_proba")


DETERMINISTIC = {
    "H2OGradientBoostingClassifier": dict(ntrees=10, max_depth=3, seed=1),
    "H2OGradientBoostingRegressor": dict(ntrees=10, max_depth=3, seed=1),
    "H2OXGBoostClassifier": dict(ntrees=5, max_depth=3, seed=1),
    "H2OXGBoostRegressor": dict(ntrees=5, max_depth=3, seed=1),
    "H2OGeneralizedLinearClassifier": dict(family="binomial", lambda_=0.0),
    "H2OGeneralizedLinearRegressor": dict(lambda_=0.0),
}
RANDOM = {
    "H2ORandomForestClassifier": dict(ntrees=10, max_depth=5, seed=1),
    "H2ORandomForestRegressor": dict(ntrees=10, max_depth=5, seed=1),
    "H2ODeepLearningClassifier": dict(hidden=[16], epochs=20, seed=1),
    "H2ODeepLearningRegressor": dict(hidden=[16], epochs=20, seed=1),
}


def _fit(mod, name, params, X, y):
    return getattr(mod, name)(**params).fit(X, y)


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_wrappers_equal_the_reference(data, name):
    X, yc, yr = data
    y = yc if "Classifier" in name else yr
    pe = _fit(psk, name, DETERMINISTIC[name], X, y)
    je = _fit(jsk, name, DETERMINISTIC[name], X, y)
    assert abs(pe.score(X, y) - je.score(X, y)) < 1e-2
    pp, jp = pe.predict(X), np.asarray(je.predict(X))[:N]
    if "Classifier" in name:
        assert list(pe.classes_) == list(je.classes_) == ["0", "1"]
        assert (pp == jp).mean() >= 0.99
        glm = "Linear" in name
        np.testing.assert_allclose(
            pe.predict_proba(X), np.asarray(je.predict_proba(X))[:N],
            rtol=1e-5 if glm else 0.0, atol=1e-6 if glm else 1e-5)
    else:
        np.testing.assert_allclose(pp, jp, rtol=1e-5,
                                   atol=1e-5 * np.abs(jp).max())


def test_params_protocol(data):
    X, yc, _ = data
    clf = psk.H2OGradientBoostingClassifier(ntrees=10, max_depth=3, seed=1)
    assert clf.get_params() == dict(ntrees=10, max_depth=3, seed=1)
    assert clf.set_params(max_depth=2) is clf
    assert clf.get_params()["max_depth"] == 2
    with pytest.raises(RuntimeError, match="fit"):
        clf.predict(X)
    assert clf.fit(X, yc) is clf
    assert clf.model_.params["max_depth"] == 2
    assert set(clf.predict(X)) <= {"0", "1"}
    with pytest.raises(ValueError, match="2-D"):
        clf.predict(X[:, 0])


def test_predict_proba_is_the_builders_predict(data):
    """The wrapper's probabilities are those of the port's GBM trained on
    the same frame, bit for bit."""
    X, yc, _ = data
    clf = psk.H2OGradientBoostingClassifier(ntrees=10, max_depth=3, seed=1)
    proba = clf.fit(X, yc).predict_proba(X)
    fr, names, ycol = psk._to_frame(X, yc, classification=True)
    m = GBM(ntrees=10, max_depth=3, seed=1).train(x=names, y=ycol,
                                                  training_frame=fr)
    pred = m.predict(psk._to_frame(X)[0])
    np.testing.assert_array_equal(
        proba, np.stack([pred.vec("p0").to_numpy(),
                         pred.vec("p1").to_numpy()], 1))
    assert isinstance(fr, Frame) and fr.vec("target").is_categorical
