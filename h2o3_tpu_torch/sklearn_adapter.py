"""scikit-learn adapters — the port of ``h2o3_tpu/sklearn_adapter.py``.

``H2O*Classifier`` / ``H2O*Regressor`` wrappers around the port's builders
implement the scikit-learn estimator protocol (reference:
``h2o-py/h2o/sklearn/``): ``fit(X, y) → self``, ``predict``,
``predict_proba``, ``get_params`` / ``set_params`` and ``score``. The
protocol is duck-typed, with no dependency on scikit-learn. Each wrapper
resolves its builder at its first ``fit``; frames go to the port's default
device (the card, or the one :func:`h2o3_tpu_torch.set_device` set).
"""

from __future__ import annotations

import importlib

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame


def _to_frame(X, y=None, classification=False):
    """(frame, feature names, response name or None) of numpy inputs:
    columns x0.. as float32, the response as strings for a classifier."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError("X must be 2-D")
    cols = {f"x{i}": X[:, i].astype(np.float32) for i in range(X.shape[1])}
    names = list(cols)
    ycol = None
    if y is not None:
        y = np.asarray(y)
        ycol = "target"
        cols[ycol] = (np.array([str(v) for v in y], dtype=object)
                      if classification else y.astype(np.float32))
    return Frame.from_arrays(cols), names, ycol


class _H2OSklearnBase:
    """The scikit-learn estimator protocol over a ModelBuilder."""

    _builder_path: str = ""
    _classification = False

    def __init__(self, **params):
        self._params = dict(params)
        self.model_ = None

    def get_params(self, deep=True):
        return dict(self._params)

    def set_params(self, **params):
        self._params.update(params)
        return self

    @classmethod
    def _builder_cls(cls):
        mod_name, cls_name = cls._builder_path.rsplit(".", 1)
        return getattr(importlib.import_module(mod_name), cls_name)

    def fit(self, X, y=None):
        fr, names, ycol = _to_frame(X, y, self._classification)
        builder = self._builder_cls()(**self._params)
        if builder.unsupervised or ycol is None:
            self.model_ = builder.train(x=names, training_frame=fr)
        else:
            self.model_ = builder.train(x=names, y=ycol, training_frame=fr)
        if self._classification and self.model_.response_domain:
            self.classes_ = np.array(list(self.model_.response_domain))
        return self

    def _check_fitted(self):
        if self.model_ is None:
            raise RuntimeError("call fit() first")

    def predict(self, X):
        self._check_fitted()
        v = self.model_.predict(_to_frame(X)[0]).vec("predict")
        return np.asarray(v.labels() if v.is_categorical else v.to_numpy())

    def score(self, X, y):
        """Accuracy for a classifier, R² for a regressor."""
        if self._classification:
            return float((self.predict(X)
                          == np.array([str(v) for v in y])).mean())
        pred = self.predict(X).astype(np.float64)
        y = np.asarray(y, np.float64)
        ss_res = np.sum((y - pred) ** 2)
        ss_tot = np.sum((y - y.mean()) ** 2)
        return float(1.0 - ss_res / max(ss_tot, 1e-30))


class _H2OSklearnClassifier(_H2OSklearnBase):
    _classification = True

    def predict_proba(self, X):
        """[rows, classes] probabilities, columns in ``classes_`` order."""
        self._check_fitted()
        pred = self.model_.predict(_to_frame(X)[0])
        return np.stack([pred.vec(f"p{d}").to_numpy()
                         for d in self.model_.response_domain], axis=1)


def _make(name: str, builder_path: str, classifier: bool) -> type:
    base = _H2OSklearnClassifier if classifier else _H2OSklearnBase
    return type(name, (base,), {"_builder_path": builder_path,
                                "__qualname__": name,
                                "__module__": __name__})


_M = "h2o3_tpu_torch.models."
H2OGradientBoostingClassifier = _make(
    "H2OGradientBoostingClassifier", _M + "gbm.GBM", True)
H2OGradientBoostingRegressor = _make(
    "H2OGradientBoostingRegressor", _M + "gbm.GBM", False)
H2ORandomForestClassifier = _make(
    "H2ORandomForestClassifier", _M + "gbm.DRF", True)
H2ORandomForestRegressor = _make(
    "H2ORandomForestRegressor", _M + "gbm.DRF", False)
H2OGeneralizedLinearClassifier = _make(
    "H2OGeneralizedLinearClassifier", _M + "glm.GLM", True)
H2OGeneralizedLinearRegressor = _make(
    "H2OGeneralizedLinearRegressor", _M + "glm.GLM", False)
H2ODeepLearningClassifier = _make(
    "H2ODeepLearningClassifier", _M + "deeplearning.DeepLearning", True)
H2ODeepLearningRegressor = _make(
    "H2ODeepLearningRegressor", _M + "deeplearning.DeepLearning", False)
H2OXGBoostClassifier = _make(
    "H2OXGBoostClassifier", _M + "xgboost.XGBoost", True)
H2OXGBoostRegressor = _make(
    "H2OXGBoostRegressor", _M + "xgboost.XGBoost", False)
H2OKMeansEstimator = _make(
    "H2OKMeansEstimator", _M + "kmeans.KMeans", False)
