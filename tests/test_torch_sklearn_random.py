"""The scikit-learn adapters of the port whose builders draw from random
streams the port does not share (DRF's bootstrap, DeepLearning's initial
weights and shuffles, KMeans' first centre), against the JAX package's
(the cases of tests/test_torch_sklearn.py held by their score, within
0.05 of the reference's, and KMeans' partition): a file of its own so
that pytest-xdist's ``--dist loadfile`` spreads the adapter cases over
its workers."""

import numpy as np
import pytest

from h2o3_tpu import sklearn_adapter as jsk
from h2o3_tpu_torch import sklearn_adapter as psk
from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_sklearn import N, RANDOM, _cpu_port, _fit, data  # noqa: F401


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_randomised_wrappers_score_as_the_reference(data, name):
    X, yc, yr = data
    y = yc if "Classifier" in name else yr
    pe = _fit(psk, name, RANDOM[name], X, y)
    je = _fit(jsk, name, RANDOM[name], X, y)
    assert abs(pe.score(X, y) - je.score(X, y)) < 0.05
    assert pe.predict(X).shape == (N,)
    if "Classifier" in name:
        proba = pe.predict_proba(X)
        assert proba.shape == (N, 2)
        np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)


def test_kmeans_estimator_clusters_as_the_reference(data):
    X, _, _ = data
    Xs = np.concatenate([X[:, :2], X[:, :2] + 8.0])
    kw = dict(k=2, seed=3, init="Furthest")
    pe = psk.H2OKMeansEstimator(**kw).fit(Xs)
    je = jsk.H2OKMeansEstimator(**kw).fit(Xs)
    pp, jp = pe.predict(Xs), np.asarray(je.predict(Xs))[: len(Xs)]
    assert not hasattr(pe, "classes_")
    # the same partition into two clusters, whatever their labels
    same = (pp == pp[0]) == (jp == jp[0])
    assert same.all()
