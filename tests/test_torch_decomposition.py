"""PCA and SVD in the port (h2o3_tpu_torch/models/decomposition.py) against
the JAX reference (``h2o3_tpu/models/decomposition.py``) on the same
numpy-seeded frame.

Both build the weighted Gram in float32 (sums in another order) and
eigendecompose it on the host in float64 with the same sign rule (each
eigenvector's largest-|·| component positive), so eigenvectors and
projections are held at rtol 1e-5 (an absolute floor of 1e-6 x the
largest entry for components near zero) and eigenvalues, standard
deviations and variance shares at rtol 1e-5 (the column means with an
absolute floor of 1e-6: a centred column's is ~1e-7 of cancelled float32
sums). The frame's columns have
well-separated variances, so the eigenvectors are well conditioned.
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import decomposition as jdec
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import decomposition as pdec
from jax_reference import _jax_compile_cache  # noqa: F401

RTOL = 1e-5
N = 512   # a multiple of 8 devices x 8 rows: the reference pads no row


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def dec_cols(n=N, seed=0):
    """Five correlated numeric columns of distinct scales and small offsets
    (a float32 Gram of far-off-center columns cancels in the covariance), a
    few missing values, and a categorical column."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, 5)) * np.array([5.0, 3.0, 2.0, 1.0, 0.5])
    R = np.linalg.qr(rng.normal(size=(5, 5)))[0]
    X = (Z @ R.T + np.array([1.0, -0.5, 0.5, 2.0, 0.0])).astype(np.float32)
    X[rng.random((n, 5)) < 0.01] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["c"] = np.array(["a", "b", "c", "d"], dtype=object)[
        rng.choice(4, n, p=[0.4, 0.3, 0.2, 0.1])]
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = dec_cols()
    return JFrame.from_arrays(cols), Frame.from_arrays(cols)


def _close(got, want, atol=None):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol if atol
                               is not None else 1e-6 * np.abs(want).max())


def _same_projection(jm, pm, jf, pf):
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == jp.names
    for c in pp.names:
        _close(pp.vec(c).to_numpy(), jp.vec(c).to_numpy()[:N])


@pytest.mark.parametrize("transform", ["NONE", "DEMEAN", "DESCALE",
                                       "STANDARDIZE", "NORMALIZE"])
@pytest.mark.parametrize("use_all", [False, True])
def test_pca_matches_reference(frames, transform, use_all):
    jf, pf = frames
    params = dict(k=4, transform=transform, use_all_factor_levels=use_all)
    jm = jdec.PCA(**params).train(training_frame=jf)
    pm = pdec.PCA(**params).train(training_frame=pf)
    _close(pm.rotation(), jm.rotation())
    for k in ("eigenvalues", "std_deviation", "prop_var", "cum_var"):
        _close(pm.output[k], jm.output[k])
    # a centred column's mean is a float32 sum that cancels to ~1e-7
    _close(pm.output["mu"], jm.output["mu"], atol=1e-6)
    np.testing.assert_allclose(pm.output["total_variance"],
                               jm.output["total_variance"], rtol=RTOL)
    # the sign rule: each eigenvector's largest-|.| component is positive
    V = pm.rotation()
    assert (V[np.abs(V).argmax(0), np.arange(4)] > 0).all()
    _same_projection(jm, pm, jf, pf)


@pytest.mark.parametrize("transform,use_all", [("NONE", True),
                                               ("STANDARDIZE", False)])
def test_svd_matches_reference(frames, transform, use_all):
    jf, pf = frames
    params = dict(nv=3, transform=transform, use_all_factor_levels=use_all)
    jm = jdec.SVD(**params).train(training_frame=jf)
    pm = pdec.SVD(**params).train(training_frame=pf)
    _close(pm.output["v"].numpy(), jm.output["v"])
    _close(pm.output["d"], jm.output["d"])
    _same_projection(jm, pm, jf, pf)


def test_weights_enter_the_gram(frames):
    cols = dec_cols()
    cols["w"] = np.random.default_rng(2).uniform(0, 3, N).astype(np.float32)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = jdec.PCA(k=2, weights_column="w").train(training_frame=jf)
    pm = pdec.PCA(k=2, weights_column="w").train(training_frame=pf)
    _close(pm.rotation(), jm.rotation())
    _close(pm.output["eigenvalues"], jm.output["eigenvalues"])


def test_reference_models_project_alike_through_convert(frames):
    jf, pf = frames
    jm = jdec.PCA(k=3, transform="STANDARDIZE").train(training_frame=jf)
    pm = convert.pca_model(
        {k: np.asarray(v) if k == "eigenvectors" else v
         for k, v in jm.output.items()},
        dataclasses.asdict(jm.data_info), dict(jm.params), device="cpu")
    _same_projection(jm, pm, jf, pf)
    jm = jdec.SVD(nv=2).train(training_frame=jf)
    pm = convert.svd_model(
        {k: np.asarray(v) if k == "v" else v for k, v in jm.output.items()},
        dataclasses.asdict(jm.data_info), dict(jm.params), device="cpu")
    _same_projection(jm, pm, jf, pf)


@pytest.mark.parametrize("builder,params,err", [
    (pdec.PCA, dict(k=1, pca_method="Power"), NotImplementedError),
    (pdec.PCA, dict(k=0), ValueError),
    (pdec.PCA, dict(k=20), ValueError),
    (pdec.PCA, dict(k=1, transform="LOG"), ValueError),
    (pdec.SVD, dict(nv=1, svd_method="Randomized"), NotImplementedError),
    (pdec.SVD, dict(nv=40), ValueError),
])
def test_refusals(frames, builder, params, err):
    with pytest.raises(err):
        builder(**params).train(training_frame=frames[1])
