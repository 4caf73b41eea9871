"""The port's sparse frames and matrix-free GLM (h2o3_tpu_torch/frame/
sparse.py, h2o3_tpu_torch/models/glm_sparse.py) against the JAX
reference: the COO products, the SVMLight reader, IRLS with conjugate
gradients in the three families of the sparse path, and the same data on
the dense path.

The products are float32 sums in another order than the reference's
``segment_sum``s: rtol 1e-6 (atol 1e-6). Sparse fits: iterations equal,
coefficients rtol 1e-4 with an atol of 1e-5 × max|beta|, deviance rtol
1e-5. Sparse against dense: 50 CG iterations against a Cholesky solve
with the dense path's 1e-5 × trace jitter, coefficients within 1e-3 of
max|beta|.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame import sparse as jsp
from h2o3_tpu.frame import vec as jvec
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame import sparse as psp
from h2o3_tpu_torch.frame import vec as pvec
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import GLM
from jax_reference import _jax_compile_cache  # noqa: F401

R, C = 3000, 40


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
def coo():
    rng = np.random.default_rng(3)
    mask = rng.random((R, C)) < 0.1
    rows, cols = np.nonzero(mask)
    vals = rng.normal(size=len(rows)).astype(np.float32)
    dense = np.zeros((R, C), np.float32)
    dense[rows, cols] = vals
    eta = dense @ rng.normal(scale=0.7, size=C).astype(np.float32)
    ys = {"binomial": (eta + rng.logistic(size=R) > 0).astype(np.float32),
          "gaussian": (eta + rng.normal(size=R)).astype(np.float32),
          "poisson": rng.poisson(np.exp(0.3 * eta)).astype(np.float32)}
    return rows, cols, vals, dense, ys


def frames(coo, y):
    rows, cols, vals, _, _ = coo
    jsf = jsp.SparseFrame(jsp.SparseMatrix.from_scipy_like(
        rows, cols, vals, R, C), {"C0": jvec.Vec.from_numpy(y)})
    psf = psp.SparseFrame(psp.SparseMatrix.from_scipy_like(
        rows, cols, vals, R, C), {"C0": pvec.Vec.from_numpy(y)})
    return jsf, psf


def test_products(coo):
    rows, cols, vals, dense, ys = coo
    jm = jsp.SparseMatrix.from_scipy_like(rows, cols, vals, R, C)
    pm = psp.SparseMatrix.from_scipy_like(rows, cols, vals, R, C)
    rng = np.random.default_rng(1)
    v = rng.normal(size=C).astype(np.float32)
    u = rng.normal(size=R).astype(np.float32)
    w = rng.uniform(size=R).astype(np.float32)
    for got, want in [
            (pm.matvec(torch.from_numpy(v)), jm.matvec(v)),
            (pm.rmatvec(torch.from_numpy(u)), jm.rmatvec(u)),
            (pm.col_sq_weighted(torch.from_numpy(w)), jm.col_sq_weighted(w))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(pm.to_dense().numpy(), dense)
    assert pm.nnz == jm.nnz


def test_svmlight_reader(tmp_path):
    path = tmp_path / "d.svm"
    path.write_text("1 qid:3 1:0.5 4:-2 # note\n"
                    "-1 2:1.25\n\n"
                    "# a comment line\n"
                    "1 1:3 3:1e-3 7:0.5\n")
    j = jsp.parse_svmlight_sparse(str(path))
    p = psp.parse_svmlight_sparse(str(path))
    assert (p.nrows, p.ncols, p.X.nnz) == (j.nrows, j.ncols, j.X.nnz)
    np.testing.assert_array_equal(p.X.to_dense().numpy(),
                                  np.asarray(j.X.to_dense()))
    np.testing.assert_array_equal(p.vec("C0").to_numpy(),
                                  j.vec("C0").to_numpy())


@pytest.mark.parametrize("family", ["binomial", "gaussian", "poisson"])
def test_sparse_glm_matches_reference(coo, family):
    jsf, psf = frames(coo, coo[4][family])
    jm = JGLM(family=family, lambda_=1e-3).train(y="C0", training_frame=jsf)
    pm = GLM(family=family, lambda_=1e-3).train(y="C0", training_frame=psf)
    assert pm.output["iterations"] == jm.output["iterations"]
    jb = np.asarray(jm.output["beta"])
    np.testing.assert_allclose(pm.output["beta"].numpy(), jb, rtol=1e-4,
                               atol=1e-5 * np.abs(jb).max())
    np.testing.assert_allclose(pm.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=1e-5)
    np.testing.assert_allclose(pm._score_raw(psf).numpy(),
                               np.asarray(jm._score_raw(jsf)), rtol=1e-5,
                               atol=1e-6)
    assert pm.output["coef_names"] == jm.output["coef_names"]
    a, b = pm.training_metrics, jm.training_metrics
    np.testing.assert_allclose(a.mse, b.mse, rtol=1e-5)
    with pytest.raises(ValueError, match="SparseFrame"):
        pm._score_raw(Frame.from_arrays({"C0": coo[4][family]}))


@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_sparse_agrees_with_dense(coo, family):
    rows, cols, vals, dense, ys = coo
    _, psf = frames(coo, ys[family])
    sm = GLM(family=family, lambda_=1e-3).train(y="C0", training_frame=psf)
    dcols = {f"C{j + 1}": dense[:, j] for j in range(C)}
    dcols["C0"] = (np.where(ys[family] > 0, "1", "0")
                   if family == "binomial" else ys[family])
    dm = GLM(family=family, lambda_=1e-3, standardize=False).train(
        x=[f"C{j + 1}" for j in range(C)], y="C0",
        training_frame=Frame.from_arrays(dcols))
    sb, db = sm.output["beta"].numpy(), dm.output["beta"].numpy()
    np.testing.assert_allclose(sb, db, atol=1e-3 * np.abs(db).max())


def test_sparse_refusals(coo):
    _, psf = frames(coo, coo[4]["gaussian"])
    with pytest.raises(ValueError, match="L2-only"):
        GLM(alpha=0.5, lambda_=1e-3).train(y="C0", training_frame=psf)
    with pytest.raises(ValueError, match="gaussian/binomial/poisson"):
        GLM(family="gamma").train(y="C0", training_frame=psf)
    with pytest.raises(ValueError, match="column selection"):
        GLM().train(x=["C1"], y="C0", training_frame=psf)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        GLM(checkpoint="m").train(y="C0", training_frame=psf)
