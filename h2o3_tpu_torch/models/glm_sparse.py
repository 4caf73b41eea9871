"""Sparse GLM — matrix-free IRLS over a COO design — the port of
``h2o3_tpu/models/glm_sparse.py`` (reference: wide-sparse GLM over CXI
sparse chunks, ``hex/glm/GLMTask.java``'s sparse row iterators).

Each IRLS step solves the normal equations

    (X'WX + λ·n·I) β = X'Wz

by Jacobi-preconditioned conjugate gradients, where every operator
application is two sparse products (:mod:`h2o3_tpu_torch.frame.sparse`);
the dense design is never formed, and the intercept rides as a virtual
all-ones column. The CG runs its 50 iterations as a fixed loop that
freezes once the residual meets the tolerance (the reference's
``while_loop`` stops there instead), so it needs no host sync; the IRLS
loop syncs once per iteration for its stop rule.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.sparse import SparseFrame, SparseMatrix
from h2o3_tpu_torch.models.model_base import compute_metrics, make_model_key

#: CG iterations per IRLS step and the residual tolerance relative to the
#: right-hand side (reference: ``jax.scipy.sparse.linalg.cg(maxiter=50,
#: tol=1e-8)``)
CG_ITERS, CG_TOL = 50, 1e-8


def _link_terms(family: str, eta):
    """mu, d mu/d eta and the variance at eta."""
    if family == "binomial":
        mu = torch.sigmoid(eta)
        d = (mu * (1 - mu)).clamp_min(1e-10)
        return mu, d, d          # var == d for the logistic link
    if family == "poisson":
        mu = torch.exp(eta.clamp(-30, 30))
        return mu, mu, mu
    return eta, torch.ones_like(eta), torch.ones_like(eta)   # gaussian


def _cg(A, b, x0, M, maxiter: int, tol: float):
    """Preconditioned conjugate gradients, step for step as
    ``jax.scipy.sparse.linalg.cg``: stops (here: freezes) once
    r·r <= tol²·b·b."""
    atol2 = (tol * tol) * (b @ b)
    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    gamma = r @ z
    for _ in range(maxiter):
        active = (r @ r) > atol2
        Ap = A(p)
        alpha = gamma / (p @ Ap)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = M(r_n)
        gamma_n = r_n @ z_n
        p_n = z_n + (gamma_n / gamma) * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        gamma = torch.where(active, gamma_n, gamma)
    return x


def _sparse_irls_step(family: str, X: SparseMatrix, y, w, beta, lam):
    """One IRLS iteration with a CG inner solve; beta[-1] is the
    intercept. Returns (new beta, deviance at beta)."""
    eta = X.matvec(beta[:-1]) + beta[-1]
    mu, d, var = _link_terms(family, eta)
    W = w * d * d / var.clamp_min(1e-12)
    z = eta + (y - mu) / d.clamp_min(1e-12)
    nobs = w.sum().clamp_min(1.0)
    l2 = lam * nobs

    def A(v):
        xv = X.matvec(v[:-1]) + v[-1]
        wxv = W * xv
        return torch.cat([X.rmatvec(wxv) + l2 * v[:-1], wxv.sum()[None]])

    b = torch.cat([X.rmatvec(W * z), (W * z).sum()[None]])
    diag = torch.cat([X.col_sq_weighted(W) + l2,
                      W.sum().clamp_min(1e-12)[None]])
    beta_new = _cg(A, b, beta, lambda v: v / diag.clamp_min(1e-12),
                   CG_ITERS, CG_TOL)
    if family == "binomial":
        p = mu.clamp(1e-7, 1 - 1e-7)
        dev = -2.0 * (w * (y * torch.log(p)
                           + (1 - y) * torch.log1p(-p))).sum()
    elif family == "poisson":
        dev = 2.0 * (w * (mu - y + torch.where(y > 0, y * (torch.log(
            y.clamp_min(1e-30)) - eta.clamp(-30, 30)), 0.0))).sum()
    else:
        dev = (w * (y - mu) ** 2).sum()
    return beta_new, dev


def sparse_score(model, sf: SparseFrame) -> torch.Tensor:
    """A sparse GLM's predictions: [rows, 2] for binomial, mu otherwise."""
    beta = model.output["beta"]
    eta = sf.X.matvec(beta[:-1]) + beta[-1]
    fam = model.params["family"]
    if fam == "binomial":
        mu = torch.sigmoid(eta)
        return torch.stack([1.0 - mu, mu], dim=1)
    if fam == "poisson":
        return torch.exp(eta.clamp(-30, 30))
    return eta


def fit_sparse_glm(builder, job, sf: SparseFrame, y: str, weights=None):
    """GLM on a :class:`SparseFrame` (gaussian, binomial, poisson; ridge
    only, as the reference's sparse path); returns a GLMModel."""
    from h2o3_tpu_torch.models.glm import GLMModel, _plateau

    p = builder.params
    family = str(p["family"]).lower()
    if family == "auto":
        family = "gaussian"
    if family not in ("gaussian", "binomial", "poisson"):
        raise ValueError(f"sparse GLM supports gaussian/binomial/poisson, "
                         f"got {family!r} (densify for other families)")
    mi = int(50 if p.get("max_iterations") is None else p["max_iterations"])
    if mi == -1:
        mi = 50
    elif mi < 1:
        raise ValueError("max_iterations must be >= 1 (or -1 for auto)")
    if float(p.get("alpha") or 0.0) > 0:
        raise ValueError("sparse GLM is L2-only (alpha=0); the reference's "
                         "sparse path likewise solves ridge IRLS")

    X = sf.X
    dev_ = X.device
    yv = sf.vec(y).data.double().cpu().numpy()
    if family == "binomial":
        uniq = set(np.unique(yv).tolist())
        if uniq <= {-1.0, 1.0}:          # SVMLight labels
            yv = (yv + 1.0) / 2.0
        elif not uniq <= {0.0, 1.0}:
            raise ValueError("binomial sparse GLM needs 0/1 or ±1 labels")
    yy = torch.as_tensor(yv.astype(np.float32)).to(dev_)
    w = (torch.as_tensor(weights, dtype=torch.float32).to(dev_)
         if weights is not None else torch.ones(X.nrows, device=dev_))

    beta = torch.zeros(X.ncols + 1, dtype=torch.float32, device=dev_)
    lam = float(p.get("lambda_") or 0.0)
    beta_eps = float(p.get("beta_epsilon") or 1e-4)
    dev_prev = torch.full((), float("inf"), device=dev_)
    dev, it_total, done = float("inf"), 0, False
    while it_total < mi and not done:
        beta_new, dev_t = _sparse_irls_step(family, X, yy, w, beta, lam)
        delta = (beta_new - beta).abs().max()
        stop = (delta < beta_eps) | _plateau(dev_prev, dev_t, 1e-6)
        dev, stop_h = torch.stack([dev_t, stop.float()]).tolist()
        done = bool(stop_h) or (family == "gaussian" and it_total >= 1)
        beta, dev_prev = beta_new, dev_t
        it_total += 1
        job.update(it_total / mi,
                   f"sparse IRLS iter {it_total - 1} deviance {dev:.4f}")
    it = max(it_total - 1, 0)

    model = GLMModel(
        key=make_model_key(builder.algo, builder.model_id),
        params=dict(p, family=family), response_column=y,
        response_domain=("0", "1") if family == "binomial" else None,
        output=dict(beta=beta, coef=beta.cpu().double().numpy(),
                    coef_names=[f"C{j}" for j in range(X.ncols)],
                    residual_deviance=float(dev), iterations=it + 1,
                    family=family, lambda_best=lam,
                    regularization_path=None, sparse=True))
    raw = sparse_score(model, sf)
    model.training_metrics = compute_metrics(
        raw, yy, torch.ones(X.nrows, dtype=torch.bool, device=dev_),
        2 if family == "binomial" else 0)
    return model
