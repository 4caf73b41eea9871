"""PSVM — a kernel SVM by incomplete Cholesky and a primal-dual interior
point method — the port of ``h2o3_tpu/models/psvm.py`` (reference:
``hex/psvm/PSVM.java``, ``hex/psvm/psvm/IncompleteCholeskyFactorization.java``
and ``PrimalDualIPM.java``: gamma 1/P and rank sqrt(n) by default, the
Newton system solved through Sherman-Morrison-Woodbury on the rank-p
factor).

The pivoted ICF stays on the device: each of its ``rank`` steps picks the
pivot by ``argmax`` and reads its row by index, with no host sync; the
factor is kept as [rank, rows] (a step writes one contiguous row) and
handed on as [rows, rank]. Every IPM iteration is a few products and the
p x p Cholesky solves of SMW, at full float32, and fetches its three
convergence numbers once. Scoring computes the Gaussian kernel against the
support vectors in row blocks, so no [rows, SVs] matrix beyond one block
exists.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.glm import full_fp32
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key

#: elements of one row block of the scoring kernel matrix (256 MB float32)
SCORE_BLOCK_ELEMS = 1 << 26


@full_fp32()
def _icf(X, y, rank: int, gamma: float, keep=None):
    """Pivoted incomplete Cholesky of Q = diag(y) K diag(y), ``rank``
    columns (reference ``IncompleteCholeskyFactorization.java``): the
    greedy pivot is the largest diagonal residual; the RBF diagonal starts
    at 1. Rows outside ``keep`` never pivot, nor do exhausted ones
    (residual below 1e-8): their rank columns stay 0."""
    n = X.shape[0]
    dev = X.device
    norms = (X * X).sum(1)
    Ht = torch.zeros((rank, n), dtype=torch.float32, device=dev)
    diag = torch.ones(n, dtype=torch.float32, device=dev)
    dead = torch.zeros(n, dtype=torch.bool, device=dev) if keep is None \
        else ~keep
    for j in range(rank):
        cand = torch.where(dead | (diag < 1e-8), -torch.inf, diag)
        q = torch.argmax(cand).reshape(1)
        usable = torch.isfinite(cand.index_select(0, q))
        pivot = torch.sqrt(torch.clamp(diag.index_select(0, q), min=1e-12))
        xq = X.index_select(0, q)[0]
        d2 = torch.clamp(norms + norms.index_select(0, q) - 2.0 * (X @ xq),
                         min=0.0)
        kcol = torch.exp(-gamma * d2) * y * y.index_select(0, q)
        proj = Ht[:j].T @ Ht[:j].index_select(1, q)[:, 0] if j else 0.0
        col = (kcol - proj) / pivot
        col.index_copy_(0, q, pivot)
        col = torch.where(usable, col, 0.0)   # rank exhausted: a zero column
        Ht[j] = col
        diag = torch.clamp(diag - col * col, min=0.0)
        dead.index_fill_(0, q, True)
    return Ht.T.contiguous()


def _smw_partial(H, d, b):
    """The p x p system of SMW: vz = (I + H'DH)^{-1} H'(d*b). Where the
    float32 factorisation fails the result is NaN, as the reference's
    ``jnp.linalg.cholesky`` gives (the IPM loop then keeps its last
    finite iterate); no host sync."""
    p = H.shape[1]
    A = H.T @ (d[:, None] * H) + torch.eye(p, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, torch.nan)
    rhs = (H.T @ (d * b))[:, None]
    z1 = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.T, z1, upper=True)[:, 0]


def _smw_solve(H, d, b):
    """(Sigma + HH')^{-1} b by SMW with D = 1/Sigma = d (elementwise)."""
    vz = _smw_partial(H, d, b)
    return d * b - d * (H @ vz)


@full_fp32()
def _ipm_step(H, y, c_vec, x, xi, la, nu, t_mu_num: float):
    """One primal-dual IPM Newton iteration (PrimalDualIPM.java:66-99);
    also returns the surrogate gap and the two residuals of the incoming
    iterate."""
    eps = 1e-9
    # the surrogate gap (SurrogateGapTask): la'c + x'(xi - la)
    eta = (la * c_vec).sum() + (x * (xi - la)).sum()
    t = t_mu_num / torch.clamp(eta, min=1e-30)

    # z = Qx + nu*y - 1 (computePartialZ, CheckConvergenceTask)
    z = H @ (H.T @ x) + nu * y - 1.0
    resd = torch.sqrt(((la - xi + z) ** 2).sum())
    resp = torch.abs((y * x).sum())

    # UpdateVarsTask
    m_lx = torch.clamp(x, min=eps)
    m_ux = torch.clamp(c_vec - x, min=eps)
    tlx = 1.0 / (t * m_lx)
    tux = 1.0 / (t * m_ux)
    xilx = torch.clamp(xi / m_lx, min=eps)
    laux = torch.clamp(la / m_ux, min=eps)
    d = 1.0 / (xilx + laux)
    zr = tlx - tux - z

    # delta nu (DeltaNuTask): sum1/sum2 over SMW partial solves
    vz = _smw_partial(H, d, zr)
    vl = _smw_partial(H, d, y)
    tw = zr - H @ vz
    tl = y - H @ vl
    dnu = (y * (tw * d + x)).sum() / (y * tl * d).sum()

    # delta x: (Sigma + Q)^{-1} (zr - dnu*y)
    dx = _smw_solve(H, d, zr - dnu * y)

    # dxi, dla (LineSearchTask)
    dxi = tlx - xilx * dx - xi
    dla = tux + laux * dx - la

    # step sizes: the largest feasible, capped at 1, damped by 0.99
    big = 3.4e38
    ap = torch.where(dx > 0, (c_vec - x) / dx,
                     torch.where(dx < 0, -x / dx, big)).min()
    ad = torch.minimum(torch.where(dxi < 0, -xi / dxi, big),
                       torch.where(dla < 0, -la / dla, big)).min()
    ap = torch.clamp(ap, max=1.0) * 0.99
    ad = torch.clamp(ad, max=1.0) * 0.99
    return (x + ap * dx, xi + ad * dxi, la + ad * dla, nu + ad * dnu,
            eta, resp, resd)


@full_fp32()
def _sv_decision(X, norms_sv, Xsv, coef, gamma: float, rho: float):
    """f(x) = sum_j coef_j K(sv_j, x) + rho (coef = alpha_j * y_j), the
    kernel matrix built one row block at a time."""
    step = max(1, SCORE_BLOCK_ELEMS // max(Xsv.shape[0], 1))
    out = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
    for s in range(0, X.shape[0], step):
        Xb = X[s:s + step]
        nx = (Xb * Xb).sum(1)
        d2 = torch.clamp(nx[:, None] + norms_sv[None, :] - 2.0 * (Xb @ Xsv.T),
                         min=0.0)
        out[s:s + step] = torch.exp(-gamma * d2) @ coef + rho
    return out


class PSVMModel(Model):
    algo = "psvm"

    def decision_function(self, frame: Frame) -> torch.Tensor:
        o = self.output
        return _sv_decision(self.data_info.expand(frame), o["sv_norms"],
                            o["sv_x"], o["sv_coef"], o["gamma"], o["rho"])

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        # a pseudo-probability for the metrics
        p1 = torch.sigmoid(self.decision_function(frame))
        return torch.stack([1.0 - p1, p1], dim=1)


class PSVM(ModelBuilder):
    """A kernel SVM (binomial only, as the reference's ``PSVM.can_build``)."""

    algo = "psvm"
    supports_regression = False

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            hyper_param=1.0,          # C (PSVMModel.java:115)
            positive_weight=1.0,
            negative_weight=1.0,
            kernel_type="gaussian",
            gamma=-1.0,               # -1: 1/P
            rank_ratio=-1.0,          # -1: sqrt(n)
            sv_threshold=1e-4,
            max_iterations=200,
            mu_factor=10.0,
            feasible_threshold=1e-3,
            surrogate_gap_threshold=1e-3,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> PSVMModel:
        self._refuse_checkpoint()
        p = self.params
        if str(p["kernel_type"]).lower() != "gaussian":
            raise ValueError(f"kernel_type {p['kernel_type']!r}: the "
                             "gaussian kernel only")
        di = DataInfo.make(frame, x, standardize=True)
        X = di.expand(frame)
        yvec = frame.vec(y)
        if not yvec.is_categorical or len(yvec.domain) != 2:
            raise ValueError("PSVM supports only binomial classification")
        ycode = yvec.data.float()
        ypm = torch.where(ycode > 0, 1.0, -1.0)        # {-1, +1}
        keep = (weights > 0) & (ycode >= 0)
        # rows out of the fit: zero feature rows and a box of C = 0, so
        # their alpha stays 0
        X = torch.where(keep[:, None], X, 0.0)
        n = X.shape[0]

        gamma = float(p["gamma"])
        if gamma <= 0:
            gamma = 1.0 / max(di.ncols_expanded, 1)
        rr = float(p["rank_ratio"])
        rank = int(np.sqrt(n)) if rr <= 0 else int(rr * n)
        rank = max(1, min(rank, n))

        H = _icf(X, ypm, rank, gamma, keep)
        H = torch.where(keep[:, None], H, 0.0)

        c_pos = float(p["hyper_param"]) * float(p["positive_weight"])
        c_neg = float(p["hyper_param"]) * float(p["negative_weight"])
        c_vec = torch.where(ypm > 0, c_pos, c_neg) * keep.float()
        c_vec = torch.clamp(c_vec, min=1e-12)

        # InitTask: la = xi = c/10, x = 0, nu = 0
        xv = torch.zeros(n, dtype=torch.float32, device=X.device)
        xi = c_vec / 10.0
        la = c_vec / 10.0
        nu = torch.zeros((), dtype=torch.float32, device=X.device)
        t_mu_num = float(np.float32(float(p["mu_factor"]) * 2.0 * n))

        feas = float(p["feasible_threshold"])
        sgap = float(p["surrogate_gap_threshold"])
        max_it = int(p["max_iterations"])
        for it in range(max_it):
            # eta, resp and resd belong to the incoming iterate (the
            # reference checks convergence before it steps): on convergence
            # keep the pre-step state, since a Newton step past it is
            # degenerate (t -> inf) in float32
            prev = (xv, xi, la, nu)
            xv, xi, la, nu, eta, resp, resd = _ipm_step(
                H, ypm, c_vec, xv, xi, la, nu, t_mu_num)
            eta_h, resp_h, resd_h, finite = torch.stack([
                eta, resp, resd, torch.isfinite(xv).all().float()]).tolist()
            job.update(min(0.9, it / max(max_it, 1)),
                       f"IPM iter {it}: sgap={eta_h:.3e}")
            if (resp_h <= feas and resd_h <= feas and eta_h <= sgap) \
                    or not finite:
                xv, xi, la, nu = prev
                break

        # RegulateAlphaTask: clamp, zero below sv_threshold, sign by label
        alpha, cv, ypm_h = torch.stack([xv, c_vec, ypm]).cpu().numpy()
        alpha = np.clip(alpha, 0.0, cv)
        alpha[alpha < float(p["sv_threshold"])] = 0.0
        sv_idx = np.nonzero(alpha > 0)[0]
        coef = alpha[sv_idx] * ypm_h[sv_idx]
        dev = X.device
        if len(sv_idx):
            Xsv = X[torch.as_tensor(sv_idx).to(dev)]
            svcoef = torch.as_tensor(coef.astype(np.float32)).to(dev)
        else:
            Xsv = torch.zeros((1, X.shape[1]), dtype=torch.float32,
                              device=dev)
            svcoef = torch.zeros(1, dtype=torch.float32, device=dev)
        sv_norms = (Xsv * Xsv).sum(1)

        # rho from free SVs: mean(y_i - f0(x_i)) over 0 < alpha_i < C
        # (reference CalculateRhoTask, on a sample of the SVs)
        if len(sv_idx):
            free = sv_idx[alpha[sv_idx] < cv[sv_idx] - 1e-8]
            ref = (free if len(free) else sv_idx)[:1000]
            f0 = _sv_decision(X[torch.as_tensor(ref).to(dev)], sv_norms, Xsv,
                              svcoef, gamma, 0.0).cpu().numpy()
            rho = float(np.mean(ypm_h[ref] - f0))
        else:
            rho = 0.0

        return PSVMModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=yvec.domain, data_info=di,
            output=dict(sv_x=Xsv, sv_coef=svcoef, sv_norms=sv_norms,
                        gamma=float(np.float32(gamma)),
                        rho=float(np.float32(rho)),
                        svs_count=int(len(sv_idx)), rank=rank, alpha=alpha))
