"""PCA, SVD and GLRM — the port of ``h2o3_tpu/models/decomposition.py``
(reference: ``hex/pca/PCA.java``, ``hex/svd/SVD.java``,
``hex/glrm/GLRM.java``, losses ``hex/genmodel/algos/glrm/GlrmLoss.java``,
regularizers ``GlrmRegularizer.java``).

PCA and SVD (method GramSVD) build the weighted Gram of the design on the
device at full float32 (TF32 off whatever the caller set, as GLM's
:func:`~h2o3_tpu_torch.models.glm.full_fp32`) and eigendecompose it on the
host in float64 with numpy, with the reference's ordering and sign rule
(each eigenvector's largest-|·| component positive).

GLRM fits X ≈ A·Y. With quadratic loss and a regularizer the closed form
honours, alternating masked ridge solves: a [rows, k, k] batch of k × k
systems for A and a [cols, k, k] batch for Y, each Gram a product of the
mask with the outer products of Y's (or A's) columns, solved by
``torch.linalg.solve_ex`` in row blocks. Any other loss or regularizer
runs the reference's alternating proximal gradient with its step rule:
the per-column losses and gradients of :func:`_glrm_loss_and_grad` are
evaluated in row blocks, so no [rows, cols] temporary but the design, its
mask and A·Y's block exists. Each iteration reads one number, the
objective, on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import DataInfo, remap_codes
from h2o3_tpu_torch.models.glm import full_fp32
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key

#: float32 entries of a row block's temporaries in GLRM ([rows, k, k]
#: solves, [rows, cols] losses): 2^26 (256 MB)
BLOCK_ELEMS = 1 << 26
#: GLRM's seed where ``seed`` is unset (the reference's)
DEFAULT_SEED = 271828


def _make_data_info(frame: Frame, x, transform: str,
                    use_all_factor_levels: bool = False) -> DataInfo:
    """The transform enum on DataInfo's sub/mul: NONE, DEMEAN, DESCALE,
    STANDARDIZE, NORMALIZE ((x − mean)/(max − min), ``DataInfo.java``
    TransformType)."""
    t = str(transform).upper()
    di = DataInfo.make(frame, x, standardize=(t == "STANDARDIZE"),
                       use_all_factor_levels=use_all_factor_levels)
    if t == "DEMEAN":
        di.num_sub = di.num_means.copy()
        di.num_mul = np.ones_like(di.num_mul)
    elif t == "DESCALE":
        di.num_sub = np.zeros_like(di.num_sub)
        sigmas = np.array([frame.vec(c).sigma() for c in di.num_cols],
                          np.float32)
        di.num_mul = np.where((sigmas > 0) & np.isfinite(sigmas),
                              1.0 / np.maximum(sigmas, 1e-30), 1.0
                              ).astype(np.float32)
    elif t == "NORMALIZE":
        rng = np.array([frame.vec(c).max() - frame.vec(c).min()
                        for c in di.num_cols], np.float32)
        di.num_sub = di.num_means.copy()
        di.num_mul = np.where((rng > 0) & np.isfinite(rng),
                              1.0 / np.maximum(rng, 1e-30), 1.0
                              ).astype(np.float32)
    elif t == "NONE":
        di.num_sub = np.zeros_like(di.num_sub)
        di.num_mul = np.ones_like(di.num_mul)
    elif t != "STANDARDIZE":
        raise ValueError(f"unknown transform {transform!r}")
    return di


def _gram(X, w):
    """The weighted Gram XᵀWX, the weighted column sums and Σw, at full
    float32."""
    with full_fp32():
        Xw = X * w[:, None]
        return X.T @ Xw, Xw.sum(dim=0), w.sum()


def _top_eigen(G: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The k largest eigenvalues of a symmetric float64 matrix and their
    eigenvectors, each with its largest-|·| component positive."""
    evals, evecs = np.linalg.eigh(G)
    order = np.argsort(evals)[::-1][:k]
    evals, evecs = evals[order], evecs[:, order]
    signs = np.sign(evecs[np.abs(evecs).argmax(axis=0), np.arange(k)])
    return evals, evecs * np.where(signs == 0, 1.0, signs)[None, :]


def _columns_frame(names, M: torch.Tensor) -> Frame:
    return Frame(names, [Vec.from_device(M[:, i].contiguous(), VecType.NUM)
                         for i in range(M.shape[1])])


class PCAModel(Model):
    algo = "pca"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        # centered projections: the train-time column means come off
        X = self.data_info.expand(frame)
        mu = torch.as_tensor(self.output["mu"]).to(X.device, torch.float32)
        return (X - mu[None, :]) @ self.output["eigenvectors"]

    def predict(self, frame: Frame) -> Frame:
        S = self._score_raw(frame)
        return _columns_frame([f"PC{i + 1}" for i in range(S.shape[1])], S)

    def model_performance(self, frame: Frame):
        return None

    def rotation(self) -> np.ndarray:
        return self.output["eigenvectors"].cpu().numpy()


class PCA(ModelBuilder):
    """h2o-py surface: ``H2OPrincipalComponentAnalysisEstimator``."""

    algo = "pca"
    unsupervised = True

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            k=1,
            transform="DEMEAN",
            pca_method="GramSVD",
            use_all_factor_levels=False,
            compute_metrics=True,
            max_iterations=1000,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> PCAModel:
        p = self.params
        self._refuse_checkpoint()
        if str(p["pca_method"]) != "GramSVD":
            raise NotImplementedError(
                f"pca_method={p['pca_method']!r} not implemented (have "
                "GramSVD)")
        k = int(p["k"])
        di = _make_data_info(frame, x, p["transform"],
                             bool(p.get("use_all_factor_levels", False)))
        X = di.expand(frame)
        K = X.shape[1]
        if not 1 <= k <= K:
            raise ValueError(f"k must be in [1, {K}]")
        G, colsum, wsum = _gram(X, weights)
        G = G.cpu().numpy().astype(np.float64)
        wsum = float(wsum)
        mu = colsum.cpu().numpy().astype(np.float64) / max(wsum, 1e-12)
        n = max(wsum, 2.0)
        # the covariance of the transformed design: PCA always centers
        cov = (G / (n - 1.0)) - np.outer(mu, mu) * (n / (n - 1.0))
        evals, evecs = _top_eigen(cov, k)
        evals = np.maximum(evals, 0.0)
        tot_var = float(np.trace(cov))
        prop = evals / tot_var if tot_var > 0 else np.zeros_like(evals)
        return PCAModel(
            key=make_model_key(self.algo, self.model_id), params=p,
            response_column=None, response_domain=None,
            output=dict(eigenvectors=torch.as_tensor(
                            evecs.astype(np.float32)).to(X.device),
                        mu=mu.astype(np.float32), std_deviation=np.sqrt(evals),
                        eigenvalues=evals, prop_var=prop,
                        cum_var=np.cumsum(prop), coef_names=di.coef_names,
                        total_variance=tot_var),
            data_info=di)


class SVDModel(Model):
    algo = "svd"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        X = self.data_info.expand(frame)
        d = torch.as_tensor(self.output["d"]).to(X.device, torch.float32)
        return (X @ self.output["v"]) / torch.clamp_min(d[None, :], 1e-30)

    def predict(self, frame: Frame) -> Frame:
        U = self._score_raw(frame)
        return _columns_frame([f"u{i + 1}" for i in range(U.shape[1])], U)

    def model_performance(self, frame: Frame):
        return None


class SVD(ModelBuilder):
    """h2o-py surface: ``H2OSingularValueDecompositionEstimator`` (method
    GramSVD: the eigendecomposition of XᵀX)."""

    algo = "svd"
    unsupervised = True

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            nv=1,
            transform="NONE",
            svd_method="GramSVD",
            use_all_factor_levels=True,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> SVDModel:
        p = self.params
        self._refuse_checkpoint()
        if str(p["svd_method"]) != "GramSVD":
            raise NotImplementedError(
                f"svd_method={p['svd_method']!r} not implemented (have "
                "GramSVD)")
        di = _make_data_info(frame, x, p["transform"],
                             bool(p.get("use_all_factor_levels", False)))
        X = di.expand(frame)
        K = X.shape[1]
        nv = int(p["nv"])
        if not 1 <= nv <= K:
            raise ValueError(f"nv must be in [1, {K}]")
        G = _gram(X, weights)[0].cpu().numpy().astype(np.float64)
        evals, V = _top_eigen(G, nv)
        return SVDModel(
            key=make_model_key(self.algo, self.model_id), params=p,
            response_column=None, response_domain=None,
            output=dict(v=torch.as_tensor(V.astype(np.float32)).to(X.device),
                        d=np.sqrt(np.maximum(evals, 0.0)),
                        coef_names=di.coef_names),
            data_info=di)


# ---------------------------------------------------------------------------
# GLRM: the exact path
# ---------------------------------------------------------------------------

def _row_blocks(n: int, per_row: int):
    """Row ranges of at most :data:`BLOCK_ELEMS` / ``per_row`` rows."""
    step = max(BLOCK_ELEMS // max(per_row, 1), 1)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _outer_cols(Z: torch.Tensor) -> torch.Tensor:
    """[n, k·k]: row i holds the outer product of Z's row i with itself."""
    return (Z[:, :, None] * Z[:, None, :]).reshape(Z.shape[0], -1)


def _ridge_solve(G: torch.Tensor, r: torch.Tensor, gamma) -> torch.Tensor:
    """Solve (G[i] + (γ + 1e-6) I) a_i = r_i for each i of a batch."""
    k = r.shape[1]
    G = G.view(-1, k, k) + (gamma + 1e-6) * torch.eye(
        k, dtype=G.dtype, device=G.device)
    return torch.linalg.solve_ex(G, r[..., None])[0][..., 0]


def _glrm_update_A(X, M, Y, gamma_x):
    """Exact masked ridge solve per row: (Y·diag(mᵢ)·Yᵀ + γI)aᵢ =
    Y·diag(mᵢ)·xᵢ, a [rows, k, k] batch in row blocks."""
    k, K = Y.shape
    YY = _outer_cols(Y.T)                       # [cols, k·k]
    A = torch.empty((X.shape[0], k), dtype=X.dtype, device=X.device)
    for lo, hi in _row_blocks(X.shape[0], k * k + K):
        Mb = M[lo:hi]
        A[lo:hi] = _ridge_solve(Mb @ YY, (X[lo:hi] * Mb) @ Y.T, gamma_x)
    return A


def _glrm_update_Y(X, M, A, gamma_y):
    """Exact masked ridge solve per column, a [cols, k, k] batch; its Grams
    summed over row blocks."""
    k, K = A.shape[1], X.shape[1]
    G = torch.zeros((K, k * k), dtype=X.dtype, device=X.device)
    r = torch.zeros((K, k), dtype=X.dtype, device=X.device)
    for lo, hi in _row_blocks(X.shape[0], k * k + K):
        Ab, Mb = A[lo:hi], M[lo:hi]
        G += Mb.T @ _outer_cols(Ab)
        r += (X[lo:hi] * Mb).T @ Ab
    return _ridge_solve(G, r, gamma_y).T


def _glrm_objective(X, M, A, Y, gamma_x, gamma_y):
    """Σ (M·(X − AY))² + γx|A|² + γy|Y|², on the device."""
    tot = torch.zeros((), dtype=X.dtype, device=X.device)
    for lo, hi in _row_blocks(X.shape[0], X.shape[1]):
        R = (X[lo:hi] - A[lo:hi] @ Y) * M[lo:hi]
        tot = tot + (R * R).sum()
    return tot + gamma_x * (A * A).sum() + gamma_y * (Y * Y).sum()


def _apply_reg(Z, kind: str):
    if kind == "NonNegative":
        return torch.clamp_min(Z, 0.0)
    return Z


# ---------------------------------------------------------------------------
# GLRM: generalized losses and the proximal path
# ---------------------------------------------------------------------------

_LOSS_IDS = {"quadratic": 0, "absolute": 1, "huber": 2, "poisson": 3,
             "hinge": 4, "logistic": 5, "periodic": 6,
             "categorical": 7, "ordinal": 8}


def _loss_terms(fid: int, U, T, period, blk_start, blk_last):
    """(loss, dL/dU) elementwise for one loss id (``GlrmLoss``)."""
    if fid == 0:
        x = U - T
        return x * x, 2.0 * x
    if fid == 1:
        x = U - T
        return x.abs(), torch.sign(x)
    if fid == 2:
        x = U - T
        return (torch.where(x > 1, x - 0.5,
                            torch.where(x < -1, -x - 0.5, 0.5 * x * x)),
                torch.clamp(x, -1.0, 1.0))
    if fid == 3:
        eu = torch.exp(torch.clamp(U, -30, 30))
        Tpos = torch.clamp_min(T, 1e-30)
        return (eu - T * U + torch.where(T > 0, T * torch.log(Tpos) - T, 0.0),
                eu - T)
    if fid in (4, 5):
        s = 1.0 - 2.0 * T                       # binary sign
        if fid == 4:
            return (torch.clamp_min(1.0 + s * U, 0.0),
                    torch.where(1.0 + s * U > 0, s, 0.0))
        return (torch.log1p(torch.exp(torch.clamp(s * U, -30, 30))),
                s * torch.sigmoid(s * U))
    if fid == 6:
        f = 2.0 * math.pi / period
        return 1.0 - torch.cos((T - U) * f), -f * torch.sin((T - U) * f)
    if fid == 7:
        # one-hot block: Σ_{j≠a} max(1+u_j, 0) + max(1−u_a, 0)
        return (torch.where(T > 0, torch.clamp_min(1.0 - U, 0.0),
                            torch.clamp_min(1.0 + U, 0.0)),
                torch.where(T > 0, -(1.0 - U > 0).to(U.dtype),
                            (1.0 + U > 0).to(U.dtype)))
    # ordinal block: threshold column i (< d−1) of a level a: a > i gives
    # max(1 − u_i, 0), else 1; a > i where the block's one-hot cumsum is 0
    cum = torch.cumsum(T, dim=1)
    base = torch.nn.functional.pad(cum, (1, 0))[:, blk_start]
    a_gt_i = (cum - base) == 0
    last = blk_last[None, :]
    return (torch.where(last, 0.0, torch.where(
                a_gt_i, torch.clamp_min(1.0 - U, 0.0), 1.0)),
            torch.where(last | ~a_gt_i, 0.0,
                        torch.where(1.0 - U > 0, -1.0, 0.0)))


def _glrm_loss_and_grad(U, T, M, lid, period, blk_start, blk_last,
                        kinds=None):
    """Σ M·loss and M·dL/dU for the per-column losses: U = A·Y, T the
    target (numeric value; 0/1 for binary and one-hot blocks), M the
    observation mask, ``lid`` [cols] the loss id per expanded column,
    ``blk_start[j]`` the first column of j's categorical block (j
    elsewhere), ``blk_last[j]`` the last column of an ordinal block;
    ``kinds`` the loss ids to evaluate (every id when None)."""
    L = torch.zeros_like(U)
    G = torch.zeros_like(U)
    for fid in (range(len(_LOSS_IDS)) if kinds is None else kinds):
        lf, gf = _loss_terms(fid, U, T, period, blk_start, blk_last)
        sel = (lid == fid)[None, :]
        L = torch.where(sel, lf, L)
        G = torch.where(sel, gf, G)
    return (L * M).sum(), G * M


def _prox(Z, kind: str, step):
    """Proximal operator of step × the regularizer (``GlrmRegularizer
    .rproxgrad``); rows of Z are the regularized vectors."""
    if kind in (None, "None"):
        return Z
    if kind == "Quadratic":
        return Z / (1.0 + 2.0 * step)
    if kind == "L2":                      # group (row-wise) shrinkage
        nrm = torch.linalg.vector_norm(Z, dim=-1, keepdim=True)
        return Z * torch.clamp_min(1.0 - step / torch.clamp_min(nrm, 1e-30),
                                   0.0)
    if kind == "L1":
        return torch.sign(Z) * torch.clamp_min(Z.abs() - step, 0.0)
    if kind == "NonNegative":
        return torch.clamp_min(Z, 0.0)
    if kind == "OneSparse":               # the largest nonnegative entry
        Zp = torch.clamp_min(Z, 0.0)
        best = Zp.argmax(dim=-1, keepdim=True)
        oh = torch.arange(Z.shape[-1], device=Z.device)[None, :] == best
        return torch.where(oh, Zp, 0.0)
    if kind == "UnitOneSparse":           # an indicator vector
        best = Z.argmax(dim=-1, keepdim=True)
        return (torch.arange(Z.shape[-1], device=Z.device)[None, :]
                == best).to(Z.dtype)
    if kind == "Simplex":                 # Euclidean projection on the simplex
        srt = torch.sort(Z, dim=-1, descending=True).values
        css = torch.cumsum(srt, dim=-1) - 1.0
        j = torch.arange(1, Z.shape[-1] + 1, device=Z.device)
        rho = (srt - css / j > 0).sum(dim=-1, keepdim=True)
        theta = css.gather(-1, rho - 1) / rho
        return torch.clamp_min(Z - theta, 0.0)
    raise ValueError(f"unknown regularization {kind!r}")


def _reg_value(Z, kind: str, gamma: float):
    """γ × the regularizer's value at Z, on the device (0 for the
    constraint regularizers)."""
    if kind == "Quadratic":
        return gamma * (Z * Z).sum()
    if kind == "L2":
        return gamma * torch.linalg.vector_norm(Z, dim=-1).sum()
    if kind == "L1":
        return gamma * Z.abs().sum()
    if kind in (None, "None", "NonNegative", "OneSparse", "UnitOneSparse",
                "Simplex"):
        return 0.0
    raise ValueError(f"unknown regularization {kind!r}")


class _Losses:
    """The loss layout of a proximal fit: ids per column, the ids present,
    the period and the categorical blocks, on the device."""

    def __init__(self, lid: np.ndarray, blk_start: np.ndarray,
                 blk_last: np.ndarray, period: float, device):
        self.kinds = tuple(int(i) for i in np.unique(lid))
        self.lid = torch.as_tensor(lid).to(device)
        self.blk_start = torch.as_tensor(blk_start).long().to(device)
        self.blk_last = torch.as_tensor(blk_last).to(device)
        self.period = period

    def __call__(self, U, T, M):
        return _glrm_loss_and_grad(U, T, M, self.lid, self.period,
                                   self.blk_start, self.blk_last, self.kinds)


def _glrm_pass(Xt, M, A, Y, losses: _Losses, want: str):
    """The summed loss at A·Y and, with ``want`` "A" or "Y", its gradient
    in A (G·Yᵀ) or in Y (Aᵀ·G), in row blocks."""
    tot = torch.zeros((), dtype=Xt.dtype, device=Xt.device)
    grad = torch.empty_like(A) if want == "A" else \
        torch.zeros_like(Y) if want == "Y" else None
    for lo, hi in _row_blocks(Xt.shape[0], 4 * Xt.shape[1]):
        L, G = losses(A[lo:hi] @ Y, Xt[lo:hi], M[lo:hi])
        tot = tot + L
        if want == "A":
            grad[lo:hi] = G @ Y.T
        elif want == "Y":
            grad += A[lo:hi].T @ G
    return tot, grad


def _init_archetypes(Xc, k: int, init: str, gen) -> torch.Tensor:
    """The initial Y [k, cols]: the top k eigenvectors of XᵀX (SVD, no sign
    rule, as the reference), or 0.1 × normal draws (Random)."""
    if init == "SVD":
        with full_fp32():
            G = (Xc.T @ Xc).cpu().numpy().astype(np.float64)
        evals, evecs = np.linalg.eigh(G)
        return torch.as_tensor(evecs[:, np.argsort(evals)[::-1][:k]].T
                               .astype(np.float32)).to(Xc.device)
    if init == "RANDOM":
        return 0.1 * torch.randn((k, Xc.shape[1]), generator=gen,
                                 device=Xc.device)
    raise ValueError(f"unknown init {init!r}")


def _expand_masked(di: DataInfo, frame: Frame, row_ok) -> tuple:
    """The expanded design times its observation mask M (1 = observed),
    and M. ``expand`` imputes NAs, so NA cells are read off the raw
    columns: a categorical NA masks its whole one-hot block."""
    X = di.expand(frame)
    M = row_ok.to(torch.float32)[:, None].expand(X.shape).clone()
    col = 0
    for ci, c in enumerate(di.cat_cols):
        width = len(di.cat_domains[ci]) - (0 if di.use_all_factor_levels
                                           else 1)
        if width > 0:
            v = frame.vec(c)
            codes = v.data
            if v.domain != di.cat_domains[ci]:
                codes = remap_codes(codes, v.domain or (), di.cat_domains[ci])
            M[:, col:col + width] *= (codes >= 0).to(torch.float32)[:, None]
            col += width
    for ni, c in enumerate(di.num_cols):
        M[:, col + ni] *= (~torch.isnan(frame.vec(c).data)).to(torch.float32)
    return X.mul_(M), M


class GLRMModel(Model):
    algo = "glrm"

    def _x_factor(self, frame: Frame) -> torch.Tensor:
        """A of new rows: the masked ridge solve against the archetypes."""
        Xc, M = _expand_masked(self.data_info, frame, frame.row_mask())
        return _glrm_update_A(Xc, M, self.output["archetypes"],
                              float(self.output["gamma_x"]))

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        return self._x_factor(frame) @ self.output["archetypes"]

    def transform_frame(self, frame: Frame) -> Frame:
        """The low-rank representation A of new rows (reference: GLRM
        x-factor)."""
        A = self._x_factor(frame)
        return _columns_frame([f"Arch{i + 1}" for i in range(A.shape[1])], A)

    def predict(self, frame: Frame) -> Frame:
        R = self._score_raw(frame)
        return _columns_frame(
            [f"reconstr_{n}" for n in self.data_info.coef_names], R)

    def model_performance(self, frame: Frame):
        return None

    def archetypes(self) -> np.ndarray:
        return self.output["archetypes"].cpu().numpy()


class GLRM(ModelBuilder):
    """h2o-py surface: ``H2OGeneralizedLowRankEstimator``. Quadratic loss
    with a regularizer of :attr:`_EXACT_REGS` takes the exact alternating
    solves; any other loss or regularizer the alternating proximal
    gradient (``GLRM.java``'s update loop: a gradient step on A, prox, one
    on Y, prox; the step halved when the objective rises, grown 5% when it
    falls)."""

    algo = "glrm"
    unsupervised = True

    #: regularizers the exact path honours
    _EXACT_REGS = (None, "None", "Quadratic", "NonNegative")

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            k=1,
            transform="NONE",
            loss="Quadratic",            # numeric columns (GlrmLoss)
            multi_loss="Categorical",    # categorical: Categorical|Ordinal
            loss_by_col=None,            # per-source-column overrides
            loss_by_col_idx=None,
            period=1.0,                  # Periodic loss period
            regularization_x="None",     # None|Quadratic|L2|L1|NonNegative|
            regularization_y="None",     # OneSparse|UnitOneSparse|Simplex
            gamma_x=0.0,
            gamma_y=0.0,
            max_iterations=100,
            init="SVD",                  # SVD | Random
        )

    def _loss_ids(self, di: DataInfo, x: list[str]) -> np.ndarray:
        """Per-expanded-column loss ids from loss, multi_loss and
        loss_by_col."""
        p = self.params
        per_col: dict[str, str] = {}
        if p.get("loss_by_col"):
            names = list(p["loss_by_col"])
            idxs = list(p.get("loss_by_col_idx") or range(len(names)))
            if len(idxs) != len(names):
                raise ValueError("loss_by_col and loss_by_col_idx lengths "
                                 "differ")
            for i, nm in zip(idxs, names):
                per_col[x[int(i)]] = str(nm)
        lid = np.zeros(len(di.coef_names), np.int32)
        col = 0
        for ci, dom in enumerate(di.cat_domains):
            width = len(dom) - (0 if di.use_all_factor_levels else 1)
            name = di.cat_cols[ci]
            loss = per_col.get(name, str(p["multi_loss"])).lower()
            if loss not in ("categorical", "ordinal"):
                raise ValueError(f"categorical column {name!r} needs "
                                 "Categorical or Ordinal loss")
            lid[col:col + width] = _LOSS_IDS[loss]
            col += width
        for ni, c in enumerate(di.num_cols):
            loss = per_col.get(c, str(p["loss"])).lower()
            if loss in ("categorical", "ordinal"):
                raise ValueError(f"numeric column {c!r} cannot use {loss}")
            if loss not in _LOSS_IDS:
                raise ValueError(f"unknown loss {loss!r}; have "
                                 f"{sorted(_LOSS_IDS)}")
            lid[col + ni] = _LOSS_IDS[loss]
        return lid

    def _block_layout(self, di: DataInfo) -> tuple[np.ndarray, np.ndarray]:
        """(blk_start[cols], blk_last[cols]) of the categorical blocks."""
        K = len(di.coef_names)
        start = np.arange(K, dtype=np.int32)
        last = np.zeros(K, bool)
        col = 0
        for dom in di.cat_domains:
            width = len(dom) - (0 if di.use_all_factor_levels else 1)
            start[col:col + width] = col
            if width > 0:
                last[col + width - 1] = True
            col += width
        return start, last

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> GLRMModel:
        p = self.params
        self._refuse_checkpoint()
        k = int(p["k"])
        lb = [str(v).lower() for v in (p.get("loss_by_col") or [])]
        has_cat = any(frame.vec(c).is_categorical for c in x)
        nonquad = (str(p["loss"]).lower() != "quadratic" or has_cat
                   or any(v != "quadratic" for v in lb))
        exact_ok = (not nonquad
                    and p["regularization_x"] in self._EXACT_REGS
                    and p["regularization_y"] in self._EXACT_REGS)
        # generalized losses take the whole one-hot block of each column
        di = _make_data_info(frame, x, p["transform"],
                             use_all_factor_levels=has_cat or
                             bool(p.get("use_all_factor_levels", False)))
        Xc, M = _expand_masked(di, frame, weights > 0)
        n, K = Xc.shape
        if not 1 <= k <= min(n, K):
            raise ValueError(f"k must be in [1, {min(n, K)}]")
        seed = int(p.get("seed") or -1)
        gen = torch.Generator(device=Xc.device).manual_seed(
            seed if seed >= 0 else DEFAULT_SEED)
        Y = _init_archetypes(Xc, k, str(p["init"]).upper(), gen)
        iters = max(int(p["max_iterations"]), 1)
        with full_fp32():
            if exact_ok:
                A, Y, obj, it = self._fit_exact(job, Xc, M, Y, iters)
            else:
                A, Y, obj, it = self._fit_proximal(job, di, Xc, M, Y, k,
                                                   iters)
        return GLRMModel(
            key=make_model_key(self.algo, self.model_id), params=p,
            response_column=None, response_domain=None,
            output=dict(archetypes=Y, x_factor=A, objective=obj,
                        gamma_x=float(p["gamma_x"]),
                        gamma_y=float(p["gamma_y"]), iterations=it + 1,
                        coef_names=di.coef_names),
            data_info=di)

    def _fit_exact(self, job: Job, Xc, M, Y, iters: int):
        """Alternating masked ridge solves until the objective settles
        (relative change 1e-6); one host fetch an iteration."""
        p = self.params
        gx, gy = float(p["gamma_x"]), float(p["gamma_y"])
        rx, ry = p["regularization_x"], p["regularization_y"]
        obj_prev, it = np.inf, 0
        for it in range(iters):
            A = _apply_reg(_glrm_update_A(Xc, M, Y, gx), rx)
            Y = _apply_reg(_glrm_update_Y(Xc, M, A, gy), ry)
            obj = float(_glrm_objective(Xc, M, A, Y, gx, gy))
            job.update((it + 1) / iters, f"iter {it + 1} objective {obj:.5f}")
            if np.isfinite(obj_prev) and \
                    abs(obj_prev - obj) <= 1e-6 * max(obj_prev, 1.0):
                break
            obj_prev = obj
        A = _apply_reg(_glrm_update_A(Xc, M, Y, gx), rx)
        return A, Y, float(_glrm_objective(Xc, M, A, Y, gx, gy)), it

    def _fit_proximal(self, job: Job, di, Xc, M, Y, k: int, iters: int):
        """Alternating proximal gradient (``GLRM.java``'s non-quadratic
        path); one host fetch an iteration, the objective."""
        p = self.params
        losses = _Losses(self._loss_ids(di, self._x_cols),
                         *self._block_layout(di),
                         float(p.get("period") or 1.0), Xc.device)
        gx, gy = float(p["gamma_x"]), float(p["gamma_y"])
        rx, ry = p["regularization_x"], p["regularization_y"]

        def objective(A, Y, L):
            return L + _reg_value(A, rx, gx) + _reg_value(Y.T, ry, gy)

        A = torch.zeros((Xc.shape[0], k), dtype=torch.float32,
                        device=Xc.device)
        L0 = _glrm_pass(Xc, M, A, Y, losses, "")[0]
        n_obs, obj_prev = torch.stack([M.sum(), objective(A, Y, L0)]).tolist()
        alpha = 1.0 / max(n_obs, 1.0)    # ~1/Lipschitz of the summed loss
        it = 0
        for it in range(iters):
            GA = _glrm_pass(Xc, M, A, Y, losses, "A")[1]
            A1 = _prox(A - alpha * GA, rx, alpha * gx)
            GY = _glrm_pass(Xc, M, A1, Y, losses, "Y")[1]
            Y1 = _prox((Y - alpha * GY).T, ry, alpha * gy).T
            obj = float(objective(A1, Y1,
                                  _glrm_pass(Xc, M, A1, Y1, losses, "")[0]))
            if np.isfinite(obj) and obj <= obj_prev:
                A, Y = A1, Y1
                converged = abs(obj_prev - obj) <= 1e-7 * max(obj_prev, 1.0)
                obj_prev = obj
                alpha *= 1.05
                if converged:
                    break
            else:
                alpha *= 0.5
                if alpha < 1e-12:
                    break
            job.update((it + 1) / iters,
                       f"iter {it + 1} objective {obj_prev:.5f}")
        return A, Y, obj_prev, it
