"""GLM — generalized linear models by IRLS — the port of
``h2o3_tpu/models/glm.py`` (reference: ``hex/glm/GLM.java:543,880,1335``,
``GLMTask.java:1509``, ``hex/gram/Gram.java:452-473``,
``hex/optimization/ADMM.java``).

Each IRLS iteration builds the weighted Gram X'WX of the dense design
(:class:`DataInfo`) and solves the penalised normal equations by Cholesky;
L2 goes into the Gram's diagonal, L1 through ten proximal IRLS passes
(the reference's simplified ADMM). The loop runs one iteration per pass
of a Python loop and syncs with the host once per iteration: one fetch of
the deviance, the stop rule (evaluated on the device, in float32, as the
reference's megastep evaluates it) and the Cholesky's status. The
reference's megastep (several iterations per compiled dispatch) has no
counterpart: the sequence of iterations is the same.

On the card the products run at full float32 whatever TF32 setting the
caller chose (:func:`full_fp32`): TF32's 10-bit mantissa breaks the
Cholesky on ill-conditioned designs, as bf16 inputs do on a TPU. The Gram
is built from row blocks of :data:`GRAM_BLOCK_ELEMS` elements in a fixed
order, so that no [rows, P] temporary exists beside the design and the
sum is the same on every run.

``non_negative`` solves each iteration's normal equations by projected
coordinate descent on the host (:func:`_nn_solve`): a [P+1]² Gram is small,
and on the card a pass would be hundreds of tiny launches.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.sparse import SparseFrame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.models.data_info import (DataInfo, expand_interactions,
                                             response_as_float)
from h2o3_tpu_torch.models.distributions import get_family
from h2o3_tpu_torch.models.glm_sparse import fit_sparse_glm, sparse_score
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import (Model, ModelBuilder,
                                              make_model_key,
                                              publish_dispatch_audit)
from h2o3_tpu_torch.ops.map_reduce import mesh_reduce
from h2o3_tpu_torch.parallel.mesh import refuse_on_mesh
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils.costs import accounted
from h2o3_tpu_torch.utils.registry import DKV
from h2o3_tpu_torch.utils.timeline import timed_event


def _irls_cost(args, statics) -> tuple[float, float]:
    """One IRLS iteration on the [R, P] design: the weighted Gram
    (2·R·P² FLOP), X'Wz (2·R·P) and the Cholesky solve (P³/3); bytes are
    the design, response and weights read once and the [P+1, P+1] Gram
    written once. The working response and the deviance are left out."""
    X = args[0]
    R, P = X.shape[0], X.shape[1] + 1
    return (2.0 * R * P * P + 2.0 * R * P + P ** 3 / 3.0,
            float(R * P * 4 + R * 8 + P * P * 4))


def _multinomial_cost(args, statics) -> tuple[float, float]:
    """One multinomial sweep: K class blocks, each an IRLS iteration's
    cost (:func:`_irls_cost`) on the same design."""
    flops, nbytes = _irls_cost(args, statics)
    k = int(statics["nclasses"])
    return k * flops, k * nbytes


#: one IRLS iteration and one multinomial sweep as sites of the compute
#: observatory (the reference's megastep programs)
_IRLS_SITE = accounted("glm:irls_megastep", _irls_cost, loop="glm_irls")
_MULTINOMIAL_SITE = accounted("glm:multinomial_megastep", _multinomial_cost,
                              loop="glm_multinomial")

#: elements of one row block of the Gram's product (256 MB in float32):
#: the weighted block is the only temporary of the design's width
GRAM_BLOCK_ELEMS = 1 << 26

#: the Gram's ridge, relative to its mean diagonal, and the most the IRLS
#: loop raises it to (tenfold a try) where a singular design's float32 Gram
#: rounds below it and fails to factorise (RuleFit's complementary rules)
JITTER, MAX_JITTER = 1e-5, 1e-2


@contextlib.contextmanager
def full_fp32():
    """float32 matrix products at full float32 inside the block, whatever
    the caller set (``allow_tf32``, ``set_float32_matmul_precision`` or the
    per-backend ``fp32_precision``); the caller's setting is restored."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        prev = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = prev
    else:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)


def _fam(family: str, tweedie_p: float):
    """``tweedie_p`` doubles as the family's auxiliary parameter: variance
    power for tweedie, dispersion theta for negativebinomial."""
    if family == "tweedie":
        return get_family(family, p=tweedie_p)
    if family == "negativebinomial":
        return get_family(family, theta=tweedie_p)
    return get_family(family)


def _row_blocks(R: int, P: int):
    step = max(1, GRAM_BLOCK_ELEMS // max(P, 1))
    return [(s, min(s + step, R)) for s in range(0, R, step)] or [(0, 0)]


def _gram_partials(X, W, z):
    """This rank's [X,1]'W[X,1] and [X,1]'Wz parts: X'WX [k, k], the
    columns X'Wz and X'W [k, 2], and (ΣW, ΣWz). Summed over row blocks in
    a fixed order."""
    R, k = X.shape
    G = torch.zeros((k, k), dtype=torch.float32, device=X.device)
    side = torch.zeros((k, 2), dtype=torch.float32, device=X.device)
    zw = torch.stack([z, torch.ones_like(z)], 1)
    for s, e in _row_blocks(R, k):
        Xw = X[s:e] * W[s:e, None]
        G.addmm_(Xw.T, X[s:e])
        side.addmm_(Xw.T, zw[s:e])
    return G, side, torch.stack([W.sum(), (W * z).sum()])


def _weighted_gram(X, W, z, l2, nobs, jitter):
    """Normal equations for weighted least squares with an unpenalised
    intercept column: gram = [X,1]'W[X,1] + l2*nobs*diag(1..1,0) +
    jitter*I, rhs = [X,1]'Wz; the jitter is relative to the Gram's trace,
    so collinear designs stay factorizable. Across ranks the parts are
    summed over every rank's rows by one all_reduce (``map_reduce``)."""
    k = X.shape[1]
    G, side, sums = mesh_reduce(_gram_partials, X, W, z)
    gram = torch.empty((k + 1, k + 1), dtype=torch.float32, device=X.device)
    gram[:k, :k] = G
    gram[:k, k] = side[:, 1]
    gram[k, :k] = side[:, 1]
    gram[k, k] = sums[0]
    rhs = torch.cat([side[:, 0], sums[1:]])
    penalty = l2 * nobs * torch.cat([torch.ones(k, device=X.device),
                                     torch.zeros(1, device=X.device)])
    j = jitter * (torch.trace(gram) / (k + 1) + 1.0)
    eye = torch.eye(k + 1, dtype=torch.float32, device=X.device)
    gram = gram + torch.diag(penalty) + j * eye
    return gram, rhs


def _weighted_sq_sums(X, W):
    """Σ_r W_r x_rj² per column, over the same row blocks (and every
    rank's rows)."""
    def sq_sums(X, W):
        out = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
        for s, e in _row_blocks(*X.shape):
            Xb = X[s:e]
            out += (Xb * Xb).T @ W[s:e]
        return out

    return mesh_reduce(sq_sums, X, W)


def _rows_sums(*vals):
    """Σ over the mesh's rows of each per-row tensor, [len(vals)]."""
    return mesh_reduce(lambda *v: torch.stack([x.sum() for x in v]), *vals)


def _nn_solve(gram, rhs, beta0, tol: float = 1e-7, max_passes: int = 100):
    """Non-negative solve of the penalised normal equations by cyclic
    projected coordinate descent (reference: ADMM.java solves the same
    bound-constrained QP), on the host in float32: the intercept (last
    coordinate) stays free, and passes stop once the largest move is at
    most ``tol``. A pass is P+1 coordinate updates in numpy; the Gram
    crosses to the host once per call."""
    G = gram.cpu().numpy()
    r = rhs.cpu().numpy()
    b0 = beta0.cpu().numpy()
    b = np.maximum(b0, np.float32(0.0))
    b[-1] = b0[-1]
    k = len(b) - 1
    tol32 = np.float32(tol)
    for _ in range(max_passes):
        prev = b.copy()
        for j in range(k + 1):
            bj = b[j] + (r[j] - G[j] @ b) / np.maximum(G[j, j],
                                                        np.float32(1e-12))
            b[j] = np.maximum(bj, np.float32(0.0)) if j < k else bj
        if not np.max(np.abs(b - prev)) > tol32:
            break
    return torch.from_numpy(b).to(gram.device)


def _solve(gram, rhs, beta, non_negative: bool):
    """The step's coefficients and the Cholesky's status (0: factorised),
    which stays on the device until the loop's fetch."""
    if non_negative:
        return (_nn_solve(gram, rhs, beta),
                torch.zeros((), dtype=torch.int32, device=gram.device))
    L, info = torch.linalg.cholesky_ex(gram)
    return torch.cholesky_solve(rhs[:, None], L)[:, 0], info


def _eta(X, beta, off):
    return X @ beta[:-1] + beta[-1] + off


def _irls_step(fam, X, y, w, beta, l2, non_negative: bool, off,
               jitter: float):
    """One IRLS iteration: the weighted Gram and its solve. ``off`` is the
    per-row margin offset: it enters eta and is left out of the working
    response the solve fits. Returns ``(new_beta, deviance at beta,
    max |step|, Cholesky status)``, all on the device."""
    eta = _eta(X, beta, off)
    mu = fam.linkinv(eta)
    d = fam.dmu_deta(eta)
    var = fam.variance(mu)
    W = w * d * d / var.clamp_min(1e-12)
    z = eta + (y - mu) / d.clamp_min(1e-12) - off
    wsum, dev = _rows_sums(w, w * fam.deviance(y, mu))
    nobs = wsum.clamp_min(1.0)
    gram, rhs = _weighted_gram(X, W, z, l2, nobs, jitter)
    new_beta, info = _solve(gram, rhs, beta, non_negative)
    return new_beta, dev, (new_beta - beta).abs().max(), info


def _l1_threshold(fam, X, w, beta, lam1, lam2, off=0.0):
    """Per-coefficient proximal threshold lam1*nobs/(gram_jj + lam2*nobs)."""
    eta = _eta(X, beta, off)
    d = fam.dmu_deta(eta)
    W = w * d * d / fam.variance(fam.linkinv(eta)).clamp_min(1e-12)
    nobs = _rows_sums(w)[0].clamp_min(1.0)
    gram_diag = _weighted_sq_sums(X, W) + lam2 * nobs
    return lam1 * nobs / gram_diag.clamp_min(1e-12)


def _soft_threshold(b, thr):
    return torch.sign(b) * (b.abs() - thr).clamp_min(0.0)


def _plateau(dev_prev, dev, obj_eps: float):
    """The reference's objective stop, in float32 on the device."""
    return torch.isfinite(dev_prev) & (
        (dev_prev - dev).abs() <= obj_eps * dev_prev.abs().clamp_min(1.0))


def _wald_inference(family: str, tw: float, X, yy, w, beta, dev: float,
                    off=0.0):
    """Wald standard errors / z / p per coefficient (reference: GLM.java
    ``computePValues``: the inverse information matrix at the MLE;
    dispersion estimated for gaussian, gamma and tweedie, fixed at 1 for
    binomial and poisson)."""
    fam = _fam(family, tw)
    eta = _eta(X, beta, off)
    d = fam.dmu_deta(eta)
    W = w * d * d / fam.variance(fam.linkinv(eta)).clamp_min(1e-12)
    nobs = w.sum().clamp_min(1.0)
    gram, _ = _weighted_gram(X, W, torch.zeros_like(yy), 0.0, nobs, 1e-8)
    inv = torch.linalg.inv_ex(gram)[0]
    n_eff = float((w > 0).sum())
    pdim = X.shape[1] + 1
    phi = (dev / max(n_eff - pdim, 1.0)
           if family in ("gaussian", "gamma", "tweedie") else 1.0)
    cov = inv.cpu().double().numpy() * phi
    se = np.sqrt(np.clip(np.diag(cov), 0.0, None))
    z = beta.cpu().double().numpy() / np.maximum(se, 1e-30)
    return se, z, _p_values(z), cov


def _p_values(z: np.ndarray) -> np.ndarray:
    """Two-sided normal p-values, erfc(|z| / sqrt 2)."""
    return np.array([math.erfc(abs(v) / math.sqrt(2.0)) for v in z])


def _deviance_at(fam, X, y, w, beta, off=0.0):
    return _rows_sums(w * fam.deviance(y, fam.linkinv(_eta(X, beta, off))))[0]


def _null_deviance(fam, y, w):
    wy, ws = _rows_sums(w * y, w)
    mu0 = (wy / ws.clamp_min(1e-30)).expand_as(y)
    return _rows_sums(w * fam.deviance(y, mu0))[0]


def _glm_score(family: str, nclasses: int, tweedie_p: float, X, beta,
               off=0.0):
    if family == "multinomial":
        return torch.softmax(X @ beta[:-1, :] + beta[-1, :][None, :], dim=1)
    mu = _fam(family, tweedie_p).linkinv(_eta(X, beta, off))
    if nclasses == 2:
        return torch.stack([1.0 - mu, mu], dim=1)
    return mu


def _multinomial_step(nclasses: int, X, yoh, w, B, l2, l1,
                      non_negative: bool = False):
    """One sweep of per-class quadratic (IRLS) updates for softmax
    regression (reference: GLM.java multinomial solves class blocks
    cyclically with the binomial-style working response per class). B:
    [P+1, K], last row the intercepts. L1 is a per-class proximal soft
    threshold in the units of :meth:`GLM._admm_l1`. Returns ``(B,
    deviance at the new B, the worst Cholesky status)``."""
    k_feat = X.shape[1]
    nobs = w.sum().clamp_min(1.0)
    info = torch.zeros((), dtype=torch.int32, device=X.device)
    for c in range(nclasses):
        eta = X @ B[:-1, :] + B[-1, :][None, :]
        p = torch.softmax(eta, dim=1)
        pc = p[:, c]
        pq = (pc * (1 - pc)).clamp_min(1e-10)
        W = w * pq
        z = eta[:, c] + (yoh[:, c] - pc) / pq
        gram, rhs = _weighted_gram(X, W, z, l2, nobs, 1e-5)
        bc, inf_c = _solve(gram, rhs, B[:, c], non_negative)
        info = torch.maximum(info, inf_c.to(torch.int32))
        thr = l1 * nobs / torch.diagonal(gram)[:k_feat].clamp_min(1e-12)
        bc = torch.cat([_soft_threshold(bc[:-1], thr), bc[-1:]])
        B = B.clone()
        B[:, c] = bc
    eta = X @ B[:-1, :] + B[-1, :][None, :]
    logp = torch.log_softmax(eta, dim=1)
    dev = -2.0 * (w * (yoh * logp).sum(dim=1)).sum()
    return B, dev, info


def _check_factorised(info: float, where: str) -> None:
    if info:
        raise ValueError(f"GLM: the Gram matrix is not positive definite "
                         f"({where}; Cholesky status {int(info)})")


class GLMModel(Model):
    algo = "glm"

    def _score_raw(self, frame) -> torch.Tensor:
        if self.output.get("sparse"):
            if not isinstance(frame, SparseFrame):
                raise ValueError("this GLM was trained on a SparseFrame; "
                                 "score SparseFrame inputs")
            return sparse_score(self, frame)
        with full_fp32():
            if self.params["family"] == "ordinal":
                X = self.data_info.expand(frame)
                return _ordinal_probs(X @ self.output["beta"],
                                      self.output["ordinal_theta"])
            oc = self.params.get("offset_column")
            off = 0.0
            if oc:
                if oc not in frame:
                    raise ValueError(f"scoring frame lacks offset column "
                                     f"{oc!r}")
                off = torch.nan_to_num(frame.vec(oc).as_float(), nan=0.0)
            if self.params.get("interactions"):
                frame = expand_interactions(
                    frame, self.params["interactions"],
                    self.output.get("interaction_domains"))
            X = self.data_info.expand(frame)
            return _glm_score(self.params["family"], self.nclasses or 0,
                              _aux_param(self.params, self.params["family"]),
                              X, self.output["beta"], off)

    def coef(self):
        """Coefficients on the original scale (reference:
        GLMModel.coefficients()); multinomial models give a per-class
        nested dict keyed ``coefs_class_K``."""
        return self._coef_dict(np.asarray(self.output["coef"]))

    def coef_norm(self):
        """Standardized coefficients (same multinomial nesting as
        ``coef``)."""
        return self._coef_dict(self.output["beta"].cpu().numpy())

    def _coef_dict(self, mat: np.ndarray):
        names = self.output["coef_names"] + ["Intercept"]
        if mat.ndim == 1:
            return dict(zip(names, mat))
        return {f"coefs_class_{k}": dict(zip(names, mat[:, k]))
                for k in range(mat.shape[1])}

    def coef_table(self):
        """Rows (name, coefficient, std_error, z_value, p_value) — the
        reference's coefficients table with Wald inference (needs
        ``compute_p_values=True``)."""
        if "p_values" not in self.output:
            raise ValueError("train with compute_p_values=True")
        names = self.output["coef_names"] + ["Intercept"]
        return [dict(name=n, coefficient=float(c), std_error=float(s),
                     z_value=float(z), p_value=float(p))
                for n, c, s, z, p in zip(
                    names, np.asarray(self.output["coef"]),
                    self.output["std_errs"], self.output["z_values"],
                    self.output["p_values"])]

    def get_regularization_path(self):
        """Lambda-search path (h2o-py ``getGLMRegularizationPath``): dicts
        of (lambda_, deviance, dev_explained, nonzero, beta)."""
        path = self.output.get("regularization_path")
        if path is None:
            raise ValueError("train with lambda_search=True")
        return path

    def varimp(self, use_pandas: bool = False):
        """Standardized-coefficient magnitudes per source column
        (reference: GLM variable importances; the one-hot levels of a
        categorical add up to their column)."""
        if use_pandas:
            raise NotImplementedError("use_pandas: the port returns rows")
        beta = np.abs(self.output["beta"].cpu().numpy())
        if beta.ndim == 2:                       # multinomial: sum over classes
            beta = beta.sum(axis=1)
        names = self.output["coef_names"]        # excludes the intercept
        di = self.data_info
        rel: dict[str, float] = {c: 0.0 for c in di.cat_cols + di.num_cols}
        for name, b in zip(names, beta[:len(names)]):
            head = name.split(".", 1)[0]
            src = head if head in rel else name
            rel[src] = rel.get(src, 0.0) + float(b)
        mx = max(rel.values()) if rel and max(rel.values()) > 0 else 1.0
        tot = sum(rel.values()) or 1.0
        return sorted(((c, v, v / mx, v / tot) for c, v in rel.items()),
                      key=lambda r: -r[1])


def _ordinal_probs(eta, theta):
    """[n, J] class probabilities of the proportional-odds model:
    differences of P(y <= j) = sigmoid(theta_j - eta)."""
    cum = torch.sigmoid(theta[None, :] - eta[:, None])
    n = eta.shape[0]
    cdf = torch.cat([torch.zeros((n, 1), device=eta.device), cum,
                     torch.ones((n, 1), device=eta.device)], dim=1)
    return torch.diff(cdf, dim=1)


def _aux_param(params, family: str) -> float:
    """The family's auxiliary parameter: theta for negativebinomial, else
    the tweedie variance power."""
    return (float(params.get("theta", 1.0)) if family == "negativebinomial"
            else float(params["tweedie_variance_power"]))


def _softplus(x):
    """log(1 + e^x) as the reference's ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


class GLM(ModelBuilder):
    """h2o-py surface: ``H2OGeneralizedLinearEstimator``. A
    :class:`~h2o3_tpu_torch.frame.sparse.SparseFrame` trains by the
    matrix-free path of :mod:`h2o3_tpu_torch.models.glm_sparse`."""

    algo = "glm"
    rank_aware = True
    mesh_refused = ModelBuilder.mesh_refused + (
        "lambda_search", "compute_p_values", "interactions")

    def _check_mesh(self, frame, validation_frame) -> None:
        """As the base's; across ranks GLM fits the IRLS path of the
        binomial and numeric families (the Gram, X'Wz, the deviance and the
        L1 pass summed over the ranks); Skip's row filter, the multinomial
        and ordinal families are not rank-aware yet."""
        super()._check_mesh(frame, validation_frame)
        if self._mvh_mode() == "skip":
            refuse_on_mesh("GLM's missing_values_handling='Skip'")
        if str(self.params.get("family")) in ("multinomial", "ordinal"):
            refuse_on_mesh(f"GLM's family={self.params['family']!r}")

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, weights=None):
        if isinstance(training_frame, SparseFrame):
            refuse_on_mesh("GLM on a SparseFrame")
            if x is not None:
                raise ValueError("column selection (x) is not supported on "
                                 "SparseFrame inputs: slice the COO instead")
            self._refuse_outside_slice()
            if self.params.get("nfolds") or self.params.get("fold_column"):
                # the reference's sparse path runs no fold either
                raise NotImplementedError(
                    "cross-validation of a SparseFrame is not ported")
            self.job = Job(f"glm-sparse on {training_frame.key or 'frame'}")

            def fit_sparse(j):
                model = fit_sparse_glm(self, j, training_frame, y or "C0",
                                       weights)
                if validation_frame is not None:
                    model.validation_metrics = model.model_performance(
                        validation_frame)
                return model

            self.job.run(fit_sparse)
            if self.job.status == Job.FAILED:
                raise self.job.exception
            self.model = self.job.result
            return self.model
        return super().train(x=x, y=y, training_frame=training_frame,
                             validation_frame=validation_frame,
                             weights=weights)

    def _scoring_history(self, model):
        """Per-IRLS-iteration rows (reference: ``GLM.java``
        ``ScoringHistory``: iterations / negative_log_likelihood /
        objective)."""
        devs = getattr(self, "_iter_devs", None)
        if not devs:
            return None
        nobs = float(model.training_metrics.nobs) if getattr(
            model.training_metrics, "nobs", 0) else 1.0
        return self._history_table(
            model,
            [("iterations", "long", "%d"),
             ("negative_log_likelihood", "double", "%.5f"),
             ("objective", "double", "%.5f")],
            [[i + 1, d / 2.0, d / (2.0 * nobs)]
             for i, d in enumerate(devs)])

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            family="gaussian",        # AUTO resolved in _fit
            solver="IRLSM",
            alpha=0.0,                # elastic-net mix (L1 fraction)
            lambda_=0.0,              # regularization strength
            tweedie_variance_power=1.5,
            theta=1.0,                # negativebinomial dispersion
            standardize=True,
            use_all_factor_levels=False,
            intercept=True,
            non_negative=False,
            max_iterations=50,
            beta_epsilon=1e-4,
            objective_epsilon=1e-6,
            compute_p_values=False,
            lambda_search=False,
            nlambdas=30,
            lambda_min_ratio=1e-4,
            beta_constraints=None,    # {name: (lower, upper)} or rows of
            #                           {"names", "lower_bounds", ...}
            offset_column=None,       # per-row margin offset
            interactions=None,        # columns to cross
            # MeanImputation (default) | Skip | PlugValues
            missing_values_handling="MeanImputation",
            plug_values=None,         # with PlugValues: {numeric_col: value}
            #                           or the key of a 1-row frame
        )

    def _refuse_outside_slice(self) -> None:
        """Parameters of features the port does not have raise."""
        if self.params.get("checkpoint") is not None:
            raise NotImplementedError("GLM does not resume from a checkpoint")
        solver = str(self.params.get("solver") or "IRLSM").upper()
        if solver not in ("IRLSM", "AUTO"):
            raise NotImplementedError(f"solver {solver!r} is not ported; "
                                      "the port solves by IRLSM")

    def _fit_ordinal(self, job: Job, frame, x, y, weights, yvec) -> GLMModel:
        """Proportional-odds cumulative-logit fit (reference: GLM.java
        ordinal family): P(y <= j) = sigmoid(theta_j - x·beta) with ordered
        thresholds theta_j = a + Σ softplus(d_i); full-batch Adam (lr 0.5,
        betas 0.9/0.999, eps 1e-8) for 20 × max_iterations steps, the
        gradient from autograd and the update by hand, as the reference's
        ``lax.scan`` takes it."""
        refuse_on_mesh("GLM's ordinal family")
        params = self.params
        if params.get("interactions") or params.get("offset_column"):
            raise ValueError("interactions/offset_column are not supported "
                             "for the ordinal family")
        di = self._make_data_info(frame, x)
        X = di.expand(frame)
        codes = yvec.data.long()
        valid = codes >= 0
        w = weights * valid
        yc = torch.where(valid, codes, 0)
        J = yvec.cardinality()
        K = X.shape[1]
        lam = float(params["lambda_"])
        dev = X.device

        def unpack(p):
            beta, a, d = p[:K], p[K], p[K + 1:]
            theta = a + torch.cat([torch.zeros(1, device=dev),
                                   torch.cumsum(_softplus(d), 0)])
            return beta, theta

        def nll(p):
            beta, theta = unpack(p)
            eta = X @ beta
            cum = torch.sigmoid(theta[None, :] - eta[:, None])
            n = X.shape[0]
            cdf = torch.cat([torch.zeros((n, 1), device=dev), cum,
                             torch.ones((n, 1), device=dev)], dim=1)
            pj = cdf.gather(1, yc[:, None] + 1)[:, 0] \
                - cdf.gather(1, yc[:, None])[:, 0]
            nobs = w.sum().clamp_min(1.0)
            return (-(w * torch.log(pj.clamp_min(1e-12))).sum()
                    + lam * nobs * (beta * beta).sum()) / nobs

        iters = max(int(params["max_iterations"]), 1) * 20
        lr = 0.5
        p = torch.zeros(K + J - 1, dtype=torch.float32, device=dev)
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        t = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(iters):
            pg = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(nll(pg), pg)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            t = t + 1
            mh = m / (1 - torch.pow(0.9, t))
            vh = v / (1 - torch.pow(0.999, t))
            p = p - lr * mh / (torch.sqrt(vh) + 1e-8)
        with torch.no_grad():
            final = float(nll(p))
        job.update(0.9, f"ordinal nll {final:.5f}")
        beta, theta = unpack(p)
        # destandardize like the main path: coef_orig = beta_std * mul;
        # centering shifts the thresholds (theta absorbs the x·sub terms)
        b = beta.cpu().double().numpy()
        coef = b.copy()
        th = theta.cpu().double().numpy()
        if params["standardize"] and di.num_cols:
            s0, nnum = di.ncats_expanded, len(di.num_cols)
            mul = di.num_mul.astype(np.float64)
            sub = di.num_sub.astype(np.float64)
            coef[s0:s0 + nnum] = b[s0:s0 + nnum] * mul
            th = th + float((b[s0:s0 + nnum] * mul * sub).sum())
        self._last_train_raw = _ordinal_probs(X @ beta, theta)
        mparams = dict(params, family="ordinal")
        return GLMModel(
            key=make_model_key(self.algo, self.model_id),
            params=mparams, data_info=di, response_column=y,
            response_domain=yvec.domain,
            output=dict(beta=beta, coef=coef, coef_names=di.coef_names,
                        ordinal_theta=theta, ordinal_theta_orig=th,
                        residual_deviance=2.0 * final, iterations=iters,
                        family="ordinal", lambda_best=lam,
                        regularization_path=None))

    def _build_beta_bounds(self, di, params, family: str, device):
        """[lo, hi] per coefficient (+ intercept) from ``beta_constraints``
        (reference: GLM BetaConstraints: names / lower_bounds /
        upper_bounds), given on the original scale and, with
        standardization, mapped to the fitted one (beta_std = beta_orig /
        num_mul)."""
        bc = params.get("beta_constraints")
        if not bc:
            return None
        if family == "multinomial":
            raise ValueError("beta_constraints are not supported for "
                             "multinomial (reference: GLM.java)")
        names = list(di.coef_names)
        items: dict[str, tuple] = {}
        if isinstance(bc, dict):
            for k, v in bc.items():
                items[k] = ((v[0], v[1]) if isinstance(v, (tuple, list))
                            else (v, None))
        else:
            for row in bc:
                items[row["names"]] = (row.get("lower_bounds"),
                                       row.get("upper_bounds"))
        unknown = set(items) - set(names) - {"Intercept"}
        if unknown:
            raise ValueError(f"beta_constraints name unknown coefficients: "
                             f"{sorted(unknown)}")
        K = len(names)
        lo = np.full(K + 1, -np.inf, np.float64)
        hi = np.full(K + 1, np.inf, np.float64)
        for i, n in enumerate(names + ["Intercept"]):
            if n in items:
                lb, ub = items[n]
                lo[i] = -np.inf if lb is None else float(lb)
                hi[i] = np.inf if ub is None else float(ub)
        if params["standardize"] and di.num_cols:
            if "Intercept" in items and np.any(di.num_sub != 0):
                # original intercept = b_int - Σ b_j·mul_j·sub_j: a box on it
                # is not a box on the standardized intercept
                raise ValueError(
                    "an Intercept beta_constraint cannot be honored with "
                    "standardize=True over centered numeric columns; set "
                    "standardize=False")
            s0, nnum = di.ncats_expanded, len(di.num_cols)
            mul = di.num_mul.astype(np.float64)       # 1/sd, > 0
            lo[s0:s0 + nnum] = lo[s0:s0 + nnum] / mul
            hi[s0:s0 + nnum] = hi[s0:s0 + nnum] / mul
        return (torch.as_tensor(lo.astype(np.float32)).to(device),
                torch.as_tensor(hi.astype(np.float32)).to(device))

    def _irls_fit(self, job: Job, fam, X, yy, w, beta, lambda_: float,
                  params) -> tuple[torch.Tensor, float, int]:
        """IRLS to convergence at one lambda (reference: GLM.java IRLSM
        loop); elastic-net L1 by the proximal pass :meth:`_admm_l1`. The
        stop rule is checked after every step: max |step| below
        ``beta_epsilon``, gaussian's second step, the deviance's relative
        change within ``objective_epsilon``, or ``max_iterations``; one
        host fetch per iteration carries it with the deviance and the
        Cholesky's status. A step whose Gram fails to factorise is taken
        again with ten times the ridge, up to :data:`MAX_JITTER`."""
        lam = lambda_ * (1.0 - float(params["alpha"]))
        nn = bool(params.get("non_negative"))
        bounds = self._beta_bounds
        off = self._offset
        max_it = int(params["max_iterations"])
        beta_eps = float(params["beta_epsilon"])
        obj_eps = float(params["objective_epsilon"])
        gaussian_ls = fam.name == "gaussian" and not nn
        dev_prev = torch.full((), float("inf"), device=X.device)
        dev, it_total, done = float("inf"), 0, False
        jitter = JITTER
        fetches = 0
        while it_total < max_it and not done:
            with timed_event("iteration", "glm_irls",
                             observe=_tm.ITER_SECONDS.labels(
                                 loop="glm_irls")), \
                    _IRLS_SITE.dispatch((X, w), {"family": fam.name}):
                new_beta, dev_t, delta, info = _irls_step(
                    fam, X, yy, w, beta, lam, non_negative=nn, off=off,
                    jitter=jitter)
                if bounds is not None:
                    # projected Newton: clip into the box, measure the
                    # step against the projected point
                    new_beta = torch.clamp(new_beta, bounds[0], bounds[1])
                    delta = (new_beta - beta).abs().max()
                stop = (delta < beta_eps) | _plateau(dev_prev, dev_t,
                                                     obj_eps)
            # the iteration's one host fetch: its probe can be read after
            dev, stop_h, info_h = torch.stack(
                [dev_t, stop.float(), info.float()]).tolist()
            _IRLS_SITE.settle()
            fetches += 1
            if info_h and jitter < MAX_JITTER:
                jitter *= 10.0
                continue
            _check_factorised(info_h, f"IRLS iteration {it_total}")
            # weighted least squares solves exactly in one step; the
            # second confirms
            done = bool(stop_h) or (gaussian_ls and it_total >= 1)
            beta, dev_prev = new_beta, dev_t
            it_total += 1
            self._iter_devs.append(dev)
            job.update(it_total / max_it,
                       f"iter {it_total - 1} deviance {dev:.4f}")
        it = max(it_total - 1, 0)
        publish_dispatch_audit(self, "glm_irls", iterations=max(it_total, 1),
                               host_syncs=fetches, device_dispatches=fetches)
        if float(params["alpha"]) > 0 and lambda_ > 0:
            while True:
                b_l1, info = self._admm_l1(fam, X, yy, w, beta, lambda_,
                                           params, jitter)
                if bounds is not None:
                    b_l1 = torch.clamp(b_l1, bounds[0], bounds[1])
                dev, info_h = torch.stack([
                    _deviance_at(fam, X, yy, w, b_l1, off),
                    info.float()]).tolist()
                if not (info_h and jitter < MAX_JITTER):
                    break
                jitter *= 10.0
            _check_factorised(info_h, "the L1 pass")
            beta = b_l1
        return beta, dev, it

    def _admm_l1(self, fam, X, yy, w, beta, lambda_: float, params,
                 jitter: float):
        """L1 by proximal IRLS (the reference's simplified ADMM,
        hex/optimization/ADMM.java): ten IRLS steps, each followed by a
        soft threshold of the non-intercept coefficients at
        lam1 * nobs / gram_jj, which keeps L1 and the nobs-scaled L2 in the
        same per-observation units. Returns the coefficients and the worst
        Cholesky status, both on the device."""
        lam1 = lambda_ * float(params["alpha"])
        lam2 = lambda_ * (1.0 - float(params["alpha"]))
        nn = bool(params.get("non_negative"))
        off = self._offset
        worst = torch.zeros((), dtype=torch.int32, device=X.device)
        for _ in range(10):
            beta, _dev, _delta, info = _irls_step(fam, X, yy, w, beta, lam2,
                                                  non_negative=nn, off=off,
                                                  jitter=jitter)
            worst = torch.maximum(worst, info.to(torch.int32))
            thr = _l1_threshold(fam, X, w, beta, lam1, lam2, off)
            beta = torch.cat([_soft_threshold(beta[:-1], thr), beta[-1:]])
        return beta, worst

    def _lambda_search(self, job: Job, fam, X, yy, w, beta, params):
        """Regularization path with warm starts (reference: GLM.java lambda
        search / glmnet): a geometric grid from lambda_max down; stop once
        the deviance's gain stays under 1e-4 of the null deviance for three
        steps; ``getGLMRegularizationPath``."""
        alpha = max(float(params["alpha"]), 1e-3)   # glmnet λmax convention
        wsum = w.sum().clamp_min(1e-30)
        mu_bar = (w * yy).sum() / wsum
        lam_max = float((X.T @ (w * (yy - mu_bar))).abs().max()
                        / wsum) / alpha
        lam_max = max(lam_max, 1e-6)
        nlam = int(params["nlambdas"])
        ratio = float(params["lambda_min_ratio"])
        lambdas = lam_max * np.power(ratio, np.linspace(0, 1, nlam))
        null_dev = float(_null_deviance(fam, yy, w))
        path = []
        dev_prev, flat_steps = null_dev, 0
        for i, lam in enumerate(lambdas):
            beta, dev, _ = self._irls_fit(job, fam, X, yy, w, beta,
                                          float(lam), params)
            # one fetch per lambda: the coefficients (nonzero counted here)
            beta_h = beta.cpu().numpy()
            path.append(dict(lambda_=float(lam), deviance=dev,
                             dev_explained=1.0 - dev / max(null_dev, 1e-30),
                             nonzero=int((np.abs(beta_h[:-1]) > 1e-8).sum()),
                             beta=beta_h))
            # stop once extra shrinkage relief stops paying, after sustained
            # flatness only: near lambda_max every step is flat because beta
            # is still ~0
            if (dev_prev - dev) < 1e-4 * max(null_dev, 1e-30):
                flat_steps += 1
                if flat_steps >= 3 and path[i]["dev_explained"] > 0:
                    break
            else:
                flat_steps = 0
            dev_prev = dev
        best = min(path, key=lambda e: e["deviance"])
        beta = torch.as_tensor(best["beta"]).to(X.device)
        return beta, best["deviance"], 0, best["lambda_"], path

    def _make_data_info(self, frame: Frame, x) -> DataInfo:
        """DataInfo with the missing-value mode baked into the imputation
        vector: PlugValues replaces the per-column means the expansion puts
        in for NaN, at training and at scoring."""
        params = self.params
        di = DataInfo.make(frame, x, standardize=params["standardize"],
                           use_all_factor_levels=params[
                               "use_all_factor_levels"])
        if self._mvh_mode() != "plugvalues":
            if params.get("plug_values") is not None:
                raise ValueError("plug_values requires "
                                 "missing_values_handling='PlugValues'")
            return di
        plugs = params.get("plug_values")
        if isinstance(plugs, str):
            pf = DKV[plugs]
            if pf.nrows != 1:
                raise ValueError(f"plug_values frame {plugs!r} must have "
                                 f"exactly 1 row, got {pf.nrows}")
            plugs = {c: pf.vec(c).to_numpy()[0] for c in pf.names}
        if not isinstance(plugs, dict) or not plugs:
            raise ValueError("missing_values_handling='PlugValues' needs "
                             "plug_values ({column: value} or a 1-row "
                             "frame key)")
        bad = [c for c in plugs if c in di.cat_cols]
        if bad:
            raise ValueError(f"categorical plug values not supported yet: "
                             f"{bad}")
        unknown = [c for c in plugs if c not in di.num_cols]
        if unknown:
            raise ValueError(f"plug_values name unknown numeric columns: "
                             f"{unknown}")

        def _coerce(v) -> float:
            try:
                return float(v)
            except (TypeError, ValueError):
                return float("nan")
        plugs = {c: _coerce(v) for c, v in plugs.items()}
        bad_vals = [c for c, v in plugs.items() if not np.isfinite(v)]
        if bad_vals:
            raise ValueError(f"plug_values must be finite numbers; got "
                             f"non-finite for {bad_vals}")
        means = np.array(di.num_means, np.float32).copy()
        for c, v in plugs.items():
            means[di.num_cols.index(c)] = float(v)
        di.num_means = means
        return di

    def _mvh_mode(self) -> str:
        """Canonical missing_values_handling (h2o-py sends lowercase enum
        forms like mean_imputation)."""
        return str(self.params.get("missing_values_handling")
                   or "MeanImputation").replace("_", "").lower()

    @full_fp32()
    def _fit(self, job: Job, frame: Frame, x, y, weights) -> GLMModel:
        self._refuse_outside_slice()
        params = self.params
        self._iter_devs = []    # per-IRLS-iteration deviances → history
        mvh = self._mvh_mode()
        if mvh == "skip":
            # rows with any NA among the used predictors drop out of the fit
            # (weight 0) and of the metrics (reference Skip)
            na = torch.zeros(frame.nrows, dtype=torch.bool,
                             device=frame.device)
            for c in x:
                v = frame.vec(c)
                na = na | ((v.data < 0) if v.type is VecType.CAT
                           else torch.isnan(v.data))
            had_weight = float(weights.sum()) > 0.0
            weights = weights * (~na)
            if float(weights.sum()) == 0.0:
                raise ValueError(
                    "missing_values_handling='Skip' removed every row "
                    "(all rows have at least one NA predictor)"
                    if had_weight else
                    "no rows carry training weight (check weights_column)")
            self._metrics_weights = weights
        elif mvh not in ("meanimputation", "plugvalues"):
            raise ValueError(
                f"missing_values_handling {mvh!r} unsupported "
                "(MeanImputation | Skip | PlugValues)")
        if int(params["max_iterations"]) == -1:
            # reference: -1 means the solver's default
            params["max_iterations"] = 50
        elif int(params["max_iterations"]) < 1:
            raise ValueError("max_iterations must be >= 1 (or -1 for auto)")
        yvec = frame.vec(y)
        family = params["family"]
        if yvec.is_categorical:
            if family == "ordinal":
                if yvec.cardinality() < 3:
                    raise ValueError("ordinal family needs >= 3 ordered "
                                     "levels")
                return self._fit_ordinal(job, frame, x, y, weights, yvec)
            # the multinomial family is honored on a 2-level response too
            if family == "multinomial" or yvec.cardinality() != 2:
                if family not in ("AUTO", "gaussian", "multinomial"):
                    raise ValueError(f"family {family!r} requires a binary "
                                     "or numeric response")
                return self._fit_multinomial_glm(job, frame, x, y, weights,
                                                 yvec)
            family = "binomial" if family in ("gaussian", "AUTO") else family
        else:
            if family == "AUTO":
                family = "gaussian"
            if family in ("binomial", "bernoulli"):
                raise ValueError("binomial family requires a categorical "
                                 "(2-level) response")
            if family == "multinomial":
                raise ValueError("multinomial family requires a categorical "
                                 "response")
        tw = _aux_param(params, family)

        self._interaction_domains = None
        if params.get("interactions"):
            inter = list(params["interactions"])
            bad = set(inter) - set(frame.names)
            if bad:
                raise ValueError(f"interactions name unknown columns: "
                                 f"{sorted(bad)}")
            self._interaction_domains = {
                c: frame.vec(c).domain for c in inter
                if frame.vec(c).is_categorical}
            before = set(frame.names)
            frame = expand_interactions(frame, inter,
                                        self._interaction_domains)
            x = list(x) + [c for c in frame.names if c not in before]

        di = self._make_data_info(frame, x)
        X = di.expand(frame)
        yy, valid = response_as_float(yvec)
        w = weights * valid
        yy = torch.where(w > 0, yy, 0.0)

        fam = _fam(family, tw)
        mu0 = fam.initialize_mu(yy)
        k = X.shape[1]
        beta = torch.zeros(k + 1, dtype=torch.float32, device=X.device)
        wmu, ws = _rows_sums(w * mu0, w)
        beta[-1] = fam.link(wmu / ws.clamp_min(1e-30))

        self._beta_bounds = self._build_beta_bounds(di, params, family,
                                                    X.device)
        oc = params.get("offset_column")
        self._offset = (torch.nan_to_num(frame.vec(oc).as_float(), nan=0.0)
                        if oc else 0.0)

        if bool(params.get("lambda_search")):
            beta, dev, it, lambda_best, reg_path = self._lambda_search(
                job, fam, X, yy, w, beta, params)
        else:
            beta, dev, it = self._irls_fit(job, fam, X, yy, w, beta,
                                           float(params["lambda_"]), params)
            lambda_best, reg_path = float(params["lambda_"]), None

        # destandardize for reporting: X_std = (x - sub) * mul
        b = beta.cpu().double().numpy()
        coef = b.copy()
        s0, nnum = di.ncats_expanded, len(di.num_cols)
        mul = di.num_mul.astype(np.float64)
        sub = di.num_sub.astype(np.float64)
        if params["standardize"] and nnum:
            coef[s0:-1] = b[s0:-1] * mul
            coef[-1] = b[-1] - float((b[s0:s0 + nnum] * mul * sub).sum())

        null_dev = float(_null_deviance(fam, yy, w))
        output = dict(beta=beta, coef=coef, coef_names=di.coef_names,
                      residual_deviance=dev, null_deviance=null_dev,
                      iterations=it + 1, family=family,
                      lambda_best=lambda_best, regularization_path=reg_path,
                      interaction_domains=self._interaction_domains)
        if bool(params.get("compute_p_values")):
            if float(params["lambda_"]) > 0 or bool(
                    params.get("lambda_search")):
                raise ValueError("compute_p_values requires no "
                                 "regularization (reference: GLM.java "
                                 "p-values need lambda=0)")
            se, zv, pv, cov = _wald_inference(family, tw, X, yy, w, beta,
                                              dev, self._offset)
            if params["standardize"] and nnum:
                # standard errors on the scale of `coef`: se_orig[num] =
                # se_std[num] * mul; the intercept's by the delta method on
                # b_int - Σ b_j·mul_j·sub_j over the full covariance
                se = se.copy()
                se[s0:s0 + nnum] *= mul
                a = np.zeros(len(b))
                a[-1] = 1.0
                a[s0:s0 + nnum] = -(mul * sub)
                se[-1] = float(np.sqrt(max(a @ cov @ a, 0.0)))
                zv = coef / np.maximum(se, 1e-30)
                pv = _p_values(zv)
            output.update(std_errs=se, z_values=zv, p_values=pv)
        self._last_train_raw = _glm_score(
            family, 2 if yvec.is_categorical else 0, tw, X, beta,
            self._offset)
        return GLMModel(
            key=make_model_key(self.algo, self.model_id),
            params=dict(params, family=family), data_info=di,
            response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=output)

    def _fit_multinomial_glm(self, job: Job, frame: Frame, x, y, weights,
                             yvec) -> GLMModel:
        """Softmax regression by cyclic per-class IRLS blocks (reference:
        GLM.java multinomial path); the deviance's plateau stops it, checked
        after every sweep with one host fetch."""
        refuse_on_mesh("GLM's multinomial family")
        params = self.params
        if params.get("interactions") or params.get("offset_column"):
            raise ValueError("interactions/offset_column are not supported "
                             "for multinomial")
        di = self._make_data_info(frame, x)
        X = di.expand(frame)
        yy, valid = response_as_float(yvec)
        w = weights * valid
        K = yvec.cardinality()
        yoh = torch.nn.functional.one_hot(
            torch.where(w > 0, yy, 0.0).long(), K).float()
        yoh = yoh * (w > 0)[:, None]

        P = X.shape[1]
        B = torch.zeros((P + 1, K), dtype=torch.float32, device=X.device)
        lam = float(params["lambda_"]) * (1.0 - float(params["alpha"]))
        lam1 = float(params["lambda_"]) * float(params["alpha"])
        nn = bool(params.get("non_negative"))
        max_it = int(params["max_iterations"])
        obj_eps = float(params["objective_epsilon"])
        dev_prev = torch.full((), float("inf"), device=X.device)
        dev, it_total, done = float("inf"), 0, False
        while it_total < max_it and not done:
            with timed_event("iteration", "glm_multinomial",
                             observe=_tm.ITER_SECONDS.labels(
                                 loop="glm_multinomial")), \
                    _MULTINOMIAL_SITE.dispatch((X, w), {"nclasses": K}):
                B, dev_t, info = _multinomial_step(K, X, yoh, w, B, lam,
                                                   lam1, nn)
                stop = _plateau(dev_prev, dev_t, obj_eps)
            dev, stop_h, info_h = torch.stack(
                [dev_t, stop.float(), info.float()]).tolist()
            _MULTINOMIAL_SITE.settle()
            _check_factorised(info_h, f"multinomial sweep {it_total}")
            done = bool(stop_h)
            dev_prev = dev_t
            it_total += 1
            job.update(it_total / max_it,
                       f"iter {it_total - 1} deviance {dev:.4f}")
        it = max(it_total - 1, 0)
        publish_dispatch_audit(self, "glm_multinomial",
                               iterations=max(it_total, 1),
                               host_syncs=it_total,
                               device_dispatches=it_total)

        b = B.cpu().double().numpy()
        coef = b.copy()
        if params["standardize"] and di.num_cols:
            nnum = len(di.num_cols)
            s = di.ncats_expanded
            mul = di.num_mul.astype(np.float64)
            sub = di.num_sub.astype(np.float64)
            coef[s:s + nnum, :] = b[s:s + nnum, :] * mul[:, None]
            coef[-1, :] = b[-1, :] - (b[s:s + nnum, :]
                                      * (mul * sub)[:, None]).sum(axis=0)
        self._last_train_raw = _glm_score("multinomial", K, 0.0, X, B)
        return GLMModel(
            key=make_model_key(self.algo, self.model_id),
            params=dict(params, family="multinomial"), data_info=di,
            response_column=y, response_domain=yvec.domain,
            output=dict(beta=B, coef=coef, coef_names=di.coef_names,
                        residual_deviance=dev, null_deviance=float("nan"),
                        iterations=it + 1, family="multinomial"))
