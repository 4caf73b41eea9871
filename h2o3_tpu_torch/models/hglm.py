"""HGLM — a gaussian mixed-effects GLM with random effects per group — the
port of ``h2o3_tpu/models/hglm.py`` (reference:
``hex/glm/GLMModel.java:271,379-398``, ``HGLM=True`` with
``random_columns``).

y = X·β + Z·u + ε with u ~ N(0, σ²_u I) per level of a grouping column,
fitted by EM: the E-step's per-group [q, q] sums are ``index_add_`` into
[G, q*q] and the posterior covariances one batched ``torch.linalg.inv``;
the M-step solves the fixed effects' weighted least squares at full
float32 (no TF32) and updates the two variances by moments. Each
iteration fetches σ²_e and σ²_u once, for the stop rule.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import (DataInfo, remap_codes,
                                             response_as_float)
from h2o3_tpu_torch.models.glm import full_fp32
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _em_step(X, Zr, gid, y, w, beta, sig_u, sig_e, n_groups: int, q: int):
    """One EM iteration. Zr [rows, q]: each row's random-effect design
    (column 0 the intercept's 1s, then the random slopes); gid [rows]."""
    dev = X.device
    with full_fp32():
        # E-step: V_g = (Z_g'Z_g/sig_e + I/sig_u)^-1,
        # m_g = V_g Z_g'(y - Xb)/sig_e
        resid = y - (X @ beta[:-1] + beta[-1])
        wZ = Zr * w[:, None]
        ZtZ = torch.zeros((n_groups, q * q), dtype=X.dtype, device=dev)
        ZtZ.index_add_(0, gid, (wZ[:, :, None] * Zr[:, None, :])
                       .reshape(-1, q * q))
        ZtZ = ZtZ.reshape(n_groups, q, q)
        Ztr = torch.zeros((n_groups, q), dtype=X.dtype, device=dev)
        Ztr.index_add_(0, gid, wZ * resid[:, None])
        prec = ZtZ / torch.clamp(sig_e, min=1e-10) \
            + torch.eye(q, device=dev)[None] / torch.clamp(sig_u, min=1e-10)
        V = torch.linalg.inv(prec)
        m = torch.einsum("gab,gb->ga", V, Ztr) / torch.clamp(sig_e, min=1e-10)

        # M-step for beta: weighted least squares on y - Z·E[u]
        zu = (Zr * m[gid]).sum(1)
        yt = y - zu
        k = X.shape[1]
        Xw = X * w[:, None]
        xs = Xw.sum(0)
        gram = torch.empty((k + 1, k + 1), dtype=X.dtype, device=dev)
        gram[:k, :k] = Xw.T @ X
        gram[:k, k] = xs
        gram[k, :k] = xs
        gram[k, k] = w.sum()
        gram = gram + 1e-6 * torch.eye(k + 1, device=dev)
        rhs = torch.cat([Xw.T @ yt, (w * yt).sum()[None]])
        beta_new = torch.linalg.solve(gram, rhs)

        # M-step for the variances (EM moment updates)
        nobs = torch.clamp(w.sum(), min=1.0)
        e = y - (X @ beta_new[:-1] + beta_new[-1]) - zu
        # E[e'e] adds the posterior variance of Z u
        trZVZ = torch.einsum("gab,gab->g", ZtZ, V).sum()
        sig_e_new = ((w * e * e).sum() + trZVZ) / nobs
        sig_u_new = (m * m + torch.diagonal(V, dim1=1, dim2=2)).sum() \
            / (n_groups * q)
    return beta_new, m, V, sig_u_new, sig_e_new


def _z_design(frame: Frame, random_columns) -> torch.Tensor:
    """[rows, q] random-effect design: the intercept's 1s and the random
    slopes' columns (NaN as 0); one definition for fit and scoring."""
    cols = [torch.ones(frame.nrows, dtype=torch.float32, device=frame.device)]
    for c in random_columns:
        cols.append(torch.nan_to_num(frame.vec(c).as_float(), nan=0.0))
    return torch.stack(cols, dim=1)


class HGLMModel(Model):
    algo = "hglm"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        o = self.output
        X = self.data_info.expand(frame)
        with full_fp32():
            eta = X @ o["beta"][:-1] + o["beta"][-1]
        gcol = self.params["group_column"]
        if gcol in frame:
            v = frame.vec(gcol)
            if not v.is_categorical:
                raise TypeError(f"group column {gcol!r} must be categorical "
                                "at scoring time")
            codes = v.data
            if v.domain != o["group_domain"]:
                codes = remap_codes(codes, v.domain or (), o["group_domain"])
            known = codes >= 0
            safe = torch.where(known, codes, 0).long()
            zu = (self._zrows(frame) * o["u"][safe]).sum(1)
            eta = eta + torch.where(known, zu, 0.0)   # unseen group: fixed
        return eta

    def _zrows(self, frame: Frame) -> torch.Tensor:
        return _z_design(frame, self.params.get("random_columns") or [])

    def ranef(self) -> dict:
        """Per-group random effects (h2o-py HGLM: ``model.coefs_random``)."""
        u = self.output["u"].cpu().numpy()
        names = ["intercept"] + list(self.params.get("random_columns") or [])
        return {lvl: dict(zip(names, u[i]))
                for i, lvl in enumerate(self.output["group_domain"])}


class HGLM(ModelBuilder):
    """h2o-py surface: ``H2OGeneralizedLinearEstimator(HGLM=True,
    random_columns=[...])``, as a builder of its own.

    ``group_column``: the grouping factor (a random intercept per level);
    ``random_columns``: numeric columns that also get a random slope per
    group. Gaussian family (the reference HGLM's default)."""

    algo = "hglm"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            group_column=None,       # required: categorical grouping factor
            random_columns=None,     # numeric columns with per-group slopes
            max_iterations=50,
            em_epsilon=1e-5,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> HGLMModel:
        self._refuse_checkpoint()
        p = self.params
        if int(p["max_iterations"]) == -1:
            p["max_iterations"] = 50    # h2o-py's auto sentinel (GLM.java)
        elif int(p["max_iterations"]) < 1:
            raise ValueError("max_iterations must be >= 1 (or -1 for auto)")
        gcol = p.get("group_column")
        if not gcol:
            raise ValueError("group_column is required for HGLM")
        gvec = frame.vec(gcol)
        if not gvec.is_categorical:
            raise ValueError(f"group_column {gcol!r} must be categorical")
        yvec = frame.vec(y)
        if yvec.is_categorical:
            raise ValueError("HGLM here is gaussian-family (numeric "
                             "response) — the reference HGLM default")
        rand_cols = list(p.get("random_columns") or [])
        for c in rand_cols:
            if frame.vec(c).is_categorical:
                raise ValueError(f"random column {c!r} must be numeric")

        x = [c for c in x if c != gcol]
        di = DataInfo.make(frame, x, standardize=False,
                           use_all_factor_levels=False)
        X = di.expand(frame)
        yy, valid = response_as_float(yvec)
        gvalid = gvec.data >= 0
        w = weights * valid * gvalid
        yc = torch.where(w > 0, yy, 0.0)
        gid = torch.where(gvalid, gvec.data, 0).long()
        G = gvec.cardinality()
        q = 1 + len(rand_cols)
        Zr = _z_design(frame, rand_cols)

        ybar = float((w * yc).sum() / torch.clamp(w.sum(), min=1e-30))
        var0 = float((w * (yc - ybar) ** 2).sum()
                     / torch.clamp(w.sum(), min=1.0))
        beta = torch.zeros(X.shape[1] + 1, dtype=torch.float32,
                           device=X.device)
        beta[-1] = ybar
        sig_u = torch.tensor(max(var0 / 2, 1e-4), dtype=torch.float32,
                             device=X.device)
        sig_e = sig_u.clone()

        max_it = int(p["max_iterations"])
        prev = np.inf
        it = 0
        u = V = None
        for it in range(max_it):
            beta, u, V, sig_u, sig_e = _em_step(X, Zr, gid, yc, w, beta,
                                                sig_u, sig_e, G, q)
            su, se = torch.stack([sig_u, sig_e]).tolist()
            job.update((it + 1) / max_it,
                       f"EM iter {it}: sig_u {su:.4f} sig_e {se:.4f}")
            if np.isfinite(prev) and abs(prev - se) <= \
                    float(p["em_epsilon"]) * max(prev, 1e-12):
                break
            prev = se

        return HGLMModel(
            key=make_model_key(self.algo, self.model_id),
            params=p, data_info=di, response_column=y, response_domain=None,
            output=dict(beta=beta, u=u, u_var=V, sig_u=su, sig_e=se,
                        coef=beta.cpu().numpy(), coef_names=di.coef_names,
                        group_domain=gvec.domain, iterations=it + 1))
