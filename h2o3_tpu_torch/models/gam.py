"""GAM — generalized additive models by spline bases and the GLM — the port
of ``h2o3_tpu/models/gam.py`` (reference: ``hex/gam/``: the chosen
predictors expanded into spline bases on quantile knots, the expanded
frame fitted by GLM with a smoothness penalty, and scoring re-expanding).

Bases, each a closed-form elementwise map onto a [rows, k] tensor on the
device: ``bs=0`` natural cubic regression splines, ``bs=1`` thin-plate
splines (one predictor, |r|³ radials, or two, r²·log r), ``bs=2`` monotone
I-splines whose coefficients the GLM's ``beta_constraints`` keep
non-negative. The fit is the port's GLM on the frame plus the basis
columns. Knots sit at quantiles 0.02..0.98 of a column's non-missing
values, found by one sort on the device and linear interpolation, as
``jnp.nanquantile`` computes them (``torch.quantile`` refuses inputs over
2^24 values).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _ncs_basis(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Natural cubic spline basis [rows, k-1] on ``k`` knots: the linear
    term and k-2 truncated-power curvature terms with natural boundary
    constraints (ESL eq. 5.4-5.5; the reference's CR splines span the same
    space)."""
    k = knots.shape[0]
    last = knots[-1]

    def d(j):
        num = torch.clamp(x - knots[j], min=0.0) ** 3 \
            - torch.clamp(x - last, min=0.0) ** 3
        return num / torch.clamp(last - knots[j], min=1e-12)

    dlast = d(k - 2)
    return torch.stack([x] + [d(j) - dlast for j in range(k - 2)], dim=1)


def _tp_basis_1d(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """1-D thin-plate basis: |r|³ radials on the knots and the linear null
    space (the reference's thin plate for d = 1, m = 2)."""
    r = torch.abs(x[:, None] - knots[None, :])
    return torch.cat([x[:, None], r ** 3], dim=1)


def _tp_basis_2d(x1: torch.Tensor, x2: torch.Tensor, kx: np.ndarray
                 ) -> torch.Tensor:
    """2-D thin-plate basis: r²·log r radials on the knot centers and the
    linear null space (the reference's thin plate for d = 2, m = 2)."""
    kt = torch.as_tensor(np.asarray(kx, np.float32)).to(x1.device)
    dx = x1[:, None] - kt[None, :, 0]
    dy = x2[:, None] - kt[None, :, 1]
    r2 = dx * dx + dy * dy
    rad = torch.where(r2 > 1e-24,
                      0.5 * r2 * torch.log(torch.clamp(r2, min=1e-24)), 0.0)
    return torch.cat([x1[:, None], x2[:, None], rad], dim=1)


def _bspline_basis(x: torch.Tensor, knots: np.ndarray, degree: int = 3):
    """Cox–de Boor B-spline basis [rows, n_basis] on the open knot vector
    of ``knots`` (float32, as the reference forms it)."""
    t = np.concatenate([[knots[0]] * degree, knots, [knots[-1]] * degree])
    n = len(t) - degree - 1
    # the intervals are right-open, so the last knot is clipped to the
    # largest float32 below it (a 1e-9 offset rounds back to the knot)
    hi = np.nextafter(np.float32(knots[-1]), np.float32(knots[0]))
    xs = torch.clamp(x, float(knots[0]), float(hi))
    tf = [float(v) for v in t]
    B = [torch.where((xs >= tf[i]) & (xs < tf[i + 1]), 1.0, 0.0)
         for i in range(len(t) - 1)]
    for d in range(1, degree + 1):
        Bn = []
        for i in range(len(t) - d - 1):
            den1, den2 = t[i + d] - t[i], t[i + d + 1] - t[i + 1]
            a = (xs - tf[i]) / float(den1) * B[i] if den1 > 0 else 0.0
            b = (tf[i + d + 1] - xs) / float(den2) * B[i + 1] \
                if den2 > 0 else 0.0
            Bn.append(a + b)
        B = Bn
    return torch.stack(B[:n], dim=1)


def _ispline_basis(x: torch.Tensor, knots: np.ndarray, degree: int = 3):
    """I-spline (monotone) basis: I_i(x) = sum over j >= i of B_j(x)
    (Ramsay 1988; the reference's ISplines). Each I_i rises from 0 to 1,
    so non-negative coefficients give a monotone smooth; the constant
    first function is dropped."""
    Bhi = _bspline_basis(x, knots, degree)
    # sums from the right, one column added at a time: a scan along a
    # short innermost dimension of 11M rows is slow on the card
    acc = Bhi[:, -1]
    cols = [acc]
    for j in range(Bhi.shape[1] - 2, 0, -1):
        acc = acc + Bhi[:, j]
        cols.append(acc)
    return torch.stack(cols[::-1], dim=1)


def _nanquantile(v: torch.Tensor, qs: np.ndarray) -> torch.Tensor:
    """``jnp.nanquantile(v, qs)`` (linear interpolation) in float32: the
    non-missing values sorted once, positions q·(n - 1)."""
    vals = torch.sort(v[~torch.isnan(v)]).values
    n = vals.shape[0]
    q = torch.as_tensor(np.asarray(qs, np.float32)).to(v.device)
    pos = q * float(np.float32(n - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_i = torch.clamp(low, 0, n - 1).long()
    hi_i = torch.clamp(high, 0, n - 1).long()
    return vals[lo_i] * lw + vals[hi_i] * hw


def _imputed(frame: Frame, col: str, mean: float) -> torch.Tensor:
    """The column with its missing values replaced by its training mean
    (in float32)."""
    v = frame.vec(col).as_float()
    return torch.where(torch.isnan(v), float(np.float32(mean)), v)


def _entry_name(entry) -> str:
    return "_".join(entry) if isinstance(entry, (list, tuple)) else entry


class GAMModel(Model):
    algo = "gam"

    def _expand(self, frame: Frame):
        """The frame with each gam entry's basis columns added (named
        ``<entry>_gam_<i>``), and those names."""
        o = self.output
        names, vecs = [], []
        for entry, bs in zip(o["gam_columns"], o["bs"]):
            nm = _entry_name(entry)
            if isinstance(entry, (list, tuple)):     # 2-D thin plate
                xs = [_imputed(frame, c, o["col_means"][c]) for c in entry]
                B = _tp_basis_2d(xs[0], xs[1], np.asarray(o["knots"][nm]))
            else:
                x = _imputed(frame, entry, o["col_means"][entry])
                kn = o["knots"][nm]
                if bs == 1:
                    B = _tp_basis_1d(x, torch.as_tensor(
                        np.asarray(kn, np.float32)).to(x.device))
                elif bs == 2:
                    B = _ispline_basis(x, np.asarray(kn))
                else:
                    B = _ncs_basis(x, torch.as_tensor(
                        np.asarray(kn, np.float32)).to(x.device))
            # one [k, rows] block: each basis column a contiguous row
            Bt = B.T.contiguous()
            for i in range(Bt.shape[0]):
                names.append(f"{nm}_gam_{i}")
                vecs.append(Vec(Bt[i], VecType.NUM))
        return Frame(list(frame.names) + names, list(frame.vecs) + vecs), \
            names

    def _score_raw(self, frame: Frame):
        expanded, _ = self._expand(frame)
        return self.output["glm"]._score_raw(expanded)

    def coef(self):
        return self.output["glm"].coef()


class GAM(ModelBuilder):
    """h2o-py surface: ``H2OGeneralizedAdditiveEstimator``."""

    algo = "gam"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            gam_columns=None,            # str entries, or [c1, c2] (tp)
            bs=None,                     # per entry: 0 cr, 1 tp, 2 is
            num_knots=5,
            knot_ids=None,               # {entry: [user knots]}
            splines_non_negative=True,   # bs=2: monotone increasing
            family="AUTO",
            lambda_=0.0,
            alpha=0.0,
            scale=1e-4,                  # the smoothness ridge, added to
            #                              lambda_ as uniform L2
            standardize=True,
            max_iterations=50,
        )

    def _select_knots(self, frame, entry, k: int, user_knots):
        """Quantile knots (the reference's ``GamUtils.
        generateKnotsFromKeys``); ``knot_ids`` overrides them."""
        nm = _entry_name(entry)
        if user_knots and nm in user_knots:
            kn = np.asarray(user_knots[nm], np.float64)
            if kn.ndim == 1 and isinstance(entry, (list, tuple)):
                raise ValueError(f"thin-plate entry {nm} needs 2-D knots")
            return kn.astype(np.float32)
        if isinstance(entry, (list, tuple)):
            # knots are strided data points of the complete rows (one NaN
            # knot would poison every radial)
            pts = torch.stack([frame.vec(c).as_float() for c in entry], 1)
            rows = torch.nonzero(~torch.isnan(pts).any(1)).flatten()
            if rows.numel() < k:
                raise ValueError(f"thin-plate entry {nm}: only "
                                 f"{rows.numel()} complete rows for {k} "
                                 "knots")
            idx = np.linspace(0, rows.numel() - 1, k).astype(np.int64)
            take = rows[torch.as_tensor(idx).to(rows.device)]
            return pts[take].cpu().numpy().astype(np.float32)
        qs = _nanquantile(frame.vec(entry).as_float(),
                          np.linspace(0.02, 0.98, k))
        kn = np.unique(qs.cpu().numpy().astype(np.float64))
        if len(kn) < 3:
            raise ValueError(f"gam column {entry!r} has too few distinct "
                             "values")
        return kn.astype(np.float32)

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> GAMModel:
        self._refuse_checkpoint()
        p = self.params
        gam_cols = p["gam_columns"]
        if not gam_cols:
            raise ValueError("gam_columns is required")
        bs = list(p["bs"]) if p.get("bs") else [0] * len(gam_cols)
        if len(bs) != len(gam_cols):
            raise ValueError("bs must have one entry per gam column")
        for entry, b in zip(gam_cols, bs):
            names = entry if isinstance(entry, (list, tuple)) else [entry]
            if isinstance(entry, (list, tuple)):
                if int(b) != 1:
                    raise ValueError("multi-column gam entries require "
                                     "bs=1 (thin plate)")
                if len(entry) != 2:
                    raise ValueError("thin-plate smooths support 1 or 2 "
                                     "predictors here")
            for c in names:
                if frame.vec(c).is_categorical:
                    raise ValueError(f"gam column {c!r} must be numeric")
            if int(b) not in (0, 1, 2):
                raise ValueError(f"bs={b} unknown (0=cr, 1=tp, 2=is)")

        k = int(p["num_knots"])
        if k < 3:
            raise ValueError("num_knots must be >= 3")
        knots, flat_cols = {}, []
        for entry in gam_cols:
            flat_cols.extend(entry if isinstance(entry, (list, tuple))
                             else [entry])
            knots[_entry_name(entry)] = self._select_knots(
                frame, entry, k, p.get("knot_ids"))
        # every gam column's mean in one fetch
        means = torch.stack([torch.nanmean(frame.vec(c).as_float())
                             for c in flat_cols]).cpu().numpy()
        col_means = {c: float(m) for c, m in zip(flat_cols, means)}

        model_stub = GAMModel(key="_tmp", params=self.params,
                              response_column=y, response_domain=None,
                              output=dict(gam_columns=gam_cols, bs=bs,
                                          knots=knots, col_means=col_means))
        expanded, gam_names = model_stub._expand(frame)

        # bs=2 monotonicity: non-negative I-spline coefficients through
        # the GLM's box constraints (reference: splines_non_negative)
        constraints = None
        if any(int(b) == 2 for b in bs) and bool(p["splines_non_negative"]):
            constraints = {}
            for entry, b in zip(gam_cols, bs):
                if int(b) != 2:
                    continue
                nm = _entry_name(entry)
                for gname in gam_names:
                    if gname.startswith(f"{nm}_gam_"):
                        constraints[gname] = (0.0, None)

        keep_x = [c for c in x if c not in flat_cols]
        lam = float(p["lambda_"]) + float(p["scale"])   # smoothness as ridge
        glm = GLM(family=p["family"], lambda_=lam, alpha=float(p["alpha"]),
                  standardize=bool(p["standardize"]),
                  beta_constraints=constraints,
                  max_iterations=int(p["max_iterations"])) \
            .train(x=keep_x + gam_names, y=y, training_frame=expanded,
                   weights=weights)
        job.update(1.0, "glm on spline basis done")

        yvec = frame.vec(y)
        return GAMModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(gam_columns=gam_cols, bs=bs, knots=knots,
                        col_means=col_means, glm=glm, gam_names=gam_names))
