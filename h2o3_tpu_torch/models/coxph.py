"""Cox proportional hazards — the port of ``h2o3_tpu/models/coxph.py``
(reference: ``hex/coxph/CoxPH.java``: risk-set sums, Newton steps with
step halving, Efron or Breslow ties).

Rows are sorted once by stop time, descending, on the device, so every
risk set is a prefix: a risk sum is a cumsum read at the last row of its
tie group. The tie groups, and each event's rank among its group's events
(Efron's correction), come from the sorted times without a loop over
groups (:func:`_tie_ranks`). The reference takes the gradient and Hessian
of the partial log-likelihood by ``jax.grad``/``jax.hessian``; here they are
written out from the same cumsums (:func:`_cox_derivatives`, in float64):
the Hessian's risk-set terms reduce to one weighted Gram X'diag(u)X, so no
[rows, P, P] tensor exists. Each Newton iteration fetches the [P] gradient
and [P, P] Hessian once and solves on the host in float64, as the
reference does, and each step-halving trial fetches the log-likelihood.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import DataInfo, response_as_float
from h2o3_tpu_torch.models.glm import full_fp32
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _tie_groups(ts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tie-group id per row of times sorted descending (0 = the latest
    time) and each group's last row."""
    _, group, counts = torch.unique_consecutive(ts, return_inverse=True,
                                                return_counts=True)
    return group, torch.cumsum(counts, 0) - 1


def _tie_ranks(group: torch.Tensor, event: torch.Tensor, n_groups: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each event's 0-based rank among its tie group's events (in row
    order) and the group's event count; 0 and 0 on rows without an event.
    Rows of a group are contiguous: a rank is the events counted up to
    the row less those before its group."""
    ev = (event > 0).to(torch.int64)
    seen = torch.cumsum(ev, 0)                       # events up to the row
    per_group = torch.zeros(n_groups, dtype=torch.int64,
                            device=group.device).index_add_(0, group, ev)
    before = torch.cumsum(per_group, 0) - per_group  # events before a group
    is_ev = ev > 0
    rank = torch.where(is_ev, seen - 1 - before[group], 0)
    tot = torch.where(is_ev, per_group[group], 0)
    return rank.to(torch.float32), tot.to(torch.float32)


def _cox_loglik(beta, X, event, w, group, tie_rank, tie_tot, group_last,
                efron: bool):
    """Partial log-likelihood (float32, the reference's formula); rows
    sorted by stop time descending so the risk set of a time is a prefix.

    group: tie-group id per row (0 = the latest time); group_last: the
    last row of each group; tie_rank/tie_tot: an event's 0-based rank among
    its group's events and the group's event count (Efron)."""
    with full_fp32():
        xb = X @ beta
    exb = w * torch.exp(xb)
    risk = torch.cumsum(exb, 0)                      # suffix sums in time
    # the risk sum at a group's time: the cumsum at the group's last row
    grp_risk = risk[group_last]
    de = w * event
    tied_exb = torch.zeros(group_last.shape[0], dtype=exb.dtype,
                           device=exb.device).index_add_(0, group,
                                                         exb * event)
    if efron:
        denom = grp_risk[group] - (tie_rank / torch.clamp(tie_tot, min=1.0)) \
            * tied_exb[group]
    else:
        denom = grp_risk[group]
    return (de * (xb - torch.log(torch.clamp(denom, min=0.0)))).sum()


def _cox_derivatives(beta, X, event, w, group, tie_rank, tie_tot,
                     group_last, efron: bool):
    """Gradient [P] and Hessian [P, P] of :func:`_cox_loglik` in float64.

    With D_i the denominator of event i, D1_i its gradient and c_i its
    Efron weight (0 for Breslow): grad = sum_i de_i (x_i - D1_i / D_i), and
    -H = X' diag(u) X - D1' diag(de / D^2) D1, where u_j = exb_j (A_g - e_j
    b_g) for row j of group g, A_g the sum of de_i / D_i over the events of
    group g and every later group (their risk sets hold row j), and b_g
    the sum of de_i c_i / D_i over group g's own events."""
    G = group_last.shape[0]
    Xd = X.double()
    ed, wd = event.double(), w.double()
    xb = Xd @ beta.double()
    exb = wd * torch.exp(xb)
    de = wd * ed
    c = (tie_rank / torch.clamp(tie_tot, min=1.0)).double() if efron \
        else torch.zeros_like(xb)
    ex_ev = exb * ed
    zeros_g = lambda *s: torch.zeros((G, *s), dtype=torch.float64,
                                     device=X.device)
    # a group's risk sums: every row of it and of the later groups (the
    # group totals' cumsum; a scan down the rows of [rows, P] is slow)
    risk = torch.cumsum(zeros_g().index_add_(0, group, exb), 0)
    risk1 = torch.cumsum(zeros_g(X.shape[1]).index_add_(
        0, group, exb[:, None] * Xd), 0)                     # [G, P]
    tied0 = zeros_g().index_add_(0, group, ex_ev)
    tied1 = zeros_g(X.shape[1]).index_add_(0, group, ex_ev[:, None] * Xd)
    D = torch.clamp(risk[group] - c * tied0[group], min=1e-300)
    D1 = risk1[group] - c[:, None] * tied1[group]
    r = de / D
    grad = (de[:, None] * Xd).sum(0) - (r[:, None] * D1).sum(0)
    a = zeros_g().index_add_(0, group, r)
    b = zeros_g().index_add_(0, group, r * c)
    # groups run from the latest time: row j's group g lies in the risk
    # sets of groups g, g+1, ..., the earlier times
    A = torch.flip(torch.cumsum(torch.flip(a, (0,)), 0), (0,))
    u = exb * (A[group] - ed * b[group])
    neg_h = (Xd * u[:, None]).T @ Xd - (D1 * (r / D)[:, None]).T @ D1
    return grad, -neg_h


def _concordance(lp: torch.Tensor, t: torch.Tensor, e: torch.Tensor) -> float:
    """Harrell's concordance over (lp, t, e): for every event row r, each
    row of a strictly later time is a comparable pair, concordant where
    its lp is lower, tied where equal (counting 0.5). The counts are exact
    integers from a merge-sort tree over the rows in time order: the rows
    later than r form a suffix, which splits into at most log2(n) aligned
    blocks, and each level's blocks are sorted once by lp rank."""
    n = lp.shape[0]
    if n < 2:
        return float("nan")
    dev = lp.device
    ranks = torch.searchsorted(torch.unique(lp), lp)     # lp ties: one rank
    R = int(ranks.max()) + 2
    order = torch.argsort(t, stable=True)
    ts, rk, ev = t[order], ranks[order], e[order] > 0
    # the suffix of rows later than each row: from its time group's end
    _, counts = torch.unique_consecutive(ts, return_counts=True)
    ends = torch.cumsum(counts, 0)
    end = torch.repeat_interleave(ends, counts)
    L = max(1, (n - 1).bit_length())
    N = 1 << L
    rk_pad = torch.full((N,), R - 1, dtype=torch.int64, device=dev)
    rk_pad[:n] = rk
    p, q = end[ev], rk[ev]
    lower = torch.zeros_like(p)
    lower_eq = torch.zeros_like(p)
    pos = torch.arange(N, device=dev)
    cur = p.clone()
    for lvl in range(L):
        take = ((cur >> lvl) & 1).bool() & (cur < N)
        if bool(take.any()):
            keys = torch.sort((pos >> lvl) * R + rk_pad).values
            blk = cur[take] >> lvl
            base = blk << lvl                       # the block's first slot
            lower[take] += torch.searchsorted(keys, blk * R + q[take]) - base
            lower_eq[take] += torch.searchsorted(
                keys, blk * R + q[take] + 1) - base
        cur = torch.where(take, cur + (1 << lvl), cur)
    # (no suffix starts at row 0: an event's own group precedes it)
    later = n - p
    conc = int(lower.sum())
    tied = int((lower_eq - lower).sum())
    disc = int((later - lower_eq).sum())
    pairs = float(conc) + float(disc) + float(tied)
    return float((conc + 0.5 * tied) / pairs) if pairs else float("nan")


class CoxPHModel(Model):
    algo = "coxph"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        """Linear predictor lp = (x - x̄)·β (reference: CoxPH scoring emits
        lp)."""
        X = self.data_info.expand(frame)
        mu = torch.as_tensor(np.array(self.output["x_mean"], np.float32)).to(
            X.device)
        with full_fp32():
            return (X - mu[None, :]) @ self.output["coef"]

    def predict(self, frame: Frame) -> Frame:
        return Frame(["lp"], [Vec.from_device(self._score_raw(frame),
                                              VecType.NUM)])

    def model_performance(self, frame: Frame):
        return None

    def concordance(self, frame: Frame | None = None) -> float:
        """Harrell's concordance index (reference: ``hex/coxph/
        CoxPH.java:737``): the share of comparable pairs (t_i < t_j with
        event_i = 1) whose higher linear predictor has the shorter
        survival, ties in lp counting 0.5; on the training rows, or on a
        frame's rows with a finite time and lp and a valid event."""
        dev = self.output["coef"].device
        if frame is not None:
            lp = self._score_raw(frame).double()
            t = frame.vec(self.params["stop_column"]).as_float().double()
            ev, okv = response_as_float(frame.vec(self.response_column))
            ok = okv & torch.isfinite(t) & torch.isfinite(lp)
            lp, t, e = lp[ok], t[ok], ev.double()[ok]
        else:
            o = self.output
            lp, t, e = (torch.as_tensor(np.asarray(o[k], np.float64)).to(dev)
                        for k in ("train_lp", "train_time", "train_event"))
        return _concordance(lp, t, e)

    def coefficients(self) -> dict[str, float]:
        names = self.output["coef_names"]
        return dict(zip(names, self.output["coef"].cpu().numpy().tolist()))

    def hazard_ratios(self) -> dict[str, float]:
        return {k: float(np.exp(v)) for k, v in self.coefficients().items()}

    def baseline_hazard(self) -> Frame:
        """Breslow cumulative baseline hazard H0(t) at the covariate mean
        (reference: CoxPHModel's baseline hazard table / R ``survfit``)."""
        dev = self.output["coef"].device
        return Frame(["t", "cumhaz"], [
            Vec.from_numpy(np.asarray(self.output[k], np.float32),
                           VecType.NUM, device=dev)
            for k in ("baseline_times", "baseline_cumhaz")])

    def predict_survival(self, frame: Frame, times) -> Frame:
        """S(t | x) = exp(-H0(t) · exp(lp)) per row for each requested time
        (the survfit curve at new data)."""
        lp = self._score_raw(frame).cpu().numpy()
        bt = np.asarray(self.output["baseline_times"])
        bh = np.asarray(self.output["baseline_cumhaz"])
        names, vecs = [], []
        for t in np.atleast_1d(times):
            idx = np.searchsorted(bt, float(t), side="right") - 1
            h0 = bh[idx] if idx >= 0 else 0.0
            s = np.exp(-h0 * np.exp(lp))
            names.append(f"S_{t:g}")
            vecs.append(Vec.from_numpy(s.astype(np.float32), VecType.NUM,
                                       device=frame.device))
        return Frame(names, vecs)


class CoxPH(ModelBuilder):
    """h2o-py surface: ``H2OCoxProportionalHazardsEstimator``; ``y`` is the
    event (0/1) column, ``stop_column`` the time."""

    algo = "coxph"
    supports_classification = False

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            stop_column=None,      # event-time column (required)
            ties="efron",          # efron | breslow
            max_iterations=20,
            lre=9.0,               # log-relative-error convergence
        )

    def train(self, x=None, y=None, training_frame=None, **kw):
        if self.params.get("stop_column") is None:
            raise ValueError("stop_column (event time) is required")
        saved = self.params.get("ignored_columns")
        self.params["ignored_columns"] = list(saved or []) + \
            [self.params["stop_column"]]
        try:
            return super().train(x=x, y=y, training_frame=training_frame,
                                 **kw)
        finally:
            self.params["ignored_columns"] = saved

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> CoxPHModel:
        self._refuse_checkpoint()
        p = self.params
        ties = str(p["ties"]).lower()
        if ties not in ("efron", "breslow"):
            raise ValueError(f"ties={p['ties']!r}: efron or breslow")
        efron = ties == "efron"
        times = frame.vec(p["stop_column"]).as_float()
        evt, evt_valid = response_as_float(frame.vec(y))
        di = DataInfo.make(frame, x, standardize=False)
        X = di.expand(frame)
        P = X.shape[1]

        w = weights * evt_valid * ~torch.isnan(times)
        keep = torch.nonzero(w > 0).flatten()
        if keep.numel() == 0:
            raise ValueError("no usable rows")
        # kept rows by time DESCENDING (risk sets become prefixes)
        order = keep[torch.argsort(-times[keep], stable=True)]
        ts = times[order]
        Xs = X[order]
        del X
        es = torch.where(w > 0, evt, 0.0)[order]
        ws = w[order]
        group, group_last = _tie_groups(ts)
        n_groups = group_last.shape[0]
        tie_rank, tie_tot = _tie_ranks(group, es, n_groups)
        args = (Xs, es, ws, group, tie_rank, tie_tot, group_last, efron)

        def ll(b) -> float:
            return float(_cox_loglik(b, *args))

        def grad_hess(b):
            g, H = _cox_derivatives(b, *args)
            gh = torch.cat([g, H.flatten()]).cpu().numpy()
            return gh[:P], gh[P:].reshape(P, P)

        beta = torch.zeros(P, dtype=torch.float32, device=Xs.device)
        ll_prev = ll(beta)
        ll_new = ll_prev
        iters = 0
        max_it = max(int(p["max_iterations"]), 1)
        for it in range(max_it):
            g, H = grad_hess(beta)
            try:
                step = np.linalg.solve(H - 1e-9 * np.eye(P), g)
            except np.linalg.LinAlgError:
                step = np.linalg.lstsq(H, g, rcond=None)[0]
            # Newton with step halving (reference: CoxPH.java)
            for _ in range(10):
                cand = beta - torch.as_tensor(step.astype(np.float32)).to(
                    beta.device)
                ll_new = ll(cand)
                if np.isfinite(ll_new) and ll_new >= ll_prev - 1e-12:
                    break
                step = step * 0.5
            beta = cand
            iters = it + 1
            job.update(iters / max_it, f"iter {iters} loglik {ll_new:.6f}")
            if abs(ll_new - ll_prev) <= 10.0 ** (-float(p["lre"])) \
                    * max(abs(ll_prev), 1.0):
                ll_prev = ll_new
                break
            ll_prev = ll_new

        _, H = grad_hess(beta)
        try:
            cov = np.linalg.inv(-H)
            se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        except np.linalg.LinAlgError:
            se = np.full(P, np.nan)
        x_mean_d = (ws[:, None] * Xs).sum(0) / torch.clamp(ws.sum(),
                                                           min=1e-30)
        with full_fp32():
            lp = (Xs - x_mean_d[None, :]) @ beta
        # one fetch of the per-row columns the host tables need
        rs, wev, ts_h, es_h, lp_h = torch.stack([
            torch.exp(lp) * ws, es * ws, ts, es, lp]).cpu().numpy()
        group_h = group.cpu().numpy()
        x_mean = x_mean_d.cpu().numpy()

        # Breslow cumulative baseline hazard at the covariate mean:
        # dH0(t) = sum(w_i : event at t) / sum(w_j exp((x_j - x̄)β) : t_j >= t)
        risk_prefix = np.cumsum(rs)          # float32, as the reference
        last = group_last.cpu().numpy()
        first = np.concatenate([[0], last[:-1] + 1])
        d = np.bincount(group_h, weights=wev, minlength=n_groups)
        denom = risk_prefix[last]
        inc = np.where((d > 0) & (denom > 0), d / np.maximum(denom, 1e-30),
                       0.0)
        bh_t = ts_h[first][::-1]                       # ascending time
        bh_h = np.cumsum(inc[::-1])

        return CoxPHModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, data_info=di, response_column=y,
            response_domain=None,
            output=dict(coef=beta, se_coef=se, loglik=ll_prev,
                        iterations=iters, coef_names=di.coef_names,
                        x_mean=x_mean,
                        baseline_times=np.asarray(bh_t, np.float64),
                        baseline_cumhaz=np.asarray(bh_h, np.float64),
                        n=int(keep.numel()), n_events=int(es_h.sum()),
                        # the training triplet of the concordance, sorted
                        # by descending time
                        train_lp=np.asarray(lp_h, np.float64),
                        train_time=np.asarray(ts_h, np.float64),
                        train_event=np.asarray(es_h, np.float64)))
