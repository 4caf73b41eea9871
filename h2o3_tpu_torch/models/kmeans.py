"""KMeans — Lloyd iterations with Random, PlusPlus, Furthest and User
initialisation — the port of ``h2o3_tpu/models/kmeans.py`` (reference:
``hex/kmeans/KMeans.java``, metrics ``hex/ModelMetricsClustering.java``).

A Lloyd step is two products on the design of :class:`DataInfo`: the
[rows, k] squared distances in the reference's ``|x|² − 2X·Cᵀ + |c|²``
form (not ``torch.cdist``, so that assignments agree at the same float32
cancellation) and the per-cluster sums ``onehot(assign)ᵀ·X``. The host
reads one number an iteration, the within-cluster sum of squares, for the
stop rule. The random inits draw from one ``torch.Generator`` on the
frame's device, seeded from ``seed``; ``estimate_k`` and Furthest after its
first row are deterministic.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key

#: the seed of a fit whose ``seed`` is unset (the reference's)
DEFAULT_SEED = 1234


def _sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[rows, k] squared distances (rows of weight 0 too)."""
    x2 = (X * X).sum(dim=1, keepdim=True)
    c2 = (C * C).sum(dim=1)[None, :]
    return torch.clamp_min(x2 - 2.0 * (X @ C.T) + c2, 0.0)


def _lloyd_step(X, w, C):
    """One Lloyd iteration: (new centers, within-SS, assignment counts).
    An empty cluster keeps its center."""
    d2 = _sq_dists(X, C)
    mind2, assign = d2.min(dim=1)
    wss = (w * mind2).sum()
    onehot = (assign[:, None] == torch.arange(C.shape[0], device=X.device)
              [None, :]).to(X.dtype) * w[:, None]
    sums = onehot.T @ X
    counts = onehot.sum(dim=0)
    newC = torch.where(counts[:, None] > 0,
                       sums / torch.clamp_min(counts[:, None], 1e-12), C)
    return newC, wss, counts


def _assign(X, C):
    """(nearest center, its squared distance) per row."""
    d2 = _sq_dists(X, C)
    return d2.argmin(dim=1), d2.amin(dim=1)


def _weighted_row_choice(gen: torch.Generator, p, w) -> torch.Tensor:
    """A row index drawn with probability proportional to p·w (rows of
    weight 0 at 1e-30, as the reference's logits floor them)."""
    return torch.multinomial(torch.clamp_min(p * w, 1e-30), 1,
                             generator=gen)[0]


def _furthest(X, w, C) -> torch.Tensor:
    """The row of positive weight furthest from its nearest center (the
    first such row at a tie)."""
    d2 = _sq_dists(X, C).amin(dim=1)
    return torch.where(w > 0, d2, -torch.inf).argmax()


def _row(X, idx) -> torch.Tensor:
    """[1, cols]: the row at a device index (no host sync)."""
    return X.index_select(0, idx.reshape(1))


class KMeansModel(Model):
    algo = "kmeans"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        X = self.data_info.expand(frame)
        return _assign(X, self.output["centers_std"])[0].float()

    def predict(self, frame: Frame) -> Frame:
        assign = self._score_raw(frame).to(torch.int32)
        # estimate_k may settle on fewer clusters than params["k"]
        dom = tuple(str(i) for i in range(self.output["centers_std"].shape[0]))
        return Frame(["predict"], [Vec.from_device(assign, VecType.CAT,
                                                   domain=dom)])

    def model_performance(self, frame: Frame):
        return None

    def centers(self) -> np.ndarray:
        """De-standardised centers (reference: ``_centers_raw``)."""
        return np.asarray(self.output["centers"])

    def tot_withinss(self) -> float:
        return float(self.output["tot_withinss"])

    def betweenss(self) -> float:
        return float(self.output["betweenss"])

    def totss(self) -> float:
        return float(self.output["totss"])


class KMeans(ModelBuilder):
    """h2o-py surface: ``H2OKMeansEstimator``."""

    algo = "kmeans"
    unsupervised = True

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            k=1,
            max_iterations=10,
            init="Furthest",          # Random | PlusPlus | Furthest | User
            user_points=None,
            standardize=True,
            estimate_k=False,
        )

    def _init_centers(self, gen, X, w, k: int, mode: str) -> torch.Tensor:
        n, K = X.shape
        if mode == "user":
            pts = np.asarray(self.params["user_points"], np.float32)
            if pts.shape != (k, K):
                raise ValueError(f"user_points must be [{k}, {K}] in the "
                                 f"expanded column layout, got {pts.shape}")
            # the points are on the raw scale: the numeric block moves into
            # the standardised space of the data
            di = self._di
            nnum = len(di.num_cols)
            if nnum:
                s = di.ncats_expanded
                pts = pts.copy()
                pts[:, s:s + nnum] = (pts[:, s:s + nnum] - di.num_sub) \
                    * di.num_mul
            return torch.as_tensor(pts).to(X.device)
        if mode == "random":
            idx = torch.multinomial(w / w.sum(), k, replacement=False,
                                    generator=gen)
            return X[idx]
        if mode not in ("plusplus", "furthest"):
            raise ValueError(f"unknown init {self.params['init']!r}")
        # greedy seeding, one pass a center (reference: KMeans.java
        # Initialization.PlusPlus / Furthest)
        C = _row(X, _weighted_row_choice(gen, torch.ones_like(w), w))
        for _ in range(1, k):
            if mode == "furthest":
                nxt = _furthest(X, w, C)
            else:
                d2 = _sq_dists(X, C).amin(dim=1)
                nxt = _weighted_row_choice(gen, d2, w)
            C = torch.cat([C, _row(X, nxt)])
        return C

    def _run_lloyd(self, job: Job, X, w, C) -> tuple:
        """Lloyd to convergence: (centers, tot_withinss, iterations); one
        host fetch an iteration."""
        wss_v, wss_prev, iters = np.inf, np.inf, 0
        self._wss_series = []
        max_it = max(int(self.params["max_iterations"]), 1)
        for it in range(max_it):
            C, wss, _ = _lloyd_step(X, w, C)
            wss_v = float(wss)
            self._wss_series.append(wss_v)
            iters = it + 1
            job.update(iters / max_it,
                       f"k={C.shape[0]} iter {iters} within-SS {wss_v:.4f}")
            if np.isfinite(wss_prev) and \
                    abs(wss_prev - wss_v) <= 1e-7 * max(wss_prev, 1.0):
                break
            wss_prev = wss_v
        return C, wss_v, iters

    def _scoring_history(self, model):
        """Per-Lloyd-iteration rows (reference: ``KMeans.java`` scoring
        history: iterations / within_cluster_sum_of_squares)."""
        return self._history_table(
            model,
            [("iterations", "long", "%d"),
             ("within_cluster_sum_of_squares", "double", "%.5f")],
            [[i + 1, v] for i, v in enumerate(self._wss_series)])

    def _estimate_k(self, job: Job, X, w, k_max: int) -> tuple:
        """Grow from k = 1, adding the furthest row as a center while the
        relative within-SS gain beats min(0.02 + 10/rows + 2.5/P², 0.8)
        (reference: ``KMeans.java:284-420``)."""
        wsum = w.sum()
        nrows = max(float(wsum), 1.0)
        cutoff = min(0.02 + 10.0 / nrows + 2.5 / max(X.shape[1], 1) ** 2, 0.8)
        C = ((w[:, None] * X).sum(dim=0) / torch.clamp_min(wsum, 1e-12))[None]
        C, wss_best, iters = self._run_lloyd(job, X, w, C)
        accepted = list(self._wss_series)
        for _ in range(2, k_max + 1):
            cand = torch.cat([C, _row(X, _furthest(X, w, C))])
            cand, wss_now, it2 = self._run_lloyd(job, X, w, cand)
            if (wss_best - wss_now) / max(wss_best, 1e-30) < cutoff:
                break
            C, wss_best, iters = cand, wss_now, it2
            accepted = list(self._wss_series)
        # the scoring history describes the accepted run, not the rejected
        # candidate that ended the loop
        self._wss_series = accepted
        return C, iters

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> KMeansModel:
        p = self.params
        self._refuse_checkpoint()
        k = int(p["k"])
        if k < 1:
            raise ValueError("k must be >= 1")
        di = DataInfo.make(frame, x, standardize=p["standardize"],
                           use_all_factor_levels=True)
        self._di = di
        X = di.expand(frame)
        w = weights
        seed = int(p.get("seed") or -1)
        gen = torch.Generator(device=X.device).manual_seed(
            seed if seed >= 0 else DEFAULT_SEED)
        if bool(p["estimate_k"]):
            if p["user_points"] is not None:
                raise ValueError("Cannot estimate k if user_points are "
                                 "provided.")
            C, iters = self._estimate_k(job, X, w, k)
            k = C.shape[0]
        else:
            C = self._init_centers(gen, X, w, k, str(p["init"]).lower())
            C, _, iters = self._run_lloyd(job, X, w, C)

        assign, d2 = _assign(X, C)
        gm = (w[:, None] * X).sum(dim=0) / torch.clamp_min(w.sum(), 1e-12)
        counts = ((assign[:, None] == torch.arange(k, device=X.device)[None])
                  * w[:, None]).sum(dim=0)
        tot_within, totss = torch.stack([
            (w * d2).sum(),
            (w * ((X - gm[None, :]) ** 2).sum(dim=1)).sum()]).tolist()
        C_host = C.cpu().numpy().astype(np.float64)
        centers_raw = C_host.copy()
        nnum = len(di.num_cols)
        if nnum:
            s = di.ncats_expanded
            centers_raw[:, s:s + nnum] = C_host[:, s:s + nnum] / di.num_mul \
                + di.num_sub
        return KMeansModel(
            key=make_model_key(self.algo, self.model_id), params=p,
            response_column=None, response_domain=None,
            output=dict(centers_std=C, centers=centers_raw,
                        tot_withinss=tot_within, totss=totss,
                        betweenss=totss - tot_within,
                        size=counts.cpu().numpy(), iterations=iters,
                        coef_names=di.coef_names),
            data_info=di)
