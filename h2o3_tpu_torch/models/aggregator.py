"""Aggregator — the port of ``h2o3_tpu/models/aggregator.py``.

The frame is reduced to exemplar rows that cover it, each with the count
of the rows nearest to it (reference: ``hex/aggregator/Aggregator.java``).
As in the JAX package, exemplars come from a farthest-point sweep over
the expanded design: a first row drawn at random, then, one at a time,
the row farthest from every exemplar so far, until
``target_num_exemplars`` or until every row coincides with an exemplar.
Each row is then assigned to its nearest exemplar.

The sweep keeps each row's distance to the nearest exemplar on the device
and issues no host sync inside a chunk of :data:`SWEEP_CHUNK` exemplars:
a chunk's picks and their distances come back in one fetch, and the
picks after the first zero distance are dropped, so the exemplars are
those of a sweep that stops there. The assignment is blocked by rows
(:data:`ASSIGN_BLOCK_ELEMS` distances at a time), where the JAX package
builds the whole [rows, exemplars] matrix: each row's argmin, the first
index on ties, is the same either way.

Distances are summed in float64 (the float32 differences squared exactly,
then added), where the JAX package sums in float32: float32 sums taken in
another order (the CPU's and the card's reductions) round differently,
and a farthest-point sweep follows any flip of a near-tie. In float64 the
CPU and the card pick the same rows, and the picks equal the JAX
package's wherever its float32 sums order the rows alike.
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
from h2o3_tpu_torch.rapids.munge import gather_rows

#: exemplars picked on the device between two host fetches
SWEEP_CHUNK = 256
#: distances held at once by the blocked assignment (float64 elements)
ASSIGN_BLOCK_ELEMS = 1 << 25


def _first_exemplar(mask: torch.Tensor, seed: int) -> int:
    """The first exemplar: the included row (``mask``) with the largest
    uniform draw of a ``torch.Generator`` seeded with ``seed``. The JAX
    package draws from its own stream; tests hand its row in here."""
    gen = torch.Generator(device=mask.device).manual_seed(seed)
    r = torch.rand(mask.shape[0], generator=gen, device=mask.device)
    return int(torch.argmax(torch.where(mask, r, -1.0)))


def _dist(X: torch.Tensor, row: torch.Tensor, mask: torch.Tensor):
    """[rows] float64 Euclidean distance of each included row to X[row]
    (-inf for excluded rows), from the float32 differences as the JAX
    package takes them; ``row`` is a 0-d tensor, read without a host
    sync."""
    d = X - X.index_select(0, row.view(1))
    return torch.where(mask, torch.linalg.vector_norm(d, dim=1,
                                                      dtype=torch.float64),
                       -torch.inf)


def farthest_point_sweep(X: torch.Tensor, mask: torch.Tensor, first: int,
                         target: int, chunk: int = SWEEP_CHUNK
                         ) -> tuple[np.ndarray, int]:
    """Exemplar rows of the farthest-point sweep from ``first``: at most
    ``target``, stopping where the farthest row is at distance 0. Returns
    (rows, host fetches)."""
    dev = X.device
    d2 = _dist(X, torch.tensor(first, device=dev), mask)
    rows = [first]
    fetches = 0
    while len(rows) < target:
        m = min(chunk, target - len(rows))
        picks = torch.empty(m, dtype=torch.float64, device=dev)
        dists = torch.empty(m, dtype=torch.float64, device=dev)
        for i in range(m):
            nxt = torch.argmax(d2)
            picks[i] = nxt
            dists[i] = d2.index_select(0, nxt.view(1))[0]
            d2 = torch.minimum(d2, _dist(X, nxt, mask))
        got = torch.stack([picks, dists]).cpu().numpy()
        fetches += 1
        stop = np.flatnonzero(got[1] <= 0)
        keep = int(stop[0]) if stop.size else m
        rows += got[0, :keep].astype(np.int64).tolist()
        if stop.size:
            break
    return np.asarray(rows, np.int64), fetches


def nearest_exemplar(X: torch.Tensor, E: torch.Tensor,
                     block_elems: int = ASSIGN_BLOCK_ELEMS) -> torch.Tensor:
    """[rows] index of each row's nearest exemplar by
    |x|² + |e|² − 2 x·e in float64, computed in blocks of rows."""
    E = E.double()
    e2 = (E * E).sum(1)[None, :]
    rows = max(1, block_elems // max(E.shape[0], 1))
    out = torch.empty(X.shape[0], dtype=torch.long, device=X.device)
    for a in range(0, X.shape[0], rows):
        Xb = X[a:a + rows].double()
        d = (Xb * Xb).sum(1, keepdim=True) + e2 - 2.0 * (Xb @ E.T)
        out[a:a + rows] = torch.argmin(d, dim=1)
    return out


class AggregatorModel(Model):
    algo = "aggregator"

    def _score_raw(self, frame: Frame):
        raise NotImplementedError("Aggregator produces an output frame; use "
                                  "aggregated_frame")

    def model_performance(self, frame: Frame):
        return None

    @property
    def aggregated_frame(self) -> Frame:
        return self.output["output_frame"]


class Aggregator(ModelBuilder):
    """h2o-py surface: ``H2OAggregatorEstimator``."""

    algo = "aggregator"
    unsupervised = True

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            target_num_exemplars=100,
            rel_tol_num_exemplars=0.5,    # the reference leaves it unapplied
            transform="NORMALIZE",        # any but NONE standardises
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> AggregatorModel:
        p = self.params
        self._refuse_checkpoint()
        if p["rel_tol_num_exemplars"] != 0.5:
            raise ValueError("rel_tol_num_exemplars is not applied (the "
                             "reference leaves it unapplied)")
        di = DataInfo.make(frame, x, standardize=p["transform"] != "NONE",
                           use_all_factor_levels=True)
        X = di.expand(frame)
        mask = weights > 0
        target = min(int(p["target_num_exemplars"]), frame.nrows)
        first = _first_exemplar(mask, int(p.get("seed") or 0) or 11)
        exemplars, fetches = farthest_point_sweep(X, mask, first, target)
        job.update(0.8, f"{len(exemplars)} exemplars")
        ex_dev = torch.as_tensor(exemplars, device=frame.device)
        assign = nearest_exemplar(X, X[ex_dev])
        del X
        counts = torch.zeros(len(exemplars), dtype=torch.float32,
                             device=frame.device)
        counts.index_add_(0, assign, mask.float())
        out = gather_rows(frame, ex_dev)
        out = Frame(out.names + ["counts"],
                    out.vecs + [Vec(counts, VecType.NUM)])
        job.update(1.0, f"{len(exemplars)} exemplars")
        return AggregatorModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=None, response_domain=None, data_info=di,
            output=dict(output_frame=out, exemplar_rows=exemplars,
                        exemplar_assignment=assign, counts=counts,
                        sweep_fetches=fetches))
