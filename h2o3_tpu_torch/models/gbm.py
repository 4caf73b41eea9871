"""GBM — gradient boosting on the histogram tree engine — the port of
``h2o3_tpu/models/gbm.py`` for the bernoulli and gaussian distributions.

Each round computes the loss gradient at the current margins, grows one
tree on it (:func:`h2o3_tpu_torch.models.tree._grow_tree_device`) and adds
``learn_rate`` times each row's leaf to the margins, in the reference's
tree-for-tree order ``Fcur + lr * row_leaf``. The reference runs the rounds
as one compiled ``lax.scan`` cut into chunks that keep a TPU watchdog happy;
here they are a Python loop whose device work is enqueued without a host
sync. Multinomial and the other distributions, DRF, row and column sampling,
early stopping, scoring history, checkpoints, calibration, offsets and
categorical group splits are left for later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import response_as_float
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key
from h2o3_tpu_torch.models.tree import Tree, TreeParams, grow_tree, predict_raw
from h2o3_tpu_torch.ops.quantile import bin_column, bin_dtype, compute_bin_edges

DISTRIBUTIONS = ("bernoulli", "gaussian")


def tree_matrix(frame: Frame, cols: list[str],
                domains: dict[str, tuple]) -> torch.Tensor:
    """[rows, F] raw float32 feature matrix; categorical codes are mapped
    onto the training domain (a level unseen in training is missing)."""
    arrs = []
    for c in cols:
        v = frame.vec(c)
        dom = domains.get(c)
        if v.is_categorical and dom and v.domain != dom:
            pos = {s: i for i, s in enumerate(dom)}
            lut = torch.tensor([pos.get(s, -1) for s in v.domain] + [-1],
                               dtype=torch.int32, device=v.device)
            codes = lut[torch.where(v.data < 0, len(v.domain), v.data).long()]
            arrs.append(torch.where(codes < 0, torch.nan, codes.float()))
        else:
            arrs.append(v.as_float())
    return torch.stack(arrs, dim=1)


def _grad_hess(dist: str, F: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Per-row (g, h) of the loss at margins F (reference: the
    ``hex/Distribution.java`` families)."""
    if dist == "bernoulli":
        p = torch.sigmoid(F)
        return w * (p - y), w * torch.clamp(p * (1 - p), min=1e-10)
    if dist == "gaussian":
        return w * (F - y), w
    raise NotImplementedError(f"distribution {dist!r} is not ported yet")


class GBMModel(Model):
    algo = "gbm"

    def _tree_raw_sum(self, frame: Frame) -> torch.Tensor:
        if not self.output["trees"]:
            return torch.zeros(frame.nrows, dtype=torch.float32,
                               device=frame.device)
        X = tree_matrix(frame, self.output["x_cols"], self.output["feat_domains"])
        return predict_raw(X, self.output["trees"])

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        f = self.output["f0"] + self.output["learn_rate"] * self._tree_raw_sum(frame)
        if self.output["distribution"] == "bernoulli":
            p = torch.sigmoid(f)
            return torch.stack([1 - p, p], dim=1)
        return f


class SharedTreeBuilder(ModelBuilder):
    """Training code common to the tree models (reference:
    hex/tree/SharedTree.java)."""

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), ntrees=50, max_depth=5, min_rows=10.0,
                    nbins=64, min_split_improvement=1e-5)

    # dense-heap trees cap depth at 16 (2^17 nodes)
    MAX_TREE_DEPTH = 16

    def _prepare(self, frame: Frame, x: list[str], y: str, weights):
        """Bin edges from a strided sample of at most ~100k rows, the binned
        training matrix, and the response with its validity mask."""
        depth = int(self.params["max_depth"])
        if depth > self.MAX_TREE_DEPTH:
            raise ValueError(f"max_depth={depth} exceeds the dense-heap limit "
                             f"{self.MAX_TREE_DEPTH}")
        cats = [c for c in x if frame.vec(c).is_categorical]
        if cats:
            raise NotImplementedError(
                f"categorical predictors {cats} need group splits, which the "
                "port does not have yet")
        nrows = frame.nrows
        stride = max(1, nrows // 100_000)
        idx = torch.arange(0, nrows, stride, device=frame.device)
        sample = torch.stack([frame.vec(c).as_float()[idx] for c in x],
                             dim=1).cpu().numpy()
        # weighted edges keep the weights-as-replication contract
        w_sample = weights[idx].cpu().numpy().astype(np.float64)
        edges = torch.as_tensor(compute_bin_edges(
            sample, int(self.params["nbins"]), w_sample)).to(frame.device)
        binned = self._bin_frame(frame, x, edges)
        yvec = frame.vec(y)
        yy, valid = response_as_float(yvec)
        return edges, binned, yy, valid, yvec

    def _bin_frame(self, frame: Frame, x: list[str], edges) -> torch.Tensor:
        """Per-column binning → [rows, F] int8/int16 bins (int8 up to 125
        bins halves the histogram kernel's dominant input)."""
        nbins = int(self.params["nbins"])
        dtype = bin_dtype(nbins)
        return torch.stack([bin_column(frame.vec(c).as_float(), edges[j],
                                       nbins, dtype)
                            for j, c in enumerate(x)], dim=1)


class GBM(SharedTreeBuilder):
    """h2o-py surface: ``H2OGradientBoostingEstimator``."""

    algo = "gbm"

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), learn_rate=0.1, distribution="AUTO",
                    reg_lambda=0.0)

    def _distribution(self, yvec) -> str:
        dist = str(self.params["distribution"])
        if dist.lower() == "auto":
            dist = "AUTO"
        if yvec.is_categorical:
            if dist not in ("AUTO", "bernoulli", "multinomial"):
                raise ValueError(f"distribution {dist!r} requires a numeric response")
            if dist == "bernoulli" and yvec.cardinality() != 2:
                raise ValueError("Binomial requires the response to be a "
                                 "2-class categorical")
            dist = "bernoulli" if yvec.cardinality() == 2 else "multinomial"
        elif dist == "AUTO":
            dist = "gaussian"
        elif dist == "bernoulli":
            raise ValueError("bernoulli distribution requires a categorical "
                             "(2-level) response")
        if dist not in DISTRIBUTIONS:
            raise NotImplementedError(f"distribution {dist!r} is not ported "
                                      f"yet; the port has {DISTRIBUTIONS}")
        return dist

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> GBMModel:
        p = self.params
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
        dist = self._distribution(yvec)
        dev = frame.device
        w = weights * valid
        yc = torch.where(w > 0, yy, 0.0)
        ybar = float((w * yc).sum() / torch.clamp(w.sum(), min=1e-30))
        if dist == "bernoulli":
            ybar = min(max(ybar, 1e-6), 1 - 1e-6)
            f0 = float(np.log(ybar / (1 - ybar)))
        else:
            f0 = ybar

        lr = float(p["learn_rate"])
        params = TreeParams(max_depth=int(p["max_depth"]), nbins=int(p["nbins"]),
                            min_rows=float(p["min_rows"]),
                            reg_lambda=float(p["reg_lambda"]), reg_alpha=0.0,
                            gamma=0.0, min_split_improvement=float(
                                p["min_split_improvement"]))
        binned_T = binned.T.contiguous()   # the histogram kernel reads [F, rows]
        feat_mask = torch.ones(binned.shape[1], dtype=torch.bool, device=dev)
        Fcur = torch.full((binned.shape[0],), f0, dtype=torch.float32,
                          device=dev)
        ntrees = int(p["ntrees"])
        trees: list[Tree] = []
        job.update(0.1, f"growing {ntrees} trees")
        for m in range(ntrees):
            g, h = _grad_hess(dist, Fcur, yc, w)
            tree, row_leaf = grow_tree(binned, binned_T, edges, g, h, w,
                                       params, feat_mask)
            trees.append(tree)
            Fcur = Fcur + lr * row_leaf
            job.update(0.1 + 0.8 * (m + 1) / max(ntrees, 1),
                       f"{m + 1}/{ntrees} trees")
        # final margins double as training predictions (skips the re-score)
        if dist == "bernoulli":
            pe = torch.sigmoid(Fcur)
            self._last_train_raw = torch.stack([1 - pe, pe], dim=1)
        else:
            self._last_train_raw = Fcur
        domains = {c: frame.vec(c).domain for c in x
                   if frame.vec(c).is_categorical}
        return GBMModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(trees=trees, edges=edges, f0=f0, learn_rate=lr,
                        distribution=dist, x_cols=list(x),
                        feat_domains=domains, ntrees=len(trees)))
