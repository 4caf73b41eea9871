"""Uplift DRF — treatment-effect forests and AUUC metrics — the port of
``h2o3_tpu/models/uplift.py``.

Reference: ``hex/tree/uplift/UpliftDRF.java`` and ``hex/AUUC.java``. As in
the reference, the trees grow on the shared histogram engine through the
transformed outcome Z = Y·T/p − Y·(1−T)/(1−p) (Athey and Imbens), whose
per-leaf mean estimates the uplift, with the propensity p taken from the
data in one fetch. The trees grow 8 at a time: one class-batched growth
(K = 8) whose classes are trees, each on its own Poisson bootstrap of the
row weights, so each level is one launch of the histogram kernel for all
eight. :func:`compute_auuc` ranks rows by predicted uplift (a stable
sort: the predictions are averages of leaf values, so many rows tie) and
accumulates the qini curve over ``auuc_nbins`` thresholds.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import response_as_float
from h2o3_tpu_torch.models.gbm import SharedTreeBuilder, SharedTreeModel
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import make_model_key
from h2o3_tpu_torch.models.tree import TreeParams, grow_trees_batched

#: trees grown together, as the classes of one batched growth
BATCH = 8


class ModelMetricsBinomialUplift:
    """AUUC family (reference: ``hex/ModelMetricsBinomialUplift.java``)."""

    def __init__(self, auuc, qini, auuc_normalized, nbins):
        self.auuc = auuc
        self.qini = qini
        self.auuc_normalized = auuc_normalized
        self.nbins = nbins

    def __repr__(self):
        return (f"ModelMetricsBinomialUplift(auuc={self.auuc:.5f}, "
                f"qini={self.qini:.5f}, norm={self.auuc_normalized:.5f})")


def compute_auuc(uplift_pred: torch.Tensor, y: torch.Tensor,
                 treat: torch.Tensor, mask: torch.Tensor,
                 nbins: int = 1000) -> tuple[float, float, float]:
    """(AUUC, qini, normalised AUUC) by ranked-threshold bins (reference
    ``compute_auuc`` after ``AUUC.java``): rows sorted by predicted uplift,
    descending and stable, the treated and control counts and responses
    accumulated, and the qini value yt − yc·nt/nc read at ``nbins``
    thresholds; float32, with one fetch of the three results."""
    u = torch.where(mask, uplift_pred, -torch.inf)
    order = torch.argsort(-u, stable=True)
    ys, ts = y[order], treat[order]
    ms = mask[order].float()
    n = torch.clamp(ms.sum(), min=1.0)
    cum_t = torch.cumsum(ms * ts, 0)
    cum_c = torch.cumsum(ms * (1 - ts), 0)
    cum_yt = torch.cumsum(ms * ts * ys, 0)
    cum_yc = torch.cumsum(ms * (1 - ts) * ys, 0)
    plen = ys.shape[0]
    idx = ((torch.arange(1, nbins + 1, dtype=torch.int32, device=u.device)
            * n / nbins).to(torch.int32) - 1).clamp(0, plen - 1).long()
    nt, nc = cum_t[idx], cum_c[idx]
    yt, yc = cum_yt[idx], cum_yc[idx]
    qini_curve = yt - yc * nt / torch.clamp(nc, min=1.0)
    auuc = qini_curve.sum() / nbins
    # random targeting: a straight line to the final qini value
    final = qini_curve[-1]
    qini = auuc - final / 2.0
    norm = torch.where(final.abs() > 1e-12, auuc / final.abs(), 0.0)
    return tuple(float(v) for v in torch.stack([auuc, qini, norm]).cpu())


class UpliftDRFModel(SharedTreeModel):
    algo = "upliftdrf"

    def _contrib_scale_bias(self):
        return 1.0 / max(len(self.output["trees"]), 1), 0.0

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        """Predicted uplift per row: the trees' mean leaf."""
        return self._tree_raw_sum(frame) / max(len(self.output["trees"]), 1)

    def predict(self, frame: Frame) -> Frame:
        return Frame(["uplift_predict"],
                     [Vec.from_device(self._score_raw(frame), VecType.NUM)])

    def model_performance(self, frame: Frame) -> ModelMetricsBinomialUplift:
        y, valid = response_as_float(frame.vec(self.response_column))
        t = frame.vec(self.output["treatment_column"]).as_float()
        mask = frame.row_mask() & valid & ~torch.isnan(t)
        nbins = int(self.params.get("auuc_nbins") or -1)
        if nbins <= 0:
            nbins = 1000   # the reference AUUC's default bin count
        return ModelMetricsBinomialUplift(
            *compute_auuc(self._score_raw(frame), y,
                          torch.where(mask, t, 0.0), mask, nbins),
            nbins=nbins)


class UpliftDRF(SharedTreeBuilder):
    """h2o-py surface: ``H2OUpliftRandomForestEstimator``."""

    algo = "upliftdrf"
    #: bagged trees on the transformed outcome: no stopping, no per-tree
    #: column sampling, no constraints, no calibration, no resume
    UNUSED = ("col_sample_rate_per_tree", "stopping_rounds",
              "stopping_metric", "stopping_tolerance", "score_tree_interval",
              "score_each_iteration", "monotone_constraints",
              "interaction_constraints", "calibrate_model",
              "calibration_frame", "calibration_method", "offset_column",
              "checkpoint")

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), treatment_column=None,
                    uplift_metric="KL", auuc_type="qini", auuc_nbins=-1,
                    ntrees=50, mtries=-1, sample_rate=0.632)

    def _validate(self, frame: Frame, x, y) -> None:
        super()._validate(frame, x, y)
        tc = self.params.get("treatment_column")
        if not tc:
            raise ValueError("treatment_column is required")
        tv = frame.vec(tc)
        if not tv.is_categorical or tv.cardinality() != 2:
            raise ValueError("treatment_column must be a 2-level categorical "
                             "(control first level, treatment second)")
        # the reference grows every tree on the transformed outcome and
        # computes the qini AUUC alone, whatever these two ask for
        if str(self.params.get("uplift_metric")) != "KL":
            raise ValueError("uplift_metric: the trees grow on the "
                             "transformed outcome; only the default 'KL' is "
                             "taken (the reference does not apply it)")
        if str(self.params.get("auuc_type")).lower() not in ("qini", "auto"):
            raise ValueError("auuc_type: only 'qini' is computed")

    def _check_folds(self, frame: Frame) -> int:
        nfolds = super()._check_folds(frame)
        if nfolds:
            raise NotImplementedError(
                "UpliftDRF does not cross-validate: its holdout predictions "
                "are uplifts, which the fold metrics cannot score (the "
                "reference's cross-validation fails on them too)")
        return nfolds

    def _batch_weights(self, w: torch.Tensor, s: int, k: int) -> list:
        """The Poisson bootstrap weights of trees s .. s + k - 1, each from
        its tree's generator (reference: ``_row_weights`` per tree key)."""
        rate = float(self.params["sample_rate"])
        return [self._row_weights(self._tree_generator(w.device, s + i), w,
                                  rate, bootstrap=True) for i in range(k)]

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> UpliftDRFModel:
        p = self.params
        tc = p["treatment_column"]
        x = [c for c in x if c != tc]
        yvec = frame.vec(y)
        if not yvec.is_categorical or yvec.cardinality() != 2:
            raise ValueError("uplift response must be a 2-level categorical")
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
        t = frame.vec(tc).as_float()         # codes 0 (control) / 1 (treated)
        w = weights * valid * ~torch.isnan(t)
        t = torch.where(w > 0, t, 0.0)
        yy = torch.where(w > 0, yy, 0.0)
        # transformed outcome: E[Z|x] = uplift(x), the propensity from the
        # data (one fetch)
        pt = float((w * t).sum() / torch.clamp(w.sum(), min=1e-30))
        pt = min(max(pt, 1e-6), 1 - 1e-6)
        z = yy * t / pt - yy * (1 - t) / (1 - pt)
        tp = TreeParams(max_depth=int(p["max_depth"]), nbins=int(p["nbins"]),
                        min_rows=float(p["min_rows"]), reg_lambda=0.0,
                        min_split_improvement=float(p["min_split_improvement"]))
        ntrees = int(p["ntrees"])
        col_rate = 1.0
        if int(p.get("mtries") or -1) > 0:
            col_rate = min(1.0, int(p["mtries"]) / max(len(x), 1))
        binned_T = binned.T.contiguous()
        fmask = torch.ones(binned.shape[1], dtype=torch.bool,
                           device=frame.device)
        trees = []
        for s in range(0, ntrees, BATCH):
            k = min(BATCH, ntrees - s)
            wks = torch.stack(self._batch_weights(w, s, k))     # [k, rows]
            grown, _ = grow_trees_batched(
                binned, binned_T, edges, -wks * z, wks, wks, tp, fmask,
                col_rate, self._tree_generator(frame.device, ntrees + s),
                cat_feats=self._cat_feats)
            del wks
            trees.extend(grown)
            job.update((s + k) / ntrees, f"{s + k}/{ntrees} trees")
        return UpliftDRFModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=yvec.domain,
            output=dict(trees=trees, x_cols=list(x),
                        feat_domains={c: frame.vec(c).domain for c in x
                                      if frame.vec(c).is_categorical},
                        treatment_column=tc, propensity=pt,
                        **self._cat_output()))

    def _holdout_metrics(self, model, frame, y, w):
        return model.model_performance(frame)
