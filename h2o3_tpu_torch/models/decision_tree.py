"""Single decision tree — the port of ``h2o3_tpu/models/decision_tree.py``.

Reference: ``hex/tree/dt/DT.java``, one CART tree grown level by level
with a binomial or numeric response. As in the reference, the shared
histogram engine grows it in one step: with no prior margin the
second-order leaf objective of the identity gradient (g = -w·y, h = w) is
the weighted node mean, so one boosting step IS the CART fit (for a 0/1
response, the class-1 probability). At its defaults (depth 10, 64 bins)
the levels of few nodes take the fixed kernel and the deep ones the global
kernel (:mod:`h2o3_tpu_torch.ops.hist`).
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import SharedTreeBuilder, SharedTreeModel
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import make_model_key
from h2o3_tpu_torch.models.tree import grow_tree


class DecisionTreeModel(SharedTreeModel):
    algo = "decisiontree"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        raw = self._tree_raw_sum(frame)
        if self.nclasses == 2:
            p = torch.clamp(raw, 0.0, 1.0)
            return torch.stack([1 - p, p], dim=1)
        return raw


class DecisionTree(SharedTreeBuilder):
    """h2o-py surface: ``H2ODecisionTreeEstimator`` (algo ``dt``)."""

    algo = "decisiontree"
    #: one tree, no sampling, no stopping, no constraints, no calibration
    UNUSED = ("ntrees", "sample_rate", "col_sample_rate_per_tree",
              "stopping_rounds", "stopping_metric", "stopping_tolerance",
              "score_tree_interval", "score_each_iteration",
              "monotone_constraints", "interaction_constraints",
              "calibrate_model", "calibration_frame", "calibration_method",
              "offset_column", "checkpoint")

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), max_depth=10, min_rows=10.0, nbins=64,
                    ntrees=1)

    def _fit(self, job: Job, frame: Frame, x, y,
             weights) -> DecisionTreeModel:
        yvec = frame.vec(y)
        if yvec.is_categorical and yvec.cardinality() != 2:
            raise ValueError("DecisionTree supports binary or numeric "
                             "responses")
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
        w = weights * valid
        yy = torch.where(w > 0, yy, 0.0)
        tp = self._tree_params(reg_lambda=0.0, reg_alpha=0.0, gamma=0.0)
        # identity gradient: g = -w*y, h = w, so leaf = sum(w*y)/sum(w)
        fmask = torch.ones(binned.shape[1], dtype=torch.bool,
                           device=frame.device)
        tree, row_leaf = grow_tree(binned, binned.T.contiguous(), edges,
                                   -w * yy, w, w, tp, fmask,
                                   cat_feats=self._cat_feats)
        job.update(1.0, "tree grown")
        # the training rows' leaves double as training predictions
        if yvec.is_categorical:
            p = torch.clamp(row_leaf, 0.0, 1.0)
            self._last_train_raw = torch.stack([1 - p, p], dim=1)
        else:
            self._last_train_raw = row_leaf
        return DecisionTreeModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(trees=[tree], x_cols=list(x),
                        feat_domains={c: frame.vec(c).domain for c in x
                                      if frame.vec(c).is_categorical},
                        **self._cat_output()))
