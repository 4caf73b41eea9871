"""XGBoost — the port of ``h2o3_tpu/models/xgboost.py`` (gbtree and DART
boosters).

As in the reference, "XGBoost" is the shared histogram tree engine with
XGBoost's parameterisation: global-quantile bins (256 by default, stored as
int16, so each level's histograms run 257 bins), the gain
``0.5*(GL²/(HL+λ)+GR²/(HR+λ)−G²/(H+λ))−γ`` with L1 soft-thresholding by
``reg_alpha``, a learned direction for missing values, and h2o-py's
XGBoost parameter names mapped onto the engine's. ``booster="dart"``
(Rashmi and Gilad-Bachrach 2015) drops a random set of prior trees each
round, fits the new tree to the gradients of the rest and renormalises
the dropped and new trees (``rate_drop``, ``skip_drop``, ``one_drop``,
``normalize_type``); the drops come from ``np.random.default_rng(seed)``
as in the reference, so the dropped sets are the reference's, and the
tree weights are baked into the leaves at the end. ``gblinear`` is a
linear model and raises the reference's error. ``gbtree`` trains
``distribution="custom"`` as GBM does; DART refuses it (the reference's
DART loop has no custom distribution and fails).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h2o3_tpu_torch.models.gbm import (GBM, LOG_LINK, GBMModel,
                                       _grad_hess, _offset, sigmoid)
from h2o3_tpu_torch.models.job import JobCancelled
from h2o3_tpu_torch.models.model_base import make_model_key
from h2o3_tpu_torch.models.tree import grow_tree


class XGBoostModel(GBMModel):
    algo = "xgboost"


#: h2o-py H2OXGBoostEstimator parameter names → shared-engine names
#: (None: accepted and inert)
_ALIASES = {
    "eta": "learn_rate",
    "max_bin": "nbins",
    "subsample": "sample_rate",
    "colsample_bytree": "col_sample_rate_per_tree",
    "colsample_bylevel": "col_sample_rate",
    "colsample_bynode": "col_sample_by_node",
    "min_child_weight": "min_rows",
    "min_split_loss": "gamma",
    "max_delta_step": None,          # rarely used
    "grow_policy": None,             # depthwise only (level-synchronous)
    "tree_method": None,             # always hist
    "backend": None,
    "gpu_id": None,
    "dmatrix_type": None,
}


class XGBoost(GBM):
    """h2o-py surface: ``H2OXGBoostEstimator`` (tree_method=hist semantics)."""

    algo = "xgboost"

    @classmethod
    def defaults(cls) -> dict:
        d = super().defaults()
        d.update(
            ntrees=50,
            max_depth=6,
            learn_rate=0.3,        # eta
            reg_lambda=1.0,        # lambda
            reg_alpha=0.0,         # alpha (leaf L1; applied as soft threshold)
            gamma=0.0,             # min_split_loss
            min_rows=1.0,          # min_child_weight
            nbins=256,             # max_bin
            sample_rate=1.0,       # subsample
            col_sample_rate=1.0,   # colsample_bylevel
            col_sample_rate_per_tree=1.0,  # colsample_bytree
            col_sample_by_node=1.0,        # colsample_bynode (folds into level)
            booster="gbtree",      # gbtree | dart | (gblinear → use GLM)
            rate_drop=0.0,         # DART: P(tree is dropped) per round
            skip_drop=0.0,         # DART: P(round skips dropping entirely)
            one_drop=False,        # DART: always drop >= 1 tree
            normalize_type="tree",  # DART: tree | forest
        )
        return d

    def __init__(self, **params):
        for alias, target in _ALIASES.items():
            if alias in params:
                v = params.pop(alias)
                if target is not None:
                    params.setdefault(target, v)
        super().__init__(**params)

    def _check_mesh(self, frame, validation_frame) -> None:
        """As GBM's; DART's rounds (dropped trees' margins, its own base
        margin) are not rank-aware yet."""
        super()._check_mesh(frame, validation_frame)
        if str(self.params.get("booster") or "gbtree").lower() == "dart":
            from h2o3_tpu_torch.parallel.mesh import refuse_on_mesh
            refuse_on_mesh("xgboost's booster='dart'")

    def supports_auto_recovery(self) -> bool:
        # DART neither checkpoints nor resumes (its prior trees' weights
        # are renormalised each round); gbtree shares GBM's snapshots
        return str(self.params.get("booster") or "gbtree").lower() != "dart"

    def _retag_model(self, m: GBMModel) -> XGBoostModel:
        m.__class__ = XGBoostModel
        return m

    def _effective_col_rate(self) -> float:
        # by-node sampling folds into the per-level rate; derived here so
        # the stored params keep the user's values
        return (float(self.params["col_sample_rate"])
                * float(self.params.get("col_sample_by_node") or 1.0))

    def _fit(self, job, frame, x, y, weights):
        booster = str(self.params.get("booster") or "gbtree").lower()
        if booster == "gblinear":
            raise ValueError("booster='gblinear' is a linear model — use GLM "
                             "(the reference routes it to a linear booster)")
        if booster not in ("gbtree", "dart"):
            raise ValueError(f"unknown booster {booster!r}")
        if booster == "dart":
            return self._fit_dart(job, frame, x, y, weights)
        model = super()._fit(job, frame, x, y, weights)
        model.__class__ = XGBoostModel
        return model

    # -- DART ---------------------------------------------------------------

    def _fit_dart(self, job, frame, x, y, weights) -> XGBoostModel:
        """DART boosting: per-round tree dropout and renormalisation
        (reference ``_fit_dart``). The rounds are a host loop, since each
        re-weights prior trees; a round's device work is the dropped
        trees' margin, the gradients and one tree's growth. The rounds'
        dropped tree indices are kept in ``self.dart_drops``."""
        p = self.params
        if p.get("checkpoint"):
            raise ValueError("checkpoint resume is not supported with "
                             "booster='dart' (prior-tree weights would have "
                             "been renormalized away)")
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
        dist = str(p["distribution"])
        if dist.lower() == "auto":
            dist = "AUTO"
        if yvec.is_categorical:
            if yvec.cardinality() != 2:
                raise ValueError("booster='dart' supports binomial and "
                                 "regression responses here")
            dist = "bernoulli"
        elif dist == "bernoulli":
            raise ValueError("bernoulli distribution requires a categorical "
                             "(2-level) response")
        elif dist == "AUTO":
            dist = "gaussian"
        elif dist == "custom":
            # the reference's DART loop has no custom distribution (its
            # gradient call finds none registered and fails)
            raise ValueError("booster='dart' does not take "
                             "distribution='custom'; use booster='gbtree'")
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
        ntrees = int(p["ntrees"])
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 42
        rng = np.random.default_rng(seed)
        tp = self._tree_params()
        mono, reach = self._constraint_arrays(x, frame)
        cat_feats = self._cat_feats
        binned_T = binned.T.contiguous()
        fmask_base = torch.ones(binned.shape[1], dtype=torch.bool, device=dev)
        rate_drop = float(p.get("rate_drop") or 0.0)
        skip_drop = float(p.get("skip_drop") or 0.0)
        one_drop = bool(p.get("one_drop"))
        norm_forest = str(p.get("normalize_type") or "tree") == "forest"
        sample_rate = float(p["sample_rate"])
        col_tree_rate = float(p["col_sample_rate_per_tree"])
        col_rate = self._effective_col_rate()
        hp = (float(p["quantile_alpha"]), float(p["huber_alpha"]),
              float(p["tweedie_power"]))
        sr = int(p.get("stopping_rounds") or 0)
        metric = str(p.get("stopping_metric") or "AUTO")
        tol = float(p.get("stopping_tolerance") or 1e-3)
        best, since = np.inf, 0

        trees, wts, preds = [], [], []   # preds: each tree's [rows] leaves
        self.dart_drops = []
        Fcur = torch.full((binned.shape[0],), f0, dtype=torch.float32,
                          device=dev)
        oc = p.get("offset_column")
        if oc:
            Fcur = Fcur + _offset(frame, oc)
        for m in range(ntrees):
            drop = np.zeros(len(trees), bool)
            if trees and rng.random() >= skip_drop:
                drop = rng.random(len(trees)) < rate_drop
                if one_drop and not drop.any():
                    drop[rng.integers(0, len(trees))] = True
            k = int(drop.sum())
            F_drop = 0.0
            if k:
                F_drop = sum(wts[i] * preds[i]
                             for i in range(len(trees)) if drop[i])
            F_eff = Fcur - F_drop
            gen = self._tree_generator(dev, m)
            wt = self._row_weights(gen, w, sample_rate, bootstrap=False)
            tmask = self._sample_fmask(gen, fmask_base, col_tree_rate)
            g, h = _grad_hess(dist, F_eff, yc, wt, *hp)
            new, pred = grow_tree(binned, binned_T, edges, g, h, wt, tp,
                                  tmask, col_rate, gen, mono=mono,
                                  reach=reach, cat_feats=cat_feats)
            if k:
                # renormalise (XGBoost DART): tree: new w = lr/(k+lr),
                # dropped *= k/(k+lr); forest: lr/(1+lr) and 1/(1+lr)
                if norm_forest:
                    w_new, scale = lr / (1.0 + lr), 1.0 / (1.0 + lr)
                else:
                    w_new, scale = lr / (k + lr), k / (k + lr)
                for i in range(len(trees)):
                    if drop[i]:
                        wts[i] *= scale
                Fcur = F_eff + scale * F_drop + w_new * pred
            else:
                w_new = lr
                Fcur = Fcur + w_new * pred
            trees.append(new)
            wts.append(w_new)
            preds.append(pred)
            self.dart_drops.append(np.nonzero(drop)[0].tolist())
            try:
                job.update(0.1 + 0.8 * (m + 1) / ntrees,
                           f"DART tree {m + 1}/{ntrees} (dropped {k})")
            except JobCancelled:
                if not job.deadline_exceeded:
                    raise
                job.keep_partial()      # max_runtime_secs: keep the trees
                break
            if sr > 0:                  # ScoreKeeper early stopping
                score = self._stop_score(metric, dist, Fcur, yc, w, 0)
                if score < best - tol * abs(best) or not np.isfinite(best):
                    best, since = score, 0
                else:
                    since += 1
                    if since >= sr:
                        break
        del preds
        # weights baked into leaves: every scorer (raw, binned, SHAP) then
        # reads the ensemble uniformly at learn rate 1
        baked = [dataclasses.replace(t, leaf=t.leaf * wt)
                 for t, wt in zip(trees, wts)]
        if dist == "bernoulli":
            pe = sigmoid(Fcur)
            self._last_train_raw = torch.stack([1 - pe, pe], dim=1)
        elif dist in LOG_LINK:
            self._last_train_raw = torch.exp(torch.clamp(Fcur, -30, 30))
        else:
            self._last_train_raw = Fcur
        model = XGBoostModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(trees=baked, edges=edges, f0=f0, learn_rate=1.0,
                        distribution=dist, x_cols=list(x),
                        feat_domains={c: frame.vec(c).domain for c in x
                                      if frame.vec(c).is_categorical},
                        ntrees=len(baked),
                        dart_weights=[float(v) for v in wts],
                        **self._cat_output()))
        self._maybe_calibrate(model)
        return model
