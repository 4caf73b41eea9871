"""XGBoost — the port of ``h2o3_tpu/models/xgboost.py`` (gbtree booster).

As in the reference, "XGBoost" is the shared histogram tree engine with
XGBoost's parameterisation: global-quantile bins (256 by default, stored as
int16, so each level's histograms run 257 bins), the gain
``0.5*(GL²/(HL+λ)+GR²/(HR+λ)−G²/(H+λ))−γ`` with L1 soft-thresholding by
``reg_alpha``, a learned direction for missing values, and h2o-py's
XGBoost parameter names mapped onto the engine's. ``booster="dart"`` is
left for a later slice and raises; ``gblinear`` is a linear model and
raises the reference's error.
"""

from __future__ import annotations

from h2o3_tpu_torch.models.gbm import GBM, GBMModel


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
        if booster == "dart":
            raise NotImplementedError("booster='dart' is not ported yet")
        if booster != "gbtree":
            raise ValueError(f"unknown booster {booster!r}")
        model = super()._fit(job, frame, x, y, weights)
        model.__class__ = XGBoostModel
        return model
