"""Shared by the orchestration tests: carrying JAX-trained models into the
port with ``convert``, their kept out-of-fold predictions included, under
the JAX model's key. Not a test module of its own (no ``test_``
functions)."""

import dataclasses

import numpy as np

from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models.data_info import response_as_float
from h2o3_tpu_torch.models.model_base import compute_metrics
from h2o3_tpu_torch.models.tree import HEAP_FIELDS


def _cv_entries(jm, nrows):
    if jm.cv_holdout_predictions is None:
        return {}
    return dict(cv_holdout_predictions=np.asarray(jm.cv_holdout_predictions),
                cv_holdout_mask=np.asarray(jm.cv_holdout_mask), nrows=nrows)


def _trees(ts):
    return [{k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS} for t in ts]


def carry(jm, nrows, frame=None):
    """The JAX model ``jm`` (a GBM, DRF, XGBoost or GLM) in the port, with
    its out-of-fold predictions cut to ``nrows``, its key and its run time;
    with the port ``frame`` of its training, its CV metrics recomputed by
    the port from the carried predictions."""
    o = jm.output
    if jm.algo == "glm":
        out = {k: (np.asarray(v) if k == "beta" else v)
               for k, v in o.items()}
        pm = convert.glm_model(dict(out, **_cv_entries(jm, nrows)),
                               dataclasses.asdict(jm.data_info),
                               jm.response_column, jm.response_domain,
                               dict(jm.params))
    else:
        out = dict(o)
        if o.get("trees_multi") is not None:
            out["trees_multi"] = [_trees(ts) for ts in o["trees_multi"]]
        else:
            out["trees"] = _trees(o["trees"])
        fn = {"drf": convert.drf_model, "xgboost": convert.xgboost_model,
              "gbm": convert.gbm_model}[jm.algo]
        pm = fn(dict(out, **_cv_entries(jm, nrows)),
                response_column=jm.response_column,
                response_domain=jm.response_domain, params=dict(jm.params))
    pm.key = jm.key
    pm.run_time_ms = jm.run_time_ms
    if frame is not None and pm.cv_holdout_predictions is not None:
        yv = frame.vec(jm.response_column)
        pm.cross_validation_metrics = compute_metrics(
            pm.cv_holdout_predictions, response_as_float(yv)[0],
            pm.cv_holdout_mask, yv.cardinality() if yv.is_categorical else 0)
    return pm
