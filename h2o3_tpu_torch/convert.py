"""Carry trained models across from the JAX package to the port.

:func:`glm_model` takes a JAX GLM's ``output`` (beta, coef, coef_names,
the ordinal thresholds, the interaction domains), the fields of its
``DataInfo`` and its params, all as numpy arrays and plain values, and
returns the port's GLMModel. :func:`gbm_model`, :func:`drf_model` and
:func:`xgboost_model` take a JAX
model's ``output`` as plain numpy and dicts — each tree a dict of its heap
arrays (and ``left_mask`` in a group-split model), ``trees`` a list of
them and ``trees_multi`` (multinomial) a list per class, with ``cat_card``
and ``cat_bins`` where the model has group splits — and return the port's
model on the chosen device, so the port can score a model trained by the
reference, and resume from it (``checkpoint=``). They never import the
reference: the caller converts its tree objects to dicts
(``{k: np.asarray(getattr(tree, k)) for k in HEAP_FIELDS +
("left_mask",)}``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.gbm import DISTRIBUTIONS, DRFModel, GBMModel
from h2o3_tpu_torch.models.glm import GLMModel
from h2o3_tpu_torch.models.model_base import make_model_key
from h2o3_tpu_torch.models.tree import HEAP_FIELDS, Tree
from h2o3_tpu_torch.models.xgboost import XGBoostModel

_HEAP_DTYPES = dict(feat=torch.int32, thresh_bin=torch.int32,
                    thresh_val=torch.float32, na_left=torch.bool,
                    is_split=torch.bool, leaf=torch.float32,
                    gain=torch.float32, cover=torch.float32)


def _trees(dicts, dev) -> list[Tree]:
    trees = []
    for t in dicts:
        mask = t.get("left_mask")
        trees.append(Tree(**{
            k: torch.as_tensor(np.array(t[k])).to(dev, _HEAP_DTYPES[k])
            for k in HEAP_FIELDS if t.get(k) is not None},
            left_mask=None if mask is None else
            torch.as_tensor(np.array(mask)).to(dev, torch.bool)))
    return trees


def _tree_output(output: Mapping, dev) -> dict:
    """The trees (one set, or one per class) and the binning and feature
    entries every tree model's output holds."""
    out = dict(edges=torch.as_tensor(np.array(output["edges"],
                                              np.float32)).to(dev),
               x_cols=list(output["x_cols"]),
               feat_domains=dict(output.get("feat_domains") or {}),
               learn_rate=float(output["learn_rate"]),
               f0=float(output.get("f0") or 0.0))
    if output.get("trees_multi") is not None:
        out["trees_multi"] = [_trees(ts, dev) for ts in output["trees_multi"]]
    else:
        out["trees"] = _trees(output["trees"], dev)
    if output.get("cat_card") is not None:
        out["cat_card"] = torch.as_tensor(
            np.array(output["cat_card"], np.int32)).to(dev)
        out["cat_bins"] = int(output["cat_bins"])
    return out


def _model(cls, algo: str, out: dict, response_column, response_domain,
           params):
    return cls(key=make_model_key(algo, None), params=dict(params or {}),
               response_column=response_column,
               response_domain=tuple(response_domain) if response_domain
               else None, output=out)


def _boosted(cls, algo: str, output: Mapping, response_column,
             response_domain, params, device):
    dev = resolve_device(device)
    dist = output["distribution"]
    if dist not in DISTRIBUTIONS:
        raise NotImplementedError(f"distribution {dist!r} is not ported yet")
    out = _tree_output(output, dev)
    if dist == "multinomial":
        out["f0_multi"] = torch.as_tensor(
            np.asarray(output["f0_multi"], np.float32)).to(dev)
        ntrees = len(out["trees_multi"][0])
    else:
        ntrees = len(out["trees"])
    out.update(distribution=dist, ntrees=int(output.get("ntrees", ntrees)))
    return _model(cls, algo, out, response_column, response_domain, params)


def gbm_model(output: Mapping, response_column: str | None = None,
              response_domain: tuple[str, ...] | None = None,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> GBMModel:
    """The port's GBMModel from a reference model's ``output``: the heap
    arrays of every tree (``trees``, or ``trees_multi`` per class for
    multinomial), ``edges``, ``f0`` (``f0_multi`` for multinomial),
    ``learn_rate``, ``distribution``, ``x_cols`` and ``feat_domains``.
    ``params`` carries ``offset_column`` where the model has one."""
    return _boosted(GBMModel, "gbm", output, response_column,
                    response_domain, params, device)


def xgboost_model(output: Mapping, response_column: str | None = None,
                  response_domain: tuple[str, ...] | None = None,
                  params: Mapping | None = None,
                  device: str | torch.device | None = None) -> XGBoostModel:
    """The port's XGBoostModel (gbtree booster) from a reference model's
    ``output``, read as :func:`gbm_model` reads it."""
    return _boosted(XGBoostModel, "xgboost", output, response_column,
                    response_domain, params, device)


def drf_model(output: Mapping, response_column: str | None = None,
              response_domain: tuple[str, ...] | None = None,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> DRFModel:
    """The port's DRFModel from a reference model's ``output``: ``trees``
    (regression and binomial) or ``trees_multi`` (multinomial and
    ``binomial_double_trees``), ``ntrees``, ``binomial``, ``edges``,
    ``x_cols`` and ``feat_domains``."""
    dev = resolve_device(device)
    out = _tree_output(output, dev)
    out.update(ntrees=int(output["ntrees"]),
               binomial=bool(output.get("binomial")),
               distribution=output.get("distribution", "gaussian"))
    return _model(DRFModel, "drf", out, response_column, response_domain,
                  params)


#: the GLM params scoring reads, with the reference GLM's defaults
_GLM_SCORING_PARAMS = dict(offset_column=None, interactions=None,
                           tweedie_variance_power=1.5, theta=1.0)


def glm_model(output: Mapping, data_info: Mapping,
              response_column: str | None = None,
              response_domain: tuple[str, ...] | None = None,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> GLMModel:
    """The port's GLMModel from a reference GLM: ``output`` with ``beta``
    ([P+1], [P+1, K] for multinomial, [P] for ordinal), ``coef``,
    ``coef_names``, ``family``, and where the model has them
    ``ordinal_theta`` and ``interaction_domains``; ``data_info`` the
    fields of its DataInfo (``dataclasses.asdict``); ``params`` those
    scoring reads (``family``, ``offset_column``, ``interactions``,
    ``tweedie_variance_power``, ``theta``). A sparse GLM has no DataInfo
    and is not carried across."""
    dev = resolve_device(device)
    if output.get("sparse"):
        raise NotImplementedError("sparse GLMs are not carried across")
    di = DataInfo(
        cat_cols=list(data_info["cat_cols"]),
        num_cols=list(data_info["num_cols"]),
        cat_domains=[tuple(d) for d in data_info["cat_domains"]],
        cat_offsets=np.asarray(data_info["cat_offsets"], np.int32),
        num_means=np.asarray(data_info["num_means"], np.float32),
        num_mul=np.asarray(data_info["num_mul"], np.float32),
        num_sub=np.asarray(data_info["num_sub"], np.float32),
        use_all_factor_levels=bool(data_info["use_all_factor_levels"]),
        standardize=bool(data_info["standardize"]),
        ncats_expanded=int(data_info["ncats_expanded"]))
    p = dict(_GLM_SCORING_PARAMS, **dict(params or {}))
    p["family"] = p.get("family") or output["family"]
    out = {k: v for k, v in output.items()
           if k not in ("beta", "ordinal_theta")}
    out["beta"] = torch.as_tensor(np.array(output["beta"],
                                             np.float32)).to(dev)
    out["coef"] = np.asarray(output["coef"], np.float64)
    out["coef_names"] = list(output["coef_names"])
    if output.get("ordinal_theta") is not None:
        out["ordinal_theta"] = torch.as_tensor(
            np.array(output["ordinal_theta"], np.float32)).to(dev)
    if output.get("interaction_domains"):
        out["interaction_domains"] = {
            c: tuple(d) for c, d in output["interaction_domains"].items()}
    return GLMModel(key=make_model_key("glm", None), params=p,
                    response_column=response_column,
                    response_domain=tuple(response_domain)
                    if response_domain else None,
                    output=out, data_info=di)
