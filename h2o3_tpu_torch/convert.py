"""Carry trained models across from the JAX package to the port.

:func:`glm_model` takes a JAX GLM's ``output`` (beta, coef, coef_names,
the ordinal thresholds, the interaction domains), the fields of its
``DataInfo`` and its params, all as numpy arrays and plain values, and
returns the port's GLMModel. :func:`gbm_model`, :func:`drf_model`,
:func:`xgboost_model` (gbtree and DART), :func:`decision_tree_model`,
:func:`uplift_model` and :func:`isolation_forest_model` take a JAX
model's ``output`` as plain numpy and dicts — each tree a dict of its heap
arrays (and ``left_mask`` in a group-split model), ``trees`` a list of
them and ``trees_multi`` (multinomial) a list per class, with ``cat_card``
and ``cat_bins`` where the model has group splits, and ``calibration``
where a binomial model has one — and return the port's
model on the chosen device, so the port can score a model trained by the
reference, and resume from it (``checkpoint=``). They never import the
reference: the caller converts its tree objects to dicts
(``{k: np.asarray(getattr(tree, k)) for k in HEAP_FIELDS +
("left_mask",)}``). :func:`extended_isolation_forest_model` takes the
stacked hyperplane arrays of an extended isolation forest.
:func:`deeplearning_model`, :func:`kmeans_model`, :func:`pca_model`,
:func:`svd_model` and :func:`glrm_model` take a model's ``output`` as
numpy and the fields of its DataInfo, as :func:`glm_model` does;
:func:`naive_bayes_model` its ``output`` alone, and
:func:`target_encoder_model` a TargetEncoder's tables (its training
encodings stay with the JAX model: a converted encoder transforms any
frame by its full statistics). :func:`stacked_ensemble_model` takes an
ensemble's level-one names with its base models and metalearner already
carried across, so both packages score the same ensemble.
:func:`word2vec_model` takes a Word2Vec model's vectors, vocabulary and
counters, :func:`grep_model` a Grep model's matches as columns; a
custom-distribution GBM carries its ``custom_link``, and its
``custom_distribution_func`` names an upload in the port's DKV.

Every function also carries a model's kept out-of-fold predictions: where
``output`` holds ``cv_holdout_predictions`` and ``cv_holdout_mask`` (the
reference model's attributes, as numpy), they become the port model's,
cut to ``output["nrows"]`` rows (the reference pads its columns).
"""

from __future__ import annotations

import functools
import inspect
from typing import Mapping, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.models.coxph import CoxPHModel
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.decision_tree import DecisionTreeModel
from h2o3_tpu_torch.models.decomposition import GLRMModel, PCAModel, SVDModel
from h2o3_tpu_torch.models.deeplearning import MLP, DeepLearningModel
from h2o3_tpu_torch.models.gam import GAMModel
from h2o3_tpu_torch.models.gbm import DISTRIBUTIONS, DRFModel, GBMModel
from h2o3_tpu_torch.models.glm import GLMModel
from h2o3_tpu_torch.models.grep_algo import GrepModel
from h2o3_tpu_torch.models.hglm import HGLMModel
from h2o3_tpu_torch.models.infogram import InfogramModel
from h2o3_tpu_torch.models.isofor import (ExtendedIsolationForestModel,
                                          IsolationForestModel)
from h2o3_tpu_torch.models.isotonic import IsotonicRegressionModel
from h2o3_tpu_torch.models.kmeans import KMeansModel
from h2o3_tpu_torch.models.model_base import Model, make_model_key
from h2o3_tpu_torch.models.model_selection import (ANOVAGLMModel,
                                                   ModelSelectionModel)
from h2o3_tpu_torch.models.naive_bayes import NaiveBayesModel
from h2o3_tpu_torch.models.psvm import PSVMModel
from h2o3_tpu_torch.models.rulefit import RuleFitModel
from h2o3_tpu_torch.models.target_encoder import TargetEncoderModel
from h2o3_tpu_torch.models.tree import HEAP_FIELDS, Tree
from h2o3_tpu_torch.models.uplift import UpliftDRFModel
from h2o3_tpu_torch.models.word2vec import Word2VecModel
from h2o3_tpu_torch.models.xgboost import XGBoostModel
from h2o3_tpu_torch.orchestration.stacked_ensemble import StackedEnsembleModel

#: the entries of a carried ``output`` that are the model's kept
#: out-of-fold predictions, not its output
_CV_KEYS = ("cv_holdout_predictions", "cv_holdout_mask", "nrows")


def _carries_cv(fn):
    """``fn`` with the out-of-fold entries taken out of its ``output`` and
    set on the model it returns, on the model's device."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def carried(output, *args, **kw):
        cv = {k: output[k] for k in _CV_KEYS if k in output}
        model = fn({k: v for k, v in output.items() if k not in _CV_KEYS},
                   *args, **kw)
        preds = cv.get("cv_holdout_predictions")
        if preds is not None:
            dev = resolve_device(sig.bind(output, *args, **kw)
                                 .arguments.get("device"))
            n = int(cv.get("nrows") or len(preds))
            model.cv_holdout_predictions = torch.as_tensor(
                np.array(preds, np.float32)[:n]).to(dev)
            model.cv_holdout_mask = torch.as_tensor(
                np.array(cv["cv_holdout_mask"], bool)[:n]).to(dev)
        return model
    return carried

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
    entries a tree model's output holds (the boosted and bagged models'
    ``edges``, ``learn_rate`` and ``f0``, where it has them), with a
    binomial model's ``calibration``."""
    out = dict(x_cols=list(output["x_cols"]),
               feat_domains=dict(output.get("feat_domains") or {}))
    if output.get("edges") is not None:
        out.update(edges=torch.as_tensor(np.array(output["edges"],
                                                  np.float32)).to(dev),
                   learn_rate=float(output["learn_rate"]),
                   f0=float(output.get("f0") or 0.0))
    if output.get("calibration") is not None:
        out["calibration"] = dict(output["calibration"])
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
           params, data_info: DataInfo | None = None):
    return cls(key=make_model_key(algo, None), params=dict(params or {}),
               response_column=response_column,
               response_domain=tuple(response_domain) if response_domain
               else None, output=out, data_info=data_info)


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
    if dist == "custom":
        out["custom_link"] = _custom_link(output, params)
    if output.get("dart_weights") is not None:
        out["dart_weights"] = [float(v) for v in output["dart_weights"]]
    return _model(cls, algo, out, response_column, response_domain, params)


def _custom_link(output: Mapping, params: Mapping | None) -> str:
    """A custom-distribution model's link, checked against its
    distribution: the model carries the UDF's reference
    (``custom_distribution_func``), not its bytes, so the key must be in
    the port's DKV, and the UDF's link must be the model's."""
    from h2o3_tpu_torch.utils.udf import resolve_distribution
    ref = (params or {}).get("custom_distribution_func")
    if not ref:
        raise ValueError("a custom-distribution model needs its "
                         "custom_distribution_func in params")
    link = str(output["custom_link"])
    have = resolve_distribution(str(ref)).link_name
    if have != link:
        raise ValueError(f"custom_link {link!r}: {ref!r} links by {have!r}")
    return link


@_carries_cv
def gbm_model(output: Mapping, response_column: str | None = None,
              response_domain: tuple[str, ...] | None = None,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> GBMModel:
    """The port's GBMModel from a reference model's ``output``: the heap
    arrays of every tree (``trees``, or ``trees_multi`` per class for
    multinomial), ``edges``, ``f0`` (``f0_multi`` for multinomial),
    ``learn_rate``, ``distribution``, ``x_cols`` and ``feat_domains``.
    ``params`` carries ``offset_column`` where the model has one; a custom
    distribution's model carries ``custom_link`` in ``output`` and its
    ``custom_distribution_func`` in ``params``, whose key must be in the
    port's DKV."""
    return _boosted(GBMModel, "gbm", output, response_column,
                    response_domain, params, device)


@_carries_cv
def xgboost_model(output: Mapping, response_column: str | None = None,
                  response_domain: tuple[str, ...] | None = None,
                  params: Mapping | None = None,
                  device: str | torch.device | None = None) -> XGBoostModel:
    """The port's XGBoostModel from a reference model's ``output``, read as
    :func:`gbm_model` reads it; a DART model's trees carry their weights in
    their leaves (learn rate 1), with its ``dart_weights``."""
    return _boosted(XGBoostModel, "xgboost", output, response_column,
                    response_domain, params, device)


@_carries_cv
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


@_carries_cv
def decision_tree_model(output: Mapping, response_column: str | None = None,
                        response_domain: tuple[str, ...] | None = None,
                        params: Mapping | None = None,
                        device: str | torch.device | None = None
                        ) -> DecisionTreeModel:
    """The port's DecisionTreeModel from a reference model's ``output``:
    its one tree in ``trees``, ``x_cols`` and ``feat_domains``."""
    out = _tree_output(output, resolve_device(device))
    return _model(DecisionTreeModel, "decisiontree", out, response_column,
                  response_domain, params)


@_carries_cv
def uplift_model(output: Mapping, response_column: str | None = None,
                 response_domain: tuple[str, ...] | None = None,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None) -> UpliftDRFModel:
    """The port's UpliftDRFModel from a reference model's ``output``:
    ``trees``, ``x_cols``, ``feat_domains``, ``treatment_column`` and
    ``propensity``; ``params`` carries ``auuc_nbins`` where it is set."""
    out = _tree_output(output, resolve_device(device))
    out.update(treatment_column=output["treatment_column"],
               propensity=float(output["propensity"]))
    return _model(UpliftDRFModel, "upliftdrf", out, response_column,
                  response_domain, params)


@_carries_cv
def isolation_forest_model(output: Mapping, params: Mapping | None = None,
                           device: str | torch.device | None = None
                           ) -> IsolationForestModel:
    """The port's IsolationForestModel from a reference model's ``output``:
    ``trees`` (each with ``feat``, ``thresh_bin``, ``thresh_val``,
    ``na_left``, ``is_split`` and ``leaf``), ``ntrees``, ``x_cols``,
    ``feat_domains``, ``min_path_length`` and ``max_path_length``."""
    out = _tree_output(output, resolve_device(device))
    out.update(ntrees=int(output["ntrees"]),
               min_path_length=float(output["min_path_length"]),
               max_path_length=float(output["max_path_length"]))
    return _model(IsolationForestModel, "isolationforest", out, None, None,
                  params)


@_carries_cv
def extended_isolation_forest_model(
        output: Mapping, params: Mapping | None = None,
        device: str | torch.device | None = None
        ) -> ExtendedIsolationForestModel:
    """The port's ExtendedIsolationForestModel from a reference model's
    ``output``: ``normals`` [T, heap, F], ``offsets``, ``is_split`` and
    ``leaf`` [T, heap], ``ntrees``, ``x_cols``, ``feat_domains`` and
    ``cn``."""
    dev = resolve_device(device)
    arr = lambda k, dt: torch.as_tensor(np.array(output[k])).to(dev, dt)
    out = dict(normals=arr("normals", torch.float32),
               offsets=arr("offsets", torch.float32),
               is_split=arr("is_split", torch.bool),
               leaf=arr("leaf", torch.float32), ntrees=int(output["ntrees"]),
               x_cols=list(output["x_cols"]),
               feat_domains=dict(output.get("feat_domains") or {}),
               cn=float(output["cn"]))
    return _model(ExtendedIsolationForestModel, "extendedisolationforest",
                  out, None, None, params)


def _data_info(data_info: Mapping) -> DataInfo:
    """A DataInfo from the fields of the reference's
    (``dataclasses.asdict``)."""
    return DataInfo(
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


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32)).to(dev)


#: the GLM params scoring reads, with the reference GLM's defaults
_GLM_SCORING_PARAMS = dict(offset_column=None, interactions=None,
                           tweedie_variance_power=1.5, theta=1.0)


@_carries_cv
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
    di = _data_info(data_info)
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


@_carries_cv
def deeplearning_model(output: Mapping, data_info: Mapping,
                       response_column: str | None = None,
                       response_domain: tuple[str, ...] | None = None,
                       params: Mapping | None = None,
                       device: str | torch.device | None = None
                       ) -> DeepLearningModel:
    """The port's DeepLearningModel from a reference model: ``output`` with
    ``params`` (``{"W": [...], "b": [...]}`` as numpy), ``act``, ``sizes``
    and ``samples_trained``; ``params`` carries ``autoencoder`` for an
    autoencoder."""
    dev = resolve_device(device)
    w = output["params"]
    net = MLP([_tensor(a, dev) for a in w["W"]],
              [_tensor(a, dev) for a in w["b"]], str(output["act"]))
    for prm in net.parameters():
        prm.requires_grad_(False)
    out = dict(net=net, act=str(output["act"]),
               sizes=[int(s) for s in output["sizes"]],
               score_history=list(output.get("score_history") or []),
               samples_trained=float(output.get("samples_trained") or 0.0))
    return _model(DeepLearningModel, "deeplearning", out, response_column,
                  response_domain, params, _data_info(data_info))


@_carries_cv
def kmeans_model(output: Mapping, data_info: Mapping,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None) -> KMeansModel:
    """The port's KMeansModel from a reference model: ``output`` with
    ``centers_std`` (standardised, the space it assigns in), ``centers``,
    ``tot_withinss``, ``totss``, ``betweenss``, ``size`` and
    ``iterations``."""
    dev = resolve_device(device)
    out = dict(output, centers_std=_tensor(output["centers_std"], dev),
               centers=np.asarray(output["centers"], np.float64),
               size=np.asarray(output["size"]))
    return _model(KMeansModel, "kmeans", out, None, None, params,
                  _data_info(data_info))


@_carries_cv
def pca_model(output: Mapping, data_info: Mapping,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> PCAModel:
    """The port's PCAModel from a reference model: ``output`` with
    ``eigenvectors`` [P, k] and ``mu`` [P] (and its variance entries)."""
    out = dict(output, eigenvectors=_tensor(output["eigenvectors"],
                                            resolve_device(device)),
               mu=np.asarray(output["mu"], np.float32))
    return _model(PCAModel, "pca", out, None, None, params,
                  _data_info(data_info))


@_carries_cv
def svd_model(output: Mapping, data_info: Mapping,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> SVDModel:
    """The port's SVDModel from a reference model: ``output`` with ``v``
    [P, nv] and ``d`` [nv]."""
    out = dict(output, v=_tensor(output["v"], resolve_device(device)),
               d=np.asarray(output["d"], np.float64))
    return _model(SVDModel, "svd", out, None, None, params,
                  _data_info(data_info))


@_carries_cv
def glrm_model(output: Mapping, data_info: Mapping,
               params: Mapping | None = None,
               device: str | torch.device | None = None) -> GLRMModel:
    """The port's GLRMModel from a reference model: ``output`` with
    ``archetypes`` Y [k, P], ``gamma_x`` and ``objective``; ``x_factor``
    (the training rows' A) is left behind."""
    out = {k: v for k, v in output.items() if k != "x_factor"}
    out["archetypes"] = _tensor(output["archetypes"], resolve_device(device))
    out["gamma_x"] = float(output["gamma_x"])
    return _model(GLRMModel, "glrm", out, None, None, params,
                  _data_info(data_info))


@_carries_cv
def naive_bayes_model(output: Mapping, response_column: str | None = None,
                      response_domain: tuple[str, ...] | None = None,
                      params: Mapping | None = None,
                      device: str | torch.device | None = None
                      ) -> NaiveBayesModel:
    """The port's NaiveBayesModel from a reference model: ``output`` with
    ``log_prior`` [C], ``cat_logp`` (one [C, card] table per categorical
    column), ``mu`` and ``sd`` [C, P], ``cat_cols``, ``num_cols``,
    ``cat_domains`` and ``cards``."""
    dev = resolve_device(device)
    out = dict(log_prior=_tensor(output["log_prior"], dev),
               cat_logp=[_tensor(t, dev) for t in output["cat_logp"]],
               mu=_tensor(output["mu"], dev), sd=_tensor(output["sd"], dev),
               cat_cols=list(output["cat_cols"]),
               num_cols=list(output["num_cols"]),
               cat_domains=[tuple(d) for d in output["cat_domains"]],
               cards=tuple(int(c) for c in output["cards"]),
               class_counts=np.asarray(output.get("class_counts")))
    return _model(NaiveBayesModel, "naivebayes", out, response_column,
                  response_domain, params)


@_carries_cv
def isotonic_model(output: Mapping, response_column: str | None = None,
                   params: Mapping | None = None,
                   device: str | torch.device | None = None
                   ) -> IsotonicRegressionModel:
    """The port's IsotonicRegressionModel from a reference model's
    ``output``: ``thresholds_x``, ``thresholds_y``, ``min_x``, ``max_x``,
    ``x_col`` and ``nobs``; ``params`` carries ``out_of_bounds``."""
    dev = resolve_device(device)
    out = dict(thresholds_x=_tensor(output["thresholds_x"], dev),
               thresholds_y=_tensor(output["thresholds_y"], dev),
               min_x=float(output["min_x"]), max_x=float(output["max_x"]),
               x_col=str(output["x_col"]), nobs=int(output["nobs"]))
    return _model(IsotonicRegressionModel, "isotonicregression", out,
                  response_column, None, params)


@_carries_cv
def coxph_model(output: Mapping, data_info: Mapping,
                response_column: str | None = None,
                params: Mapping | None = None,
                device: str | torch.device | None = None) -> CoxPHModel:
    """The port's CoxPHModel from a reference model: ``output`` with
    ``coef`` [P], ``x_mean``, ``coef_names``, the baseline hazard
    (``baseline_times``, ``baseline_cumhaz``) and the training triplet of
    the concordance (``train_lp``, ``train_time``, ``train_event``);
    ``params`` carries ``stop_column``."""
    dev = resolve_device(device)
    f64 = ("se_coef", "baseline_times", "baseline_cumhaz", "train_lp",
           "train_time", "train_event")
    out = dict(output, coef=_tensor(output["coef"], dev),
               x_mean=np.asarray(output["x_mean"], np.float32),
               coef_names=list(output["coef_names"]),
               **{k: np.asarray(output[k], np.float64) for k in f64})
    return _model(CoxPHModel, "coxph", out, response_column, None, params,
                  _data_info(data_info))


@_carries_cv
def hglm_model(output: Mapping, data_info: Mapping,
               response_column: str | None = None,
               params: Mapping | None = None,
               device: str | torch.device | None = None) -> HGLMModel:
    """The port's HGLMModel from a reference model: ``output`` with the
    fixed effects ``beta`` [P+1], the random effects ``u`` [G, q] and
    their covariances ``u_var`` [G, q, q], and ``group_domain``;
    ``params`` carries ``group_column`` and ``random_columns``."""
    dev = resolve_device(device)
    out = dict(output, beta=_tensor(output["beta"], dev),
               u=_tensor(output["u"], dev),
               u_var=_tensor(output["u_var"], dev),
               coef=np.asarray(output["coef"], np.float32),
               coef_names=list(output["coef_names"]),
               group_domain=tuple(output["group_domain"]))
    return _model(HGLMModel, "hglm", out, response_column, None, params,
                  _data_info(data_info))


@_carries_cv
def psvm_model(output: Mapping, data_info: Mapping,
               response_column: str | None = None,
               response_domain: tuple[str, ...] | None = None,
               params: Mapping | None = None,
               device: str | torch.device | None = None) -> PSVMModel:
    """The port's PSVMModel from a reference model: ``output`` with the
    support vectors ``sv_x`` [S, P] (standardised design rows), their
    signed coefficients ``sv_coef``, ``sv_norms``, ``gamma`` and
    ``rho``."""
    dev = resolve_device(device)
    out = dict(output, sv_x=_tensor(output["sv_x"], dev),
               sv_coef=_tensor(output["sv_coef"], dev),
               sv_norms=_tensor(output["sv_norms"], dev),
               gamma=float(output["gamma"]), rho=float(output["rho"]))
    return _model(PSVMModel, "psvm", out, response_column, response_domain,
                  params, _data_info(data_info))


def _glm_of(spec: Mapping, device) -> GLMModel:
    """The port's GLMModel from an inner GLM given as a mapping of
    :func:`glm_model`'s arguments (``output``, ``data_info``,
    ``response_column``, ``response_domain``, ``params``)."""
    return glm_model(spec["output"], spec["data_info"],
                     spec.get("response_column"), spec.get("response_domain"),
                     spec.get("params"), device)


@_carries_cv
def model_selection_model(output: Mapping, best_model: Mapping,
                          response_column: str | None = None,
                          response_domain: tuple[str, ...] | None = None,
                          params: Mapping | None = None,
                          device: str | torch.device | None = None
                          ) -> ModelSelectionModel:
    """The port's ModelSelectionModel from a reference model: ``output``
    with ``results`` (each size's best subset) and ``best_per_size``;
    ``best_model`` the best GLM, as :func:`_glm_of` reads it."""
    out = dict(results=[dict(r) for r in output["results"]],
               best_per_size=dict(output.get("best_per_size") or {}),
               best_model=_glm_of(best_model, device))
    return _model(ModelSelectionModel, "modelselection", out,
                  response_column, response_domain, params)


@_carries_cv
def anova_glm_model(output: Mapping, full_model: Mapping,
                    response_column: str | None = None,
                    response_domain: tuple[str, ...] | None = None,
                    params: Mapping | None = None,
                    device: str | torch.device | None = None
                    ) -> ANOVAGLMModel:
    """The port's ANOVAGLMModel from a reference model: ``output`` with
    its F-test ``table``; ``full_model`` the GLM on every predictor, as
    :func:`_glm_of` reads it."""
    out = dict(table=[dict(r) for r in output["table"]],
               full_model=_glm_of(full_model, device))
    return _model(ANOVAGLMModel, "anovaglm", out, response_column,
                  response_domain, params)


@_carries_cv
def gam_model(output: Mapping, glm: Mapping,
              response_column: str | None = None,
              response_domain: tuple[str, ...] | None = None,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> GAMModel:
    """The port's GAMModel from a reference model: ``output`` with
    ``gam_columns``, ``bs``, ``knots`` (per entry, numpy), ``col_means``
    and ``gam_names``; ``glm`` the GLM on the expanded frame, as
    :func:`_glm_of` reads it."""
    out = dict(gam_columns=list(output["gam_columns"]),
               bs=[int(b) for b in output["bs"]],
               knots={k: np.asarray(v, np.float32)
                      for k, v in output["knots"].items()},
               col_means={k: float(v) for k, v in output["col_means"].items()},
               gam_names=list(output["gam_names"]),
               glm=_glm_of(glm, device))
    return _model(GAMModel, "gam", out, response_column, response_domain,
                  params)


@_carries_cv
def rulefit_model(output: Mapping, response_column: str | None = None,
                  response_domain: tuple[str, ...] | None = None,
                  params: Mapping | None = None,
                  device: str | torch.device | None = None) -> RuleFitModel:
    """The port's RuleFitModel from a reference model's ``output``:
    ``trees`` (the depth ladder's trees, each a dict of its heap arrays,
    as :func:`gbm_model` reads them), ``x_cols``, ``feat_domains``,
    ``rule_keep``, ``rule_names``, ``beta`` (the level-1 GLM's coefficients,
    the intercept last), ``model_type``, ``lin_mean`` and ``lin_sd``."""
    out = dict(trees=_trees(output["trees"], resolve_device(device)),
               x_cols=list(output["x_cols"]),
               feat_domains=dict(output.get("feat_domains") or {}),
               rule_keep=np.asarray(output["rule_keep"], bool),
               rule_names=list(output["rule_names"]),
               beta=np.asarray(output["beta"], np.float64),
               model_type=str(output["model_type"]),
               lin_mean=np.asarray(output["lin_mean"], np.float32),
               lin_sd=np.asarray(output["lin_sd"], np.float32))
    return _model(RuleFitModel, "rulefit", out, response_column,
                  response_domain, params)


#: the inner models an infogram's relevance surrogate may be
_SURROGATES = {"gbm": gbm_model, "drf": drf_model}


@_carries_cv
def infogram_model(output: Mapping, relevance_model: Mapping,
                   response_column: str | None = None,
                   response_domain: tuple[str, ...] | None = None,
                   params: Mapping | None = None,
                   device: str | torch.device | None = None) -> InfogramModel:
    """The port's InfogramModel from a reference model: ``output`` with
    ``all_predictor_names``, ``relevance``, ``cmi``, ``cmi_raw``,
    ``admissible_features``, ``protected_columns`` and ``build_core``;
    ``relevance_model`` the surrogate that scores, a mapping with its
    ``algo`` ("gbm", "drf" or "glm") and the arguments of
    :func:`gbm_model`, :func:`drf_model` or :func:`glm_model`."""
    spec = dict(relevance_model)
    algo = spec.pop("algo")
    if algo == "glm":
        rel = _glm_of(spec, device)
    else:
        rel = _SURROGATES[algo](spec["output"], spec.get("response_column"),
                                spec.get("response_domain"),
                                spec.get("params"), device)
    keys = ("all_predictor_names", "relevance", "cmi", "cmi_raw",
            "admissible_features", "protected_columns")
    out = {k: list(output[k]) for k in keys}
    out.update(build_core=bool(output["build_core"]), relevance_model=rel)
    return _model(InfogramModel, "infogram", out, response_column,
                  response_domain, params, rel.data_info)


@_carries_cv
def target_encoder_model(output: Mapping, response_column: str | None = None,
                         params: Mapping | None = None,
                         device: str | torch.device | None = None
                         ) -> TargetEncoderModel:
    """The port's TargetEncoderModel from a reference encoder's ``output``:
    ``lut`` (per column its [K + 1] level values, the last the NA slot),
    ``domains``, ``prior``, ``columns`` and ``data_leakage_handling``."""
    dev = resolve_device(device)
    out = dict(columns=list(output["columns"]),
               lut={c: _tensor(v, dev) for c, v in output["lut"].items()},
               domains={c: tuple(d) for c, d in output["domains"].items()},
               prior=float(output["prior"]),
               data_leakage_handling=str(output["data_leakage_handling"]),
               train_encoded=None)
    return _model(TargetEncoderModel, "targetencoder", out, response_column,
                  None, params)


@_carries_cv
def stacked_ensemble_model(output: Mapping, base_models: Sequence[Model],
                           metalearner: Model,
                           response_column: str | None = None,
                           response_domain: tuple[str, ...] | None = None,
                           params: Mapping | None = None,
                           device: str | torch.device | None = None
                           ) -> StackedEnsembleModel:
    """The port's StackedEnsembleModel from a reference ensemble:
    ``output`` with ``levelone_names`` (the metalearner's columns, in the
    base models' order); ``base_models`` and ``metalearner`` the port's
    models carried across by the functions above, in the reference's
    order."""
    out = dict(base_models=list(base_models), metalearner=metalearner,
               levelone_names=list(output["levelone_names"]))
    return _model(StackedEnsembleModel, "stackedensemble", out,
                  response_column, response_domain, params)


def word2vec_model(output: Mapping, params: Mapping | None = None,
                   device: str | torch.device | None = None
                   ) -> Word2VecModel:
    """The port's Word2VecModel from a reference model's ``output``:
    ``vectors`` ([V, D], numpy), ``vocab`` and its counters (``vec_size``,
    ``epochs_run``, ``n_pairs``, ``pre_trained``); ``word_index`` is
    rebuilt from ``vocab`` where absent and must agree with it."""
    dev = resolve_device(device)
    vocab = [str(w) for w in output["vocab"]]
    index = {w: i for i, w in enumerate(vocab)}
    if output.get("word_index") is not None and \
            dict(output["word_index"]) != index:
        raise ValueError("word_index does not number vocab in order")
    W = torch.as_tensor(np.asarray(output["vectors"], np.float32)).to(dev)
    out = dict(vectors=W, vocab=vocab, word_index=index,
               vec_size=int(output.get("vec_size", W.shape[1])),
               epochs_run=int(output.get("epochs_run", 0)),
               n_pairs=int(output.get("n_pairs", 0)))
    if output.get("pre_trained"):
        out["pre_trained"] = True
    return _model(Word2VecModel, "word2vec", out, None, None, params)


def grep_model(output: Mapping, params: Mapping | None = None,
               device: str | torch.device | None = None) -> GrepModel:
    """The port's GrepModel from a reference model's matches, as columns:
    ``output["matches"]`` = {"row": [...], "match": [...], "offset":
    [...]}."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    dev = resolve_device(device)
    m = output["matches"]
    frame = Frame(["row", "match", "offset"],
                  [Vec.from_numpy(np.asarray(m["row"], np.float32),
                                  device=dev),
                   Vec(None, VecType.STR,
                       host_values=np.array(list(m["match"]), dtype=object)),
                   Vec.from_numpy(np.asarray(m["offset"], np.float32),
                                  device=dev)])
    return _model(GrepModel, "grep", dict(matches=frame), None, None, params)
