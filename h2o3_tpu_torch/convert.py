"""Carry a trained GBM across from the JAX package to the port.

:func:`gbm_model` takes a JAX ``GBMModel``'s ``output`` as plain numpy and
dicts — each tree a dict of its heap arrays — and returns the port's
``GBMModel`` on the chosen device, so the port can score a model trained by
the reference. It never imports the reference: the caller converts its tree
objects to dicts (``{k: np.asarray(getattr(tree, k)) for k in HEAP_FIELDS}``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.models.gbm import DISTRIBUTIONS, GBMModel
from h2o3_tpu_torch.models.model_base import make_model_key
from h2o3_tpu_torch.models.tree import HEAP_FIELDS, Tree

_HEAP_DTYPES = dict(feat=torch.int32, thresh_bin=torch.int32,
                    thresh_val=torch.float32, na_left=torch.bool,
                    is_split=torch.bool, leaf=torch.float32,
                    gain=torch.float32, cover=torch.float32)


def gbm_model(output: Mapping, response_column: str | None = None,
              response_domain: tuple[str, ...] | None = None,
              params: Mapping | None = None,
              device: str | torch.device | None = None) -> GBMModel:
    """The port's GBMModel from a reference model's ``output``: the heap
    arrays of every tree (``trees``: a list of dicts), ``edges``, ``f0``,
    ``learn_rate``, ``distribution``, ``x_cols`` and ``feat_domains``."""
    dev = resolve_device(device)
    dist = output["distribution"]
    if dist not in DISTRIBUTIONS:
        raise NotImplementedError(f"distribution {dist!r} is not ported yet")
    trees = []
    for t in output["trees"]:
        if t.get("left_mask") is not None:
            raise NotImplementedError("categorical group splits are not "
                                      "ported yet")
        trees.append(Tree(**{
            k: torch.as_tensor(np.array(t[k])).to(dev, _HEAP_DTYPES[k])
            for k in HEAP_FIELDS if t.get(k) is not None}))
    edges = torch.as_tensor(np.array(output["edges"], np.float32)).to(dev)
    return GBMModel(
        key=make_model_key("gbm", None), params=dict(params or {}),
        response_column=response_column,
        response_domain=tuple(response_domain) if response_domain else None,
        output=dict(trees=trees, edges=edges, f0=float(output["f0"]),
                    learn_rate=float(output["learn_rate"]), distribution=dist,
                    x_cols=list(output["x_cols"]),
                    feat_domains=dict(output.get("feat_domains") or {}),
                    ntrees=len(trees)))
