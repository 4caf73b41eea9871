"""Response and domain handling — ``response_as_float``,
``response_adapted`` and ``_remap_codes`` from
``h2o3_tpu/models/data_info.py``."""

from __future__ import annotations

import torch


def response_as_float(vec) -> tuple[torch.Tensor, torch.Tensor]:
    """Response as float32 + per-row validity mask — THE canonical NA
    semantics for supervised training and metrics (categorical code -1 and
    numeric NaN are missing)."""
    if vec.is_categorical:
        return vec.data.float(), vec.data >= 0
    return vec.data, ~torch.isnan(vec.data)


def remap_codes(codes: torch.Tensor, src_dom: tuple[str, ...],
                dst_dom: tuple[str, ...]) -> torch.Tensor:
    """Categorical codes of domain ``src_dom`` as codes of ``dst_dom``: a
    level ``dst_dom`` lacks, and a missing code, give -1 (reference:
    ``Model.adaptTestForTrain``'s domain mapping)."""
    dst = {s: i for i, s in enumerate(dst_dom)}
    lut = torch.tensor([dst.get(s, -1) for s in src_dom] or [-1],
                       dtype=torch.int32, device=codes.device)
    return torch.where(codes >= 0, lut[codes.clamp(0, lut.numel() - 1)
                                       .long()], -1)


def response_adapted(vec, train_domain) -> tuple[torch.Tensor, torch.Tensor]:
    """Response as float32 + validity, remapped to the training domain
    where a frame's categorical levels differ (unseen levels are
    invalid); else :func:`response_as_float`."""
    if train_domain and vec.is_categorical and vec.domain != train_domain:
        codes = remap_codes(vec.data, vec.domain or (), train_domain)
        return codes.float(), codes >= 0
    return response_as_float(vec)
