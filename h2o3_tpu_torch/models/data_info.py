"""Response handling — ``response_as_float`` from ``h2o3_tpu/models/data_info.py``."""

from __future__ import annotations

import torch


def response_as_float(vec) -> tuple[torch.Tensor, torch.Tensor]:
    """Response as float32 + per-row validity mask — THE canonical NA
    semantics for supervised training and metrics (categorical code -1 and
    numeric NaN are missing)."""
    if vec.is_categorical:
        return vec.data.float(), vec.data >= 0
    return vec.data, ~torch.isnan(vec.data)
