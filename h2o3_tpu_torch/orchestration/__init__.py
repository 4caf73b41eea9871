"""Orchestration of the port: grid search, leaderboard, stacked ensembles,
AutoML and segment models (reference: ``hex/grid/``,
``hex/leaderboard/``, ``hex/ensemble/``, ``ai/h2o/automl/``,
``hex/segments/``), the same names as ``h2o3_tpu.orchestration``.
"""

from h2o3_tpu_torch.orchestration.automl import AutoML, EventLog
from h2o3_tpu_torch.orchestration.grid import Grid, GridSearch
from h2o3_tpu_torch.orchestration.leaderboard import Leaderboard
from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler, SLICE_STATS
from h2o3_tpu_torch.orchestration.segments import SegmentModels, train_segments
from h2o3_tpu_torch.orchestration.stacked_ensemble import (
    StackedEnsemble, StackedEnsembleModel)

__all__ = [
    "AutoML", "EventLog", "Grid", "GridSearch", "Leaderboard",
    "MeshScheduler", "SLICE_STATS",
    "StackedEnsemble", "StackedEnsembleModel",
    "SegmentModels", "train_segments",
]
