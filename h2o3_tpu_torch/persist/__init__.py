"""Persistence of the port: frame snapshots and CSV export
(:mod:`~h2o3_tpu_torch.persist.frame_io`), binary models
(:mod:`~h2o3_tpu_torch.persist.model_io`), the cloud backends
(:mod:`~h2o3_tpu_torch.persist.cloud`) and the recovery of grids and long
builds (:mod:`~h2o3_tpu_torch.persist.recovery`)."""

from h2o3_tpu_torch.persist.frame_io import export_file, load_frame, save_frame
from h2o3_tpu_torch.persist.model_io import load_model, save_model
from h2o3_tpu_torch.persist.recovery import Recovery

__all__ = ["export_file", "load_frame", "save_frame",
           "load_model", "save_model", "Recovery"]
