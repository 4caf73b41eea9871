"""Persistence of the port: frame snapshots and CSV export
(:mod:`~h2o3_tpu_torch.persist.frame_io`), the cloud backends
(:mod:`~h2o3_tpu_torch.persist.cloud`) and the grid's canonical combo key
(:mod:`~h2o3_tpu_torch.persist.recovery`)."""
