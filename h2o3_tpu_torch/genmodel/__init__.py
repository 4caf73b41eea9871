"""Scoring artifacts and explainability — the port of ``h2o3_tpu/genmodel``
(reference: ``h2o-genmodel``: MOJO writers and readers, standalone
scorers, TreeSHAP). MOJOs are the JAX package's format both ways
(:mod:`~h2o3_tpu_torch.genmodel.mojo`); real H2O-3 zips are read by
:mod:`~h2o3_tpu_torch.genmodel.mojo_ref` and ``mojo_ref2``."""

from h2o3_tpu_torch.genmodel.codegen import download_pojo, generate_pojo
from h2o3_tpu_torch.genmodel.generic import Generic, GenericModel, import_mojo
from h2o3_tpu_torch.genmodel.mojo import MojoModel, write_mojo
from h2o3_tpu_torch.genmodel.pipeline import MojoPipeline, Transform
from h2o3_tpu_torch.genmodel.treeshap import ensemble_contributions, tree_shap

__all__ = ["Generic", "GenericModel", "MojoModel", "MojoPipeline",
           "Transform", "download_pojo", "ensemble_contributions",
           "generate_pojo", "import_mojo", "tree_shap", "write_mojo"]
