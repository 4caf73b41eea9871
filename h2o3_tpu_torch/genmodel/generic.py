"""Generic — an imported scoring artifact as a model of the port — the port
of ``h2o3_tpu/genmodel/generic.py``.

Reference: ``hex/generic/GenericModel.java``: an imported MOJO predicts,
computes metrics and sits in grids and leaderboards like a trained model.
Both MOJO formats come in: the JAX package's and the port's own
(:mod:`~h2o3_tpu_torch.genmodel.mojo`), scored by the port's models on the
chosen device, and real H2O-3 zips (:mod:`~h2o3_tpu_torch.genmodel.
mojo_ref`), scored on the host.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


class GenericModel(Model):
    algo = "generic"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        return self.output["mojo"]._score_raw(frame)

    def predict(self, frame: Frame) -> Frame:
        # the artifact knows its own prediction frame (an imported
        # isolation forest gives [predict, mean_length])
        inner = self.output["mojo"]
        if hasattr(inner, "predict"):
            return inner.predict(frame)
        return super().predict(frame)


class Generic(ModelBuilder):
    """h2o-py surface: ``H2OGenericEstimator(path=...)`` /
    ``h2o.import_mojo``. A MOJO of the port's (or the JAX package's)
    format scores on ``device`` (the card unless asked). A real H2O-3 zip
    is walked on the host in float64 whatever ``device`` says, and its
    scores are copied to the scored frame's device."""

    algo = "generic"
    unsupervised = True   # the response comes from the artifact

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), path=None, device=None)

    def train(self, x=None, y=None, training_frame=None, **kw):
        from h2o3_tpu_torch.genmodel.mojo import MojoModel
        from h2o3_tpu_torch.genmodel.mojo_ref import (is_reference_mojo,
                                                      load_ref_mojo)
        path = self.params.get("path")
        if not path:
            raise ValueError("path to a mojo artifact is required")
        dev = resolve_device(self.params.get("device"))
        if is_reference_mojo(path):
            # a real H2O-3 MOJO zip (model.download_mojo() of H2O-3):
            # a host walk, so ``dev`` does not apply
            inner = load_ref_mojo(path)
            mojo = inner
        else:
            mojo = MojoModel.load(path, device=dev)
            inner = mojo._inner
        model = GenericModel(
            key=make_model_key(self.algo, self.model_id),
            params={k: v for k, v in self.params.items() if k != "device"},
            data_info=None, response_column=inner.response_column,
            response_domain=inner.response_domain,
            output=dict(mojo=mojo, source_algo=mojo.algo))
        # the artifact's decision threshold (max-F1 at training) makes the
        # labels of predict, as EasyPredict's do
        thr = getattr(inner, "_default_threshold", None)
        if thr is not None:
            model._default_threshold = float(thr)
        if training_frame is not None and inner.response_column is not None \
                and inner.response_column in training_frame:
            model.training_metrics = model.model_performance(training_frame)
        from h2o3_tpu_torch.utils.registry import DKV
        DKV.put(model.key, model)
        self.model = model
        return model


def import_mojo(path: str, model_id: str | None = None,
                device: str | torch.device | None = None) -> GenericModel:
    """h2o-py: ``h2o.import_mojo`` — one-call artifact import."""
    return Generic(path=path, model_id=model_id, device=device).train()
