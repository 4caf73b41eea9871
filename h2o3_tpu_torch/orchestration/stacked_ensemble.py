"""StackedEnsemble — a metalearner over the base models' out-of-fold
predictions — the port of ``h2o3_tpu/orchestration/stacked_ensemble.py``.

Reference: ``hex/ensemble/StackedEnsemble.java``: the base models'
cross-validation holdout predictions make the level-one frame, a
metalearner (by default a GLM with non-negative weights) trains on it, and
scoring runs every base model and then the metalearner. The level-one
columns are the kept out-of-fold tensors themselves
(``keep_cross_validation_predictions``), on the frame's device, and the
metalearner trains only on the rows every base model has a holdout
prediction for. A base model scores through its ``preprocessors`` (AutoML's
target encoding of its tree steps), where the JAX package's ensemble
scores the frame as given.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import (Model, ModelBuilder,
                                              make_model_key)


def _base_columns(model: Model, raw: torch.Tensor) -> list:
    """The columns a base model gives the level-one frame: p(class) for a
    classifier, the last (redundant) class dropped; the prediction for a
    regression."""
    if model.nclasses == 2:
        return [raw[:, 1]]
    if model.nclasses > 2:
        return [raw[:, k] for k in range(model.nclasses - 1)]
    return [raw]


def _levelone(cols: list) -> list[Vec]:
    return [Vec.from_device(c.contiguous(), VecType.NUM) for c in cols]


class StackedEnsembleModel(Model):
    algo = "stackedensemble"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        cols = []
        for bm in self.output["base_models"]:
            cols.extend(_base_columns(bm, bm._score_raw(bm._preprocess(
                frame))))
        names = list(self.output["levelone_names"])
        return self.output["metalearner"]._score_raw(
            Frame(names, _levelone(cols)))


class StackedEnsemble(ModelBuilder):
    """h2o-py surface: ``H2OStackedEnsembleEstimator``."""

    algo = "stackedensemble"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            base_models=[],
            metalearner_algorithm="AUTO",   # AUTO: GLM (reference default)
            metalearner_params=None,
        )

    def train(self, x=None, y=None, training_frame=None, **kw):
        base = self.params["base_models"]
        if not base:
            raise ValueError("base_models is required")
        if any(m.cv_holdout_predictions is None for m in base):
            raise ValueError("all base models need "
                             "keep_cross_validation_predictions=True and "
                             "nfolds>=2")
        return super().train(x=x, y=y, training_frame=training_frame, **kw)

    def _fit(self, job: Job, frame: Frame, x, y,
             weights) -> StackedEnsembleModel:
        p = self.params
        base: list[Model] = list(p["base_models"])
        yvec = frame.vec(y)
        for m in base:
            if m.response_column != y:
                raise ValueError(f"base model {m.key} trained on response "
                                 f"{m.response_column!r}, not {y!r}")
        cols, names = [], []
        hold = None
        for m in base:
            for i, c in enumerate(_base_columns(m, m.cv_holdout_predictions)):
                cols.append(c)
                names.append(f"{m.key}_{i}")
            hold = m.cv_holdout_mask if hold is None \
                else hold & m.cv_holdout_mask
        lvl1 = Frame(names + [y], _levelone(cols) + [yvec])

        algo = str(p["metalearner_algorithm"]).upper()
        mparams = dict(p["metalearner_params"] or {})
        if algo in ("AUTO", "GLM"):
            from h2o3_tpu_torch.models.glm import GLM
            if algo == "AUTO":
                # the reference's default metalearner: non-negative GLM
                mparams.setdefault("non_negative", True)
                mparams.setdefault("lambda_", 0.0)
            family = ("binomial" if yvec.cardinality() == 2 else
                      "multinomial" if yvec.is_categorical else "gaussian")
            mparams.setdefault("family", family)
            mbuilder = GLM(**mparams)
        elif algo == "GBM":
            from h2o3_tpu_torch.models.gbm import GBM
            mbuilder = GBM(**mparams)
        elif algo == "DRF":
            from h2o3_tpu_torch.models.gbm import DRF
            mbuilder = DRF(**mparams)
        elif algo == "DEEPLEARNING":
            from h2o3_tpu_torch.models.deeplearning import DeepLearning
            mbuilder = DeepLearning(**mparams)
        else:
            raise ValueError(f"unsupported metalearner_algorithm {algo!r}")
        meta = mbuilder.train(x=names, y=y, training_frame=lvl1,
                              weights=weights * hold)
        return StackedEnsembleModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(base_models=base, metalearner=meta,
                        levelone_names=names))
