"""Model / ModelBuilder — a minimal port of ``h2o3_tpu/models/model_base.py``.

Every algorithm trains against a per-row weight vector (0 = excluded) and
scores through ``Model._score_raw``, which maps a frame to predictions on
its device. Training metrics come from the predictions the fit already made
(``ModelBuilder._last_train_raw``), not from re-scoring the frame; a
``validation_frame`` is scored into ``validation_metrics`` and handed to
builders that score it while they train (early stopping). ``checkpoint=``
takes a trained Model of the port to resume from. An ``unsupervised``
builder (the isolation forests) trains with ``y=None``. The reference's
cross-validation, DKV (checkpoints by key), locks, auto-recovery,
telemetry and mesh slices are left out of this slice.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Sequence

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import (response_adapted,
                                             response_as_float)
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.metrics import (binomial_metrics,
                                           multinomial_metrics,
                                           regression_metrics)


class Model:
    """A trained model: artifacts + scoring + metrics (reference: ``hex.Model``)."""

    algo = "model"

    def __init__(self, key: str, params: dict, response_column: str | None,
                 response_domain: tuple[str, ...] | None,
                 output: dict[str, Any], data_info=None):
        self.key = key
        # the design layout of builders that train on DataInfo.expand
        self.data_info = data_info
        self.params = dict(params)   # a snapshot: the builder stays reusable
        self.response_column = response_column
        self.response_domain = response_domain  # None for regression
        self.output = output
        self.training_metrics = None
        self.validation_metrics = None
        # (columns, rows) of the per-tree scoring history, or None
        self.scoring_history = None
        self.run_time_ms: int = 0

    @property
    def nclasses(self) -> int:
        return len(self.response_domain) if self.response_domain else 0

    @property
    def is_classifier(self) -> bool:
        return self.nclasses >= 2

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        """Predictions on the frame's device: [rows] for regression,
        [rows, nclasses] probabilities for classification."""
        raise NotImplementedError

    def predict(self, frame: Frame) -> Frame:
        """Score a frame (reference: ``Model.score`` → prediction frame)."""
        raw = self._score_raw(frame)
        if not self.is_classifier:
            return Frame(["predict"], [Vec.from_device(raw, VecType.NUM)])
        labels = decision_labels(raw).to(torch.int32)
        names = ["predict"] + [f"p{d}" for d in self.response_domain]
        vecs = [Vec.from_device(labels, VecType.CAT, domain=self.response_domain)]
        vecs += [Vec.from_device(raw[:, k].contiguous(), VecType.NUM)
                 for k in range(self.nclasses)]
        return Frame(names, vecs)

    def model_performance(self, frame: Frame):
        """Metrics of this model on a frame that holds the response (a
        categorical response remapped to the training domain; unseen levels
        are left out)."""
        if self.response_column not in frame:
            raise ValueError(f"frame lacks response column {self.response_column!r}")
        y, valid = response_adapted(
            frame.vec(self.response_column),
            self.response_domain if self.is_classifier else None)
        return compute_metrics(self._score_raw(frame), y, valid, self.nclasses)

    def __repr__(self) -> str:
        lines = [f"{type(self).__name__}(key={self.key!r})"]
        if self.training_metrics:
            lines.append(f"  train: {self.training_metrics!r}")
        if self.validation_metrics:
            lines.append(f"  valid: {self.validation_metrics!r}")
        return "\n".join(lines)


def decision_labels(raw: torch.Tensor) -> torch.Tensor:
    """Class labels from [n, K] probabilities (argmax; for binomial that is
    the 0.5 threshold)."""
    return raw.argmax(dim=1)


def compute_metrics(raw: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    nclasses: int):
    if nclasses == 0:
        return regression_metrics(raw, y, mask)
    if nclasses == 2:
        return binomial_metrics(raw[:, 1].contiguous(), y, mask)
    return multinomial_metrics(raw, y, mask, nclasses)


class ModelBuilder:
    """Algorithm training base (reference: ``hex.ModelBuilder``: validate
    params → fit → training metrics)."""

    algo = "base"
    #: a builder that trains without a response (``y=None``)
    unsupervised = False
    #: whether a categorical response is taken
    supports_classification = True
    #: whether a numeric response is taken
    supports_regression = True

    def __init__(self, **params):
        self.params = self.defaults()
        unknown = set(params) - set(self.params) - {"model_id"}
        if unknown:
            raise ValueError(f"{type(self).__name__}: unknown parameters "
                             f"{sorted(unknown)}; valid: {sorted(self.params)}")
        self.params.update(params)
        self.model_id = params.get("model_id")
        self.job: Job | None = None
        self.model: Model | None = None
        self._last_train_raw = None

    @classmethod
    def defaults(cls) -> dict:
        return dict(seed=-1, weights_column=None, ignored_columns=None,
                    checkpoint=None)   # a trained Model to resume from

    def _resolve_checkpoint(self) -> Model | None:
        """The ``checkpoint`` parameter as a Model of the port (reference:
        ``Model.Parameters._checkpoint``); a model key needs the DKV, which
        the port does not have yet."""
        cp = self.params.get("checkpoint")
        if cp is None:
            return None
        held = getattr(self, "_checkpoint_model", None)
        if held is not None and cp == held.key:
            cp = held
        if not isinstance(cp, Model):
            raise NotImplementedError(
                f"checkpoint={cp!r}: resuming from a model key needs the "
                "DKV, which the port does not have yet; pass the Model")
        if cp.algo != self.algo:
            raise ValueError(f"checkpoint is a {cp.algo!r} model; "
                             f"this builder is {self.algo!r}")
        # the parameters (and the models' snapshots of them) keep the key,
        # not the prior model's trees
        self._checkpoint_model = cp
        self.params["checkpoint"] = cp.key
        return cp

    def _refuse_checkpoint(self) -> None:
        """Builders that do not resume raise on ``checkpoint``."""
        if self.params.get("checkpoint") is not None:
            raise ValueError(f"{self.algo} does not resume from a checkpoint")

    def _fit(self, job: Job, frame: Frame, x: list[str], y: str | None,
             weights: torch.Tensor) -> Model:
        """Train on rows where weights > 0."""
        raise NotImplementedError

    def train(self, x: Sequence[str] | None = None, y: str | None = None,
              training_frame: Frame | None = None,
              validation_frame: Frame | None = None,
              weights=None) -> Model:
        """Train on ``training_frame``, on the frame's device (reference:
        h2o-py ``estimator.train``); with a ``validation_frame``, score it
        into ``model.validation_metrics`` (builders that stop early score
        it per tree too). ``weights`` (one per row) multiply the
        ``weights_column``'s."""
        frame = training_frame
        if frame is None:
            raise ValueError("training_frame is required")
        if y is None and not self.unsupervised:
            raise ValueError(f"{self.algo} is supervised: y is required")
        ignored = set(self.params.get("ignored_columns") or [])
        for col in ("weights_column", "offset_column"):
            if self.params.get(col):
                ignored.add(self.params[col])
        x = [c for c in (x if x is not None else frame.names)
             if c != y and c not in ignored and frame.vec(c).type.on_device]
        if not x:
            raise ValueError("no usable feature columns")
        self._validate(frame, x, y)
        if validation_frame is not None and \
                validation_frame.device != frame.device:
            raise ValueError(f"validation_frame is on "
                             f"{validation_frame.device}, training_frame on "
                             f"{frame.device}")
        base_w = frame.row_mask().float()
        if self.params.get("weights_column"):
            base_w = base_w * frame.vec(self.params["weights_column"]).data
        if weights is not None:
            base_w = base_w * torch.as_tensor(weights, dtype=torch.float32,
                                              device=frame.device)
        # a builder that drops rows from the fit (GLM's Skip) sets the
        # weights its metrics must see
        self._metrics_weights = None
        # for builders that score held-out data while they train
        self._validation_frame = validation_frame
        self._x_cols, self._y_col = x, y
        self._score_series = None
        self.job = Job(f"{self.algo} on {frame.key or 'frame'}")
        t0 = time.time()

        def fit(job: Job) -> Model:
            model = self._fit(job, frame, x, y, base_w)
            model.run_time_ms = int((time.time() - t0) * 1000)
            w_metrics = self._metrics_weights
            if y is not None:
                model.training_metrics = self._holdout_metrics(
                    model, frame, y,
                    base_w if w_metrics is None else w_metrics)
            if validation_frame is not None and y is not None:
                model.validation_metrics = model.model_performance(
                    validation_frame)
            model.scoring_history = self._scoring_history(model)
            return model

        self.model = self.job.run(fit).result
        if self.job.status == Job.FAILED:
            raise self.job.exception
        return self.model

    def _validate(self, frame: Frame, x: list[str], y: str | None) -> None:
        """Refuse a response the builder cannot train on (reference
        ``ModelBuilder._validate``)."""
        if y is None:
            return
        if frame.vec(y).is_categorical and not self.supports_classification:
            raise ValueError(f"{self.algo} does not support a categorical "
                             "response")
        if not frame.vec(y).is_categorical and not self.supports_regression:
            raise ValueError(f"{self.algo} requires a categorical response")

    def _scoring_history(self, model: Model):
        """The per-tree scoring table of iterative builders (reference
        ``SharedTree.java:798`` ``doScoringAndSaveModel``), or None."""
        return None

    def _history_table(self, model: Model, value_cols, values):
        """Scoring-history rows with their timestamp and duration columns:
        ``value_cols`` [(name, type, format), ...], ``values`` one list per
        scoring event; the duration is interpolated over the training's
        wall time. Returns (columns, rows), or None without events."""
        if not values:
            return None
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        total_s = model.run_time_ms / 1000.0
        n = len(values)
        cols = [("timestamp", "string", "%s"),
                ("duration", "string", "%s")] + list(value_cols)
        rows = [[stamp, f"{total_s * (i + 1) / n:.3f} sec", *vals]
                for i, vals in enumerate(values)]
        return cols, rows

    def _holdout_metrics(self, model: Model, frame: Frame, y: str,
                         w: torch.Tensor):
        """Training metrics from the fit's own final predictions when it
        cached them (the boosting loop's margins), else by scoring."""
        raw = self._last_train_raw
        self._last_train_raw = None
        if raw is None:
            raw = model._score_raw(frame)
        yy, valid = response_as_float(frame.vec(y))
        return compute_metrics(raw, yy, (w > 0) & valid, model.nclasses)


def make_model_key(algo: str, model_id: str | None) -> str:
    return model_id or f"{algo}_{uuid.uuid4().hex[:10]}"
