"""Model / ModelBuilder — a minimal port of ``h2o3_tpu/models/model_base.py``.

Every algorithm trains against a per-row weight vector (0 = excluded) and
scores through ``Model._score_raw``, which maps a frame to predictions on
its device. Training metrics come from the predictions the fit already made
(``ModelBuilder._last_train_raw``), not from re-scoring the frame; a
``validation_frame`` is scored into ``validation_metrics`` and handed to
builders that score it while they train (early stopping). ``checkpoint=``
takes a trained Model of the port to resume from. An ``unsupervised``
builder (the isolation forests) trains with ``y=None``.

Cross-validation (``nfolds`` or a ``fold_column``) masks weights, as the
reference does: each fold's model trains on the whole frame with the
fold's rows at weight 0, and the holdout predictions of all folds are
pooled into one metrics pass (``cross_validation_metrics``), kept with
``keep_cross_validation_predictions``, and summarised per fold
(``cv_metrics_summary``). A finished model is put into the DKV
(``utils/registry.py``) under its key, and a build holds the write lock on
its ``model_id`` from its first fit to that put; ``checkpoint=`` takes a
Model or the key of one in the DKV. ``train`` reports
``model_build_start`` and ``model_build_end`` to the Extensions SPI
(:mod:`h2o3_tpu_torch.utils.extensions`). A build runs as a
``<algo>:fit`` span and timeline event under the ``fit:<algo>`` cost scope,
and counts into ``h2o3_model_builds_total`` and
``h2o3_model_build_seconds``; ``max_runtime_secs`` is its job's deadline
(builders that keep partial results stop and return them). The reference's
mesh slices are left out.

Under a mesh of W > 1 ranks (``parallel/``) a :attr:`ModelBuilder.
rank_aware` builder (GBM, XGBoost's gbtree, GLM) trains on the row blocks
of a frame made under the mesh: every rank runs the same fit on its block
and the fit's sums are reduced over the ranks, so every rank ends with
the model of all the rows; its predictions stay row-blocked. Every other
builder, and the options that are not rank-aware yet
(:attr:`ModelBuilder.mesh_refused`), raise
:class:`~h2o3_tpu_torch.parallel.mesh.MeshUnsupported` there.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Sequence

import numpy as np
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
from h2o3_tpu_torch.ops.hist import mesh_rows
from h2o3_tpu_torch.ops.map_reduce import mesh_reduce
from h2o3_tpu_torch.parallel.mesh import (MeshUnsupported,
                                          num_global_devices, refuse_on_mesh)
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils.costs import COSTS
from h2o3_tpu_torch.utils.registry import DKV, LOCKS
from h2o3_tpu_torch.utils.timeline import timed_event


def publish_dispatch_audit(builder, loop: str, iterations: int,
                           host_syncs: int, device_dispatches: int) -> None:
    """Record a convergence loop's host-sync economy: how many blocking
    device→host fetches and dispatches the loop paid for how many logical
    iterations. Feeds ``h2o3_dispatches_per_iteration{loop}`` and the
    builder's ``_dispatch_audit``. Every count is one the loop kept on the
    host."""
    iters = max(int(iterations), 1)
    audit = getattr(builder, "_dispatch_audit", None)
    if audit is None:
        audit = builder._dispatch_audit = {}
    audit[loop] = dict(iterations=int(iterations),
                       host_syncs=int(host_syncs),
                       device_dispatches=int(device_dispatches),
                       syncs_per_iteration=round(host_syncs / iters, 4))
    _tm.DISPATCHES_PER_ITER.labels(loop=loop).set(host_syncs / iters)


def _weight_rollup(w: torch.Tensor) -> torch.Tensor:
    """(rows with weight, weight sum) of this rank's rows — the MRTask row
    count over the weights the fit used (Skip rows carry weight 0)."""
    return torch.stack([(w > 0).float().sum(), w.sum()])


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
        self.cross_validation_metrics = None
        # out-of-fold predictions ([rows] or [rows, K]) and the rows that
        # have one, with keep_cross_validation_predictions
        self.cv_holdout_predictions = None
        self.cv_holdout_mask = None
        # (metric names, nfolds, rows of [name, mean, sd, fold values...])
        self.cv_metrics_summary = None
        # (columns, rows) of the per-tree scoring history, or None
        self.scoring_history = None
        self.run_time_ms: int = 0
        # transformers applied to every frame scored by predict and
        # model_performance (AutoML's target encoding of the tree steps)
        self.preprocessors: list = []

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

    def _preprocess(self, frame: Frame) -> Frame:
        """The frame through each of ``preprocessors`` not yet applied."""
        for p in self.preprocessors:
            if hasattr(p, "is_applied") and p.is_applied(frame):
                continue
            frame = p.transform(frame)
        return frame

    def predict(self, frame: Frame) -> Frame:
        """Score a frame (reference: ``Model.score`` → prediction frame)."""
        frame = self._preprocess(frame)
        raw = self._score_raw(frame)
        if not self.is_classifier:
            return _blocked_like(frame, Frame(
                ["predict"], [Vec.from_device(raw, VecType.NUM)]))
        labels = decision_labels(raw, self).to(torch.int32)
        names = ["predict"] + [f"p{d}" for d in self.response_domain]
        vecs = [Vec.from_device(labels, VecType.CAT, domain=self.response_domain)]
        vecs += [Vec.from_device(raw[:, k].contiguous(), VecType.NUM)
                 for k in range(self.nclasses)]
        return _blocked_like(frame, Frame(names, vecs))

    def model_performance(self, frame: Frame):
        """Metrics of this model on a frame that holds the response (a
        categorical response remapped to the training domain; unseen levels
        are left out)."""
        if self.response_column not in frame:
            raise ValueError(f"frame lacks response column {self.response_column!r}")
        frame = self._preprocess(frame)
        y, valid = response_adapted(
            frame.vec(self.response_column),
            self.response_domain if self.is_classifier else None)
        return compute_metrics(self._score_raw(frame), y, valid, self.nclasses)

    def download_mojo(self, path: str) -> str:
        """Export a portable scoring artifact (h2o-py: ``download_mojo``)."""
        from h2o3_tpu_torch.genmodel.mojo import write_mojo
        return write_mojo(self, path)

    def download_pojo(self, path: str) -> str:
        """Export standalone numpy scoring source (h2o-py:
        ``download_pojo``)."""
        from h2o3_tpu_torch.genmodel.codegen import download_pojo
        return download_pojo(self, path)

    def save(self, path: str) -> str:
        """Binary model save (h2o-py: ``h2o.save_model``)."""
        from h2o3_tpu_torch.persist.model_io import save_model
        return save_model(self, path)

    def __repr__(self) -> str:
        lines = [f"{type(self).__name__}(key={self.key!r})"]
        if self.training_metrics:
            lines.append(f"  train: {self.training_metrics!r}")
        if self.validation_metrics:
            lines.append(f"  valid: {self.validation_metrics!r}")
        return "\n".join(lines)


def _blocked_like(frame: Frame, out: Frame) -> Frame:
    """``out`` (computed on ``frame``'s rows) as a row-blocked frame where
    ``frame`` is one: each rank's predictions of its block, gathered by
    ``fetch`` or ``to_numpy``."""
    if frame.block is not None:
        for v in out.vecs:
            v.block = frame.block
    return out


def decision_labels(raw: torch.Tensor, model=None) -> torch.Tensor:
    """Class labels from [n, K] probabilities: argmax, or for a binomial
    model whose threshold was reset (``model.reset.threshold``, reference
    ``AstModelResetThreshold``) p1 at or above it."""
    thr = getattr(model, "_default_threshold", None)
    if thr is not None and raw.shape[1] == 2:
        return (raw[:, 1] >= float(thr)).to(torch.int64)
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
    #: whether the builder trains across the ranks of a mesh (each rank on
    #: its row block, the fit's sums reduced over the ranks); the others
    #: raise MeshUnsupported under a mesh of more than one rank
    rank_aware = False
    #: parameters a rank-aware builder does not take across ranks yet:
    #: each raises MeshUnsupported there when set
    mesh_refused = ("nfolds", "fold_column", "checkpoint",
                    "custom_metric_func", "auto_recovery_dir")

    def __init__(self, **params):
        self.params = self.defaults()
        unknown = set(params) - set(self.params) - {"model_id"}
        if unknown:
            raise ValueError(f"{type(self).__name__}: unknown parameters "
                             f"{sorted(unknown)}; valid: {sorted(self.params)}")
        self.params.update(params)
        if float(self.params.get("max_runtime_secs") or 0.0) < 0:
            # hex.ModelBuilder.init: 0 means unlimited, below is an error
            raise ValueError("max_runtime_secs must be >= 0 (0 for "
                             "unlimited)")
        self.model_id = params.get("model_id")
        self.job: Job | None = None
        self.model: Model | None = None
        self._last_train_raw = None

    @classmethod
    def defaults(cls) -> dict:
        return dict(seed=-1, weights_column=None, ignored_columns=None,
                    checkpoint=None,   # a trained Model to resume from
                    nfolds=0,
                    # Modulo | Random | Stratified (hex/FoldAssignment.java)
                    fold_assignment="Modulo",
                    fold_column=None,  # per-row fold ids
                    keep_cross_validation_predictions=False,
                    # the job's deadline: builders that keep partial
                    # results stop and return them, the others cancel
                    max_runtime_secs=0.0,
                    # a callable (preds, y, w) -> value, or the reference
                    # "python:KEY=module.Class" of an uploaded UDF
                    custom_metric_func=None,
                    # the snapshot directory of a long build (reference
                    # -auto_recovery_dir): builders that snapshot write a
                    # partial model every H2O3TPU_CHECKPOINT_EVERY trees or
                    # epochs, and a train() with the same dir and params
                    # resumes from it through checkpoint=
                    auto_recovery_dir=None)

    def validate_request(self) -> None:
        """Fail-fast validation the REST layer runs BEFORE starting the
        background job (reference ``ModelBuilder.validate_request``): raise
        ``ValueError`` for a request no build could ever satisfy. The
        port's builders refuse unknown and unapplied parameters in
        ``__init__`` already, so the base has nothing more to check."""

    def _check_mesh(self, frame: Frame,
                    validation_frame: Frame | None) -> None:
        """Under a mesh of W > 1 ranks: refuse a builder or an option that
        is not rank-aware, and a frame that is not row-blocked (made before
        the cloud formed: every rank would train on all its rows and the
        reductions would count each row W times)."""
        n = num_global_devices()
        if n == 1:
            return
        if not self.rank_aware:
            refuse_on_mesh(f"the {self.algo} builder")
        for p in self.mesh_refused:
            if self.params.get(p):
                refuse_on_mesh(f"{self.algo}'s {p}")
        for what, f in (("training_frame", frame),
                        ("validation_frame", validation_frame)):
            if f is not None and f.block is None:
                raise MeshUnsupported(
                    f"{what} holds all its rows on this rank: under a mesh "
                    f"of {n} ranks a builder trains on a frame made after "
                    "the cloud formed, cut into row blocks")

    def supports_auto_recovery(self) -> bool:
        """Whether this builder writes snapshots under
        ``auto_recovery_dir`` (GBM and XGBoost gbtree every few trees,
        DeepLearning every few epochs). The others ignore the directory
        and advertise nothing, as the reference's do."""
        return False

    def _resolve_checkpoint(self) -> Model | None:
        """The ``checkpoint`` parameter as a Model of the port (reference:
        ``Model.Parameters._checkpoint``): a Model, or the key of one in
        the DKV. The parameters (and the models' snapshots of them) keep
        the key, not the prior model's trees; the builder holds the model,
        so a fold's builder resumes from it by key."""
        cp = self.params.get("checkpoint")
        if cp is None:
            return None
        held = getattr(self, "_checkpoint_model", None)
        if isinstance(cp, Model):
            model = cp
        elif held is not None and cp == held.key:
            model = held
        else:
            model = DKV.get(cp)
            if model is None:
                raise ValueError(f"checkpoint model {cp!r} not found in DKV")
        if model.algo != self.algo:
            raise ValueError(f"checkpoint is a {model.algo!r} model; "
                             f"this builder is {self.algo!r}")
        self._checkpoint_model = model
        self.params["checkpoint"] = model.key
        return model

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
        for col in ("weights_column", "offset_column", "fold_column"):
            if self.params.get(col):
                ignored.add(self.params[col])
        x = [c for c in (x if x is not None else frame.names)
             if c != y and c not in ignored and frame.vec(c).type.on_device]
        if not x:
            raise ValueError("no usable feature columns")
        self._check_mesh(frame, validation_frame)
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
        nfolds = self._check_folds(frame)
        self._begin_fit(x, y, validation_frame)
        resumed = self._begin_recovery(frame.device)
        self.job = Job(f"{self.algo} on {frame.key or 'frame'}",
                       max_runtime_secs=float(
                           self.params.get("max_runtime_secs") or 0.0))
        self.job.auto_recovery_dir = (self._build_recovery.dir
                                      if self._build_recovery else None)
        t0 = time.time()

        def fit(job: Job) -> Model:
            # the write lock on the named destination key from the first
            # fit to the DKV put (reference: water/Lockable.java); a
            # generated key is unguessable and needs none
            with LOCKS.write(self.model_id):
                return locked_fit(job)

        def locked_fit(job: Job) -> Model:
            from h2o3_tpu_torch.utils import extensions as _ext
            _ext.report("model_build_start", algo=self.algo, job=job.key,
                        frame=frame.key)
            # the build's span and timeline event, under the cost scope
            # that credits its kernel builds to this algo
            with timed_event("model", f"{self.algo}:fit"), \
                    COSTS.scope(f"fit:{self.algo}"), mesh_rows(frame.nrows):
                model = self._fit(job, frame, x, y, base_w)
            model.run_time_ms = int((time.time() - t0) * 1000)
            _tm.MODEL_BUILDS.labels(algo=self.algo).inc()
            _tm.MODEL_BUILD_SECONDS.labels(algo=self.algo).observe(
                model.run_time_ms / 1000.0)
            w_metrics = self._metrics_weights
            if w_metrics is None:
                w_metrics = base_w
            if num_global_devices() > 1:
                # rows with weight and the weight sum over every rank's rows
                nobs, wsum = mesh_reduce(_weight_rollup, w_metrics).tolist()
                model.output.setdefault("effective_nobs", int(nobs))
                model.output.setdefault("weight_sum", wsum)
            if y is not None:
                model.training_metrics = self._holdout_metrics(
                    model, frame, y, w_metrics)
            if validation_frame is not None and y is not None:
                model.validation_metrics = model.model_performance(
                    validation_frame)
            cmf = self._custom_metric(model) if y is not None else None
            if cmf is not None:
                self._apply_custom_metric(model, frame, y, w_metrics, cmf,
                                          model.training_metrics)
                if validation_frame is not None:
                    wc = self.params.get("weights_column")
                    vw = (validation_frame.vec(wc).data
                          if wc and wc in validation_frame else None)
                    self._apply_custom_metric(model, validation_frame, y, vw,
                                              cmf, model.validation_metrics)
            # taken before the fold fits below
            model.scoring_history = self._scoring_history(model)
            if nfolds >= 2 and y is not None:
                model.cross_validation_metrics = self._cross_validate(
                    job, frame, x, y, w_metrics, nfolds, model)
            DKV.put(model.key, model)
            _ext.report("model_build_end", algo=self.algo, model=model.key,
                        job=job.key)
            return model

        if getattr(self, "_cancel_requested_early", False):
            # a REST cancel raced the job's creation (api/server.py
            # _run_build_job): honour it before the build starts
            self.job.cancel()
        try:
            self.model = self.job.run(fit).result
        finally:
            if resumed is not None:
                # the snapshot has served: out of the DKV and the params
                DKV.remove(resumed)
                self.params["checkpoint"] = None
                self._checkpoint_model = None
        if self.job.status == Job.FAILED:
            raise self.job.exception
        if self.job.status == Job.DONE and self._build_recovery is not None:
            # only a finished build retires its snapshot: a cancelled one
            # keeps it, so that a rerun resumes where it stopped
            self._build_recovery.complete()
        return self.model

    def _begin_recovery(self, device: torch.device) -> str | None:
        """Open ``auto_recovery_dir`` for a builder that snapshots, and
        resume from its snapshot, loaded onto the training frame's
        ``device``, when it matches these params and no explicit
        ``checkpoint`` was given. Returns the key of the snapshot
        resumed from (which ``load_model`` put into the DKV), or None."""
        self._build_recovery = None
        rdir = self.params.get("auto_recovery_dir")
        if not rdir or not self.supports_auto_recovery():
            return None
        from h2o3_tpu_torch.persist.recovery import BuildRecovery
        self._build_recovery = BuildRecovery(str(rdir))
        if self.params.get("checkpoint") is not None:
            return None
        snap = self._build_recovery.load_snapshot(self.params, device)
        if snap is None:
            return None
        self.params["checkpoint"] = snap
        return snap.key

    def _snapshot(self, partial, progress: int, target: int) -> None:
        """Write ``partial`` (a model of the rounds so far) to the build's
        recovery directory; nothing without ``auto_recovery_dir``."""
        rec = getattr(self, "_build_recovery", None)
        if rec is not None:
            rec.snapshot(partial, progress=progress, target=target)

    def train_segments(self, segments: list[str], y: str,
                       training_frame: Frame, x: list[str] | None = None,
                       segment_models_id: str | None = None):
        """One model per observed segment of ``segments`` (h2o-py
        ``estimator.train_segments``; :mod:`~h2o3_tpu_torch.orchestration.
        segments`)."""
        from h2o3_tpu_torch.orchestration.segments import train_segments
        return train_segments(self, segments, training_frame, y, x=x,
                              segment_models_id=segment_models_id)

    def _custom_metric(self, model: Model):
        """``custom_metric_func`` as a callable (an uploaded UDF's reference
        loaded through :mod:`~h2o3_tpu_torch.utils.udf`), or None."""
        cmf = self.params.get("custom_metric_func")
        if isinstance(cmf, str):
            from h2o3_tpu_torch.utils import udf
            cmf = udf.metric_callable(udf.load_cfunc(cmf),
                                      udf.parse_ref(cmf)[1], model=model)
        return cmf

    @staticmethod
    def _apply_custom_metric(model: Model, frame: Frame, y: str, weights,
                             fn, mm) -> None:
        """``fn(predictions, response, weights)`` over ``frame``'s rows of
        a valid response, on the host, set on the metrics ``mm`` as
        ``custom_metric_name`` and ``custom_metric_value`` (reference: the
        custom metric of every scored frame, ``CMetricScoringTask``)."""
        if mm is None:
            return
        raw = model._score_raw(frame)
        yv, valid = response_adapted(
            frame.vec(y), model.response_domain if model.is_classifier
            else None)
        w = valid.float() if weights is None else weights * valid
        value = fn(raw.cpu().numpy(), yv.cpu().numpy(), w.cpu().numpy())
        mm.custom_metric_name = getattr(fn, "__name__", "custom")
        mm.custom_metric_value = float(value)

    def _begin_fit(self, x: list[str], y: str | None,
                   validation_frame: Frame | None) -> None:
        """The state a ``_fit`` reads besides its arguments, as ``train``
        sets it (a fold's fit sees no validation frame)."""
        # a builder that drops rows from the fit (GLM's Skip) sets the
        # weights its metrics must see
        self._metrics_weights = None
        # for builders that score held-out data while they train
        self._validation_frame = validation_frame
        self._x_cols, self._y_col = x, y
        self._score_series = None

    def _check_folds(self, frame: Frame) -> int:
        """The number of folds the parameters ask for (0: no
        cross-validation), refusing what the reference refuses (reference
        ``ModelBuilder.init``): a fold column with ``nfolds``, fewer than
        2 distinct fold values, a missing fold value, nfolds of 1."""
        nfolds = int(self.params.get("nfolds") or 0)
        if self.params.get("fold_column"):
            if nfolds:
                raise ValueError(
                    "specify either fold_column or nfolds, not both")
            nfolds = self._fold_column_cardinality(frame)
            if nfolds < 2:
                raise ValueError(
                    f"fold_column {self.params['fold_column']!r} must hold "
                    "at least 2 distinct folds")
        elif nfolds == 1 or nfolds < 0:
            raise ValueError(f"nfolds={nfolds}: 0 (no cross-validation) or "
                             "at least 2")
        return nfolds

    def _fold_column_values(self, frame: Frame) -> np.ndarray:
        """Per-row fold codes from the fold column: its distinct values
        map to 0..K-1 in sorted order (reference
        ``FoldAssignment.fromUserFoldSpecification``). A missing fold value
        raises: it would leak the row into every fold's training. Cached
        per frame (train reads the cardinality, the CV loop the codes)."""
        cache = getattr(self, "_fold_values_cache", None)
        if cache is not None and cache[0] is frame:
            return cache[1]
        v = frame.vec(self.params["fold_column"])
        vals = v.to_numpy().astype(np.float64)
        na = (vals < 0) if v.is_categorical else np.isnan(vals)
        if na.any():
            raise ValueError(
                f"fold_column {self.params['fold_column']!r} has "
                f"{int(na.sum())} missing values; every row needs a fold")
        uniq = np.unique(vals)
        out = np.searchsorted(uniq, vals).astype(np.int32)
        self._fold_values_cache = (frame, out)
        return out

    def _fold_column_cardinality(self, frame: Frame) -> int:
        return int(self._fold_column_values(frame).max()) + 1

    def _fold_ids(self, frame: Frame, nfolds: int, yvec=None) -> torch.Tensor:
        """[rows] fold of each row (reference ``hex/FoldAssignment.java``):
        Modulo (the default), Random, Stratified (round-robin within each
        response class, so every fold sees every class), or the fold
        column's."""
        dev, n = frame.device, frame.nrows
        if self.params.get("fold_column"):
            return torch.as_tensor(self._fold_column_values(frame),
                                   device=dev)
        assignment = self.params.get("fold_assignment") or "Modulo"
        if assignment == "Random":
            seed = int(self.params.get("seed") or -1)
            return random_folds(n, nfolds, seed if seed >= 0 else 907, dev)
        if assignment == "Stratified":
            if yvec is None or not yvec.is_categorical:
                raise ValueError("fold_assignment='Stratified' requires a "
                                 "categorical response")
            return stratified_folds(yvec.data, yvec.cardinality(), nfolds)
        if assignment not in ("Modulo", "AUTO"):
            raise ValueError(f"fold_assignment={assignment!r}: Modulo, "
                             "Random or Stratified")
        return torch.arange(n, device=dev, dtype=torch.int32) % nfolds

    def _cross_validate(self, job: Job, frame: Frame, x: list[str], y: str,
                        base_w: torch.Tensor, nfolds: int, model: Model):
        """K-fold cross-validation (reference
        ``ModelBuilder.computeCrossValidation``): fold k's model is a fresh
        builder's fit on the whole frame with fold k's rows at weight 0;
        each row's holdout prediction comes from the model that did not
        see it, and the pooled predictions give the CV metrics."""
        yvec = frame.vec(y)
        folds = self._fold_ids(frame, nfolds, yvec)
        valid = response_as_float(yvec)[1]
        pooled = any_mask = None
        per_fold = []
        for k in range(nfolds):
            in_fold = folds == k
            cv_builder = type(self)(**{**self.params, "nfolds": 0})
            # a checkpoint resumes every fold, by key
            cv_builder._checkpoint_model = getattr(self, "_checkpoint_model",
                                                   None)
            cv_builder._begin_fit(x, y, None)
            cv_model = cv_builder._fit(job, frame, x, y, base_w * ~in_fold)
            raw = cv_model._score_raw(frame)
            hold = (base_w > 0) & in_fold & valid
            per_fold.append(self._cv_metrics(raw, frame, y, hold))
            if pooled is None:
                pooled, any_mask = torch.zeros_like(raw), hold
            else:
                any_mask = any_mask | hold
            pooled = torch.where(hold[:, None] if raw.dim() == 2 else hold,
                                 raw, pooled)
            del cv_model, raw
            job.update(0.9 + 0.1 * (k + 1) / nfolds,
                       f"fold {k + 1} of {nfolds}")
        if self.params.get("keep_cross_validation_predictions"):
            model.cv_holdout_predictions = pooled
            model.cv_holdout_mask = any_mask
        model.cv_metrics_summary = cv_summary(per_fold)
        return self._cv_metrics(pooled, frame, y, any_mask)

    def _cv_metrics(self, raw: torch.Tensor, frame: Frame, y: str,
                    mask: torch.Tensor):
        """Metrics of holdout predictions ``raw`` on the rows of ``mask``
        (one fold's, or every fold's pooled)."""
        yvec = frame.vec(y)
        return compute_metrics(raw, response_as_float(yvec)[0], mask,
                               yvec.cardinality() if yvec.is_categorical
                               else 0)

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


#: the metrics of ``cv_metrics_summary``, in its order, where a fold's
#: metrics have them
CV_SUMMARY_METRICS = ("mse", "rmse", "logloss", "auc", "pr_auc", "mae", "r2",
                      "mean_per_class_error")


def cv_summary(per_fold: list) -> tuple:
    """(names, nfolds, rows): per metric its mean and sample sd over the
    folds whose value is finite (an empty holdout gives NaN), then every
    fold's value (reference: the ``cross_validation_metrics_summary``
    TwoDimTable)."""
    names = [f for f in CV_SUMMARY_METRICS
             if getattr(per_fold[0], f, None) is not None]
    rows = []
    for f in names:
        vals = np.array([float(getattr(m, f)) for m in per_fold])
        fin = vals[np.isfinite(vals)]
        mean = float(fin.mean()) if fin.size else float("nan")
        sd = float(fin.std(ddof=1)) if fin.size > 1 else 0.0
        rows.append([f, mean, sd] + [float(v) for v in vals])
    return names, len(per_fold), rows


def random_folds(n: int, nfolds: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """[n] folds drawn uniformly from a ``torch.Generator`` seeded with
    ``seed`` (the reference draws from its own stream: compare by metric,
    or inject its draw here)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, nfolds, (n,), generator=gen, device=device,
                         dtype=torch.int32)


def stratified_folds(codes: torch.Tensor, nclass: int,
                     nfolds: int) -> torch.Tensor:
    """[n] folds: the i-th row of each class (in row order) goes to fold
    i % nfolds; a row with a missing class to its row index % nfolds.
    Computed on the device, with no host sync."""
    n = codes.shape[0]
    dev = codes.device
    key = codes.long().clamp(min=-1) + 1             # missing → group 0
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(nclass + 1, dtype=torch.long, device=dev)
    counts.index_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[key[order]]
    ids = torch.arange(n, device=dev) % nfolds
    ids[order] = torch.where(key[order] > 0, rank % nfolds, ids[order])
    return ids.to(torch.int32)


def make_model_key(algo: str, model_id: str | None) -> str:
    return model_id or f"{algo}_{uuid.uuid4().hex[:10]}"
