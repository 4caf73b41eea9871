"""Auto-recovery of long searches and of single builds — the port of
``h2o3_tpu/persist/recovery.py``.

Reference: ``hex/faulttolerance/Recovery.java:21-50``: before a long job
starts, its params and training frame are written to ``-auto_recovery_dir``;
every model built is added; on restart the job reloads them and resumes
where it stopped (the hyperparameter points already built are skipped).

Two granularities:

- :class:`Recovery` — a grid's (or AutoML's) points, one saved model each,
  skipped on resume by :func:`combo_key`.
- :class:`BuildRecovery` — one long iterative build (GBM, XGBoost gbtree,
  DeepLearning) under ``auto_recovery_dir``: the builder snapshots a
  partial model every K trees or epochs (``H2O3TPU_CHECKPOINT_EVERY``) in
  the same binary format ``checkpoint=`` resume takes, so a killed process
  restarts from its last snapshot instead of tree 0. A GBM's trees draw
  from generators seeded by the tree's index and resume folds the prior
  trees as the loop adds them, so the resumed trees equal an uninterrupted
  run's bit for bit.

Frames go through :mod:`~h2o3_tpu_torch.persist.frame_io`, models through
:mod:`~h2o3_tpu_torch.persist.model_io`. A resumed snapshot and a grid's
recovered models load onto the device of the frame being trained on, which
the builder and the grid pass in; with none given, the card unless the
process's default device is set otherwise.
"""

from __future__ import annotations

import json
import os

from h2o3_tpu_torch.persist.frame_io import load_frame, save_frame
from h2o3_tpu_torch.persist.model_io import load_model, save_model


def checkpoint_every(default: int = 10) -> int:
    """Snapshot cadence in trees or epochs (``H2O3TPU_CHECKPOINT_EVERY``)."""
    try:
        k = int(os.environ.get("H2O3TPU_CHECKPOINT_EVERY", "") or default)
    except ValueError:
        k = default
    return max(k, 1)


def _params_fingerprint(params: dict) -> str:
    """Canonical identity of a build's training params for matching a
    snapshot: the recovery dir, a resolved checkpoint and the model id are
    left out, so a resume with the same training configuration matches.
    Callables (a custom metric) are named by their qualified name, never by
    ``str()``, which holds a process-specific address."""
    skip = {"auto_recovery_dir", "checkpoint", "model_id"}

    def _stable(v):
        if callable(v):
            return f"<callable {getattr(v, '__qualname__', type(v).__name__)}>"
        return v

    return json.dumps({k: _stable(v) for k, v in params.items()
                       if k not in skip}, sort_keys=True, default=str)


class BuildRecovery:
    """The auto-checkpoint directory of one resumable build.

    Lifecycle (``ModelBuilder.train`` with ``auto_recovery_dir``)::

        rec = BuildRecovery(dir)
        snap = rec.load_snapshot(params, device)  # a partial model or None
        # ... the build resumes through checkpoint= ...
        rec.snapshot(partial_model, progress=K, target=ntrees)  # every K
        rec.complete()                        # DONE: the snapshot goes
    """

    STATE = "build_recovery.json"
    MODEL = "model_snapshot.bin"

    def __init__(self, recovery_dir: str):
        self.dir = recovery_dir
        os.makedirs(recovery_dir, exist_ok=True)
        self._state_path = os.path.join(recovery_dir, self.STATE)
        self._model_path = os.path.join(recovery_dir, self.MODEL)

    def load_snapshot(self, params: dict, device=None):
        """The last partial model, loaded onto ``device``, or None when
        there is nothing to resume:
        no snapshot, a finished build (progress >= target: such a
        checkpoint cannot seed a longer build), or a snapshot taken under
        other training params (resuming it would train another model)."""
        if not (os.path.exists(self._state_path)
                and os.path.exists(self._model_path)):
            return None
        try:
            with open(self._state_path) as fh:
                state = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None
        if state.get("fingerprint") != _params_fingerprint(params):
            return None
        if int(state.get("progress", 0)) >= int(state.get("target", 1 << 62)):
            return None
        return load_model(self._model_path, device=device)

    def snapshot(self, model, progress: int, target: int) -> None:
        """Persist a partial model and its progress: the model file lands
        (``os.replace``) before the state file, so a crash mid-snapshot
        leaves the previous pair or the new model under the previous state
        (whose fingerprint still matches), never a state naming a torn
        file."""
        fingerprint = _params_fingerprint(model.params)
        # callables (a custom metric) do not pickle: the snapshot drops
        # them; a resume matches against the live builder's params
        clean = {k: v for k, v in model.params.items() if not callable(v)}
        orig_params = model.params
        if len(clean) != len(orig_params):
            model.params = clean
        try:
            tmp = self._model_path + ".tmp"
            save_model(model, tmp)
            os.replace(tmp, self._model_path)
        finally:
            model.params = orig_params
        doc = {"fingerprint": fingerprint,
               "progress": int(progress), "target": int(target),
               "model_key": model.key}
        tmp_s = self._state_path + ".tmp"
        with open(tmp_s, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp_s, self._state_path)

    def complete(self) -> None:
        """A finished build retires its snapshot, so a fresh run with the
        same dir trains from scratch."""
        for p in (self._state_path, self._model_path):
            try:
                os.remove(p)
            except OSError:
                pass


def combo_key(combo: dict) -> str:
    """Canonical form of a hyperparameter point (sorted keys, JSON): the
    one spelling of recovery's skip detection and of grid model ids
    (``md5(combo_key(combo))[:8]``)."""
    return json.dumps(combo, sort_keys=True, default=str)


class Recovery:
    """The checkpoint directory of a resumable search (reference:
    ``Recovery<Grid>``)::

        rec = Recovery(dir)
        rec.begin(params={...}, training_frame=f)  # nothing when resuming
        for combo in combos:
            if rec.is_done(combo): continue        # built before the crash
            model = build(combo)
            rec.model_built(combo, model)
        rec.done()
    """

    def __init__(self, recovery_dir: str):
        self.dir = recovery_dir
        os.makedirs(recovery_dir, exist_ok=True)
        self._state_path = os.path.join(recovery_dir, "recovery.json")
        self._state = self._load_state()
        self._done_cache: set[str] | None = None

    def _load_state(self) -> dict:
        if os.path.exists(self._state_path):
            with open(self._state_path) as fh:
                return json.load(fh)
        return {"params": None, "built": [], "done": False}

    def _flush(self) -> None:
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._state, fh)
        os.replace(tmp, self._state_path)

    @property
    def resuming(self) -> bool:
        return self._state["params"] is not None and not self._state["done"]

    def begin(self, params: dict, training_frame=None) -> None:
        if self.resuming:
            return
        self._state = {"params": params, "built": [], "done": False}
        self._done_cache = None
        if training_frame is not None:
            save_frame(training_frame, os.path.join(self.dir,
                                                    "training_frame"))
        self._flush()

    def training_frame(self):
        p = os.path.join(self.dir, "training_frame")
        return load_frame(p) if os.path.exists(p) else None

    @property
    def params(self) -> dict | None:
        return self._state["params"]

    def _done_keys(self) -> set[str]:
        if self._done_cache is None or \
                len(self._done_cache) != len(self._state["built"]):
            self._done_cache = {b["combo"] for b in self._state["built"]}
        return self._done_cache

    def is_done(self, combo: dict) -> bool:
        return combo_key(combo) in self._done_keys()

    def model_built(self, combo: dict, model) -> None:
        fname = f"model_{len(self._state['built'])}.bin"
        save_model(model, os.path.join(self.dir, fname))
        self._state["built"].append({"combo": combo_key(combo),
                                     "file": fname})
        self._done_cache = None
        self._flush()

    def built_models(self, device=None) -> list:
        """The models built before the stop, loaded onto ``device``."""
        return [load_model(os.path.join(self.dir, b["file"]), device=device)
                for b in self._state["built"]]

    def done(self) -> None:
        self._state["done"] = True
        self._flush()
