"""Auto-recovery in the port (``h2o3_tpu_torch/persist/recovery.py`` and
the ``auto_recovery_dir`` hooks of ``models/model_base.py``, ``gbm.py``,
``xgboost.py`` and ``deeplearning.py``; the grid's ``recovery_dir`` in
``orchestration/grid.py``), after ``tests/test_chaos.py:240-330`` and
``tests/test_persist.py:83, :105``, on numpy-seeded frames of 320 rows.

- A build that dies after its first snapshot (the snapshot writer patched
  to raise once it has written; and once a real SIGKILL of a CPU
  subprocess), or that is cancelled through its Job, resumes from the
  snapshot and its trees equal an uninterrupted fit's bit for bit
  (``torch.equal`` on every heap array): binomial, multinomial, gaussian
  with early stopping, XGBoost gbtree. The finished build removes the
  snapshot; a cancelled one keeps it.
- A snapshot taken under other params is not resumed; a callable param is
  fingerprinted by its name (the fingerprint is the JAX package's string
  for the same params), and a snapshot drops it and still resumes.
- DeepLearning snapshots every epoch and a resumed build trains the rest
  of its epochs (its sample count then equals an uninterrupted fit's).
- A budget-stopped grid resumes without rebuilding its points, at
  parallelism 1 and 2, and its models equal an uninterrupted grid's.
- With no default device set (the card, which this machine may lack), a
  resumed build's snapshot and a resumed grid's models load onto the
  training frame's device, and the resume equals the uninterrupted fit.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from h2o3_tpu.persist import recovery as jrec
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.deeplearning import DeepLearning
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.models.xgboost import XGBoost
from h2o3_tpu_torch.orchestration import GridSearch
from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
from h2o3_tpu_torch.persist import Recovery
from h2o3_tpu_torch.persist import recovery as prec
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 320
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


def cols(seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    g = rng.choice(np.array(["u", "v", "w"]), N)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.6 * (g == "u")
    yb = np.where(rng.random(N) < 1 / (1 + np.exp(-logit)), "yes", "no")
    ym = np.array(["k0", "k1", "k2"])[np.digitize(
        X[:, 0] + 0.4 * rng.normal(size=N), [-0.5, 0.5])]
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "g": g, "yb": yb,
            "ym": ym, "yr": (X[:, 0] - 2 * X[:, 2]).astype(np.float32)}


@pytest.fixture(scope="module")
def frame():
    return Frame.from_arrays(cols())


class Crash(Exception):
    """The process dying right after a snapshot landed."""


def _tree_sets(model) -> list:
    o = model.output
    return [t for ts in o["trees_multi"] for t in ts] \
        if o.get("trees_multi") is not None else list(o["trees"])


def assert_same_trees(a, b) -> None:
    ta, tb = _tree_sets(a), _tree_sets(b)
    assert len(ta) == len(tb) and a.output["ntrees"] == b.output["ntrees"]
    for i, (x, y) in enumerate(zip(ta, tb)):
        for f in HEAP_FIELDS:
            assert torch.equal(getattr(x, f), getattr(y, f)), (i, f)


def crash_after_snapshot(monkeypatch, after: int = 1) -> None:
    real = prec.BuildRecovery.snapshot
    seen = []

    def snapshot(self, model, progress, target):
        real(self, model, progress, target)
        seen.append(progress)
        if len(seen) >= after:
            raise Crash(progress)

    monkeypatch.setattr(prec.BuildRecovery, "snapshot", snapshot)


#: case: (builder, params, y)
CASES = {
    "binomial": (GBM, dict(ntrees=10, max_depth=3, seed=1), "yb"),
    "multinomial": (GBM, dict(ntrees=8, max_depth=3, seed=2,
                              sample_rate=0.8), "ym"),
    "gaussian_stopping": (GBM, dict(ntrees=40, max_depth=3, seed=3,
                                    stopping_rounds=2,
                                    stopping_tolerance=1e-3), "yr"),
    "xgboost": (XGBoost, dict(ntrees=8, max_depth=3, seed=4), "yb"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_crash_after_the_first_snapshot_resumes_bit_for_bit(
        case, frame, tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "3")
    cls, params, y = CASES[case]
    clean = cls(**params).train(y=y, training_frame=frame)
    rdir = str(tmp_path / "rec")
    with monkeypatch.context() as m:
        crash_after_snapshot(m)
        with pytest.raises(Crash):
            cls(auto_recovery_dir=rdir, **params).train(
                y=y, training_frame=frame)
    state = prec.BuildRecovery(rdir)
    snap = state.load_snapshot(cls(auto_recovery_dir=rdir, **params).params)
    assert snap is not None and snap.output["ntrees"] < \
        clean.output["ntrees"]
    DKV.clear()
    resumed = cls(auto_recovery_dir=rdir, **params).train(
        y=y, training_frame=frame)
    assert_same_trees(clean, resumed)
    assert torch.equal(resumed._score_raw(frame), clean._score_raw(frame))
    # the finished build retired the snapshot, and the resume source left
    # the DKV
    assert not os.path.exists(os.path.join(rdir, "model_snapshot.bin"))
    assert DKV.get(snap.key) is None


def test_a_sigkilled_process_resumes_bit_for_bit(frame, tmp_path,
                                                monkeypatch):
    rdir = str(tmp_path / "rec")
    script = textwrap.dedent(f"""
        import os, signal
        import numpy as np, torch
        torch.set_num_threads(1)
        from h2o3_tpu_torch import set_device
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.models.gbm import GBM
        from h2o3_tpu_torch.persist import recovery
        set_device("cpu")
        real = recovery.BuildRecovery.snapshot
        def snapshot(self, model, progress, target):
            real(self, model, progress, target)
            os.kill(os.getpid(), signal.SIGKILL)
        recovery.BuildRecovery.snapshot = snapshot
        cols = dict(np.load({str(tmp_path / 'cols.npz')!r},
                            allow_pickle=True))
        GBM(ntrees=10, max_depth=3, seed=1,
            auto_recovery_dir={rdir!r}).train(
                y="yb", training_frame=Frame.from_arrays(cols))
        print("not killed")
    """)
    np.savez(tmp_path / "cols.npz", **cols())
    env = dict(os.environ, H2O3TPU_CHECKPOINT_EVERY="4",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "not killed" not in proc.stdout
    assert os.path.exists(os.path.join(rdir, "model_snapshot.bin"))
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "4")
    resumed = GBM(ntrees=10, max_depth=3, seed=1,
                  auto_recovery_dir=rdir).train(y="yb", training_frame=frame)
    clean = GBM(ntrees=10, max_depth=3, seed=1).train(y="yb",
                                                      training_frame=frame)
    assert_same_trees(clean, resumed)


def test_a_build_cancelled_through_its_job_keeps_its_snapshot(
        frame, tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "2")
    rdir = str(tmp_path / "rec")
    b = GBM(ntrees=10, max_depth=3, seed=1, auto_recovery_dir=rdir)
    real = prec.BuildRecovery.snapshot

    def snapshot(self, model, progress, target):
        real(self, model, progress, target)
        b.job.cancel()

    with monkeypatch.context() as m:
        m.setattr(prec.BuildRecovery, "snapshot", snapshot)
        assert b.train(y="yb", training_frame=frame) is None
    assert b.job.status == "CANCELLED" and b.job.auto_recovery_dir == rdir
    import json
    with open(os.path.join(rdir, "build_recovery.json")) as fh:
        state = json.load(fh)
    assert (state["progress"], state["target"]) == (2, 10)
    resumed = GBM(ntrees=10, max_depth=3, seed=1,
                  auto_recovery_dir=rdir).train(y="yb", training_frame=frame)
    clean = GBM(ntrees=10, max_depth=3, seed=1).train(y="yb",
                                                      training_frame=frame)
    assert_same_trees(clean, resumed)


def test_a_snapshot_with_other_params_is_not_resumed(frame, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "2")
    rdir = str(tmp_path / "rec")
    with monkeypatch.context() as m:
        crash_after_snapshot(m)
        with pytest.raises(Crash):
            GBM(ntrees=8, max_depth=3, seed=1, auto_recovery_dir=rdir).train(
                y="yb", training_frame=frame)
    # another depth: the stale snapshot is ignored, not resumed into a
    # differently shaped ensemble
    m2 = GBM(ntrees=4, max_depth=2, seed=1, auto_recovery_dir=rdir).train(
        y="yb", training_frame=frame)
    ref = GBM(ntrees=4, max_depth=2, seed=1).train(y="yb",
                                                   training_frame=frame)
    assert torch.equal(m2._score_raw(frame), ref._score_raw(frame))
    # a finished build's snapshot (progress >= target) is not resumed either
    b = GBM(ntrees=8, max_depth=3, seed=1, auto_recovery_dir=rdir)
    rec = prec.BuildRecovery(rdir)
    rec.snapshot(ref, progress=8, target=8)
    assert rec.load_snapshot(b.params) is None


def test_a_callable_param_is_fingerprinted_by_name(frame, tmp_path,
                                                   monkeypatch):
    params = {"ntrees": 3, "custom_metric_func": lambda a: a,
              "auto_recovery_dir": "/x", "model_id": "m"}
    other = dict(params, custom_metric_func=lambda a: a + 1)
    assert prec._params_fingerprint(params) == \
        prec._params_fingerprint(other) == jrec._params_fingerprint(params)
    assert prec._params_fingerprint(dict(params, ntrees=4)) != \
        prec._params_fingerprint(params)

    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "3")
    rdir = str(tmp_path / "rec")

    def cmf(preds, yv, w):
        return float(np.sum(w))

    with monkeypatch.context() as m:
        crash_after_snapshot(m)
        with pytest.raises(Crash):
            GBM(ntrees=9, max_depth=3, seed=1, auto_recovery_dir=rdir,
                custom_metric_func=cmf).train(y="yb", training_frame=frame)
    resumer = GBM(ntrees=9, max_depth=3, seed=1, auto_recovery_dir=rdir,
                  custom_metric_func=cmf)
    snap = prec.BuildRecovery(rdir).load_snapshot(resumer.params)
    assert snap is not None and "custom_metric_func" not in snap.params
    done = resumer.train(y="yb", training_frame=frame)
    assert done.training_metrics.custom_metric_value == float(N)
    clean = GBM(ntrees=9, max_depth=3, seed=1).train(y="yb",
                                                     training_frame=frame)
    assert_same_trees(clean, done)


def test_checkpoint_every_reads_the_environment_as_the_reference(
        monkeypatch):
    for value in ("", "4", "0", "-3", "x", "12"):
        monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", value)
        assert prec.checkpoint_every() == jrec.checkpoint_every(), value


def test_deeplearning_snapshots_every_epoch_and_resumes_the_rest(
        frame, tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "1")
    params = dict(hidden=[5], epochs=3, seed=1, mini_batch_size=16)
    rdir = str(tmp_path / "rec")
    with monkeypatch.context() as m:
        crash_after_snapshot(m)
        with pytest.raises(Crash):
            DeepLearning(auto_recovery_dir=rdir, **params).train(
                y="yb", training_frame=frame)
    snap = prec.BuildRecovery(rdir).load_snapshot(
        DeepLearning(auto_recovery_dir=rdir, **params).params)
    assert snap.output["epochs_done"] == 1
    assert snap.output["samples_trained"] == float(N // 16 * 16)
    resumed = DeepLearning(auto_recovery_dir=rdir, **params).train(
        y="yb", training_frame=frame)
    clean = DeepLearning(**params).train(y="yb", training_frame=frame)
    assert resumed.output["samples_trained"] == \
        clean.output["samples_trained"] == 3.0 * (N // 16 * 16)
    assert len(resumed.output["score_history"]) == 2
    assert not os.path.exists(os.path.join(rdir, "model_snapshot.bin"))
    assert resumed.training_metrics.auc > 0.7


def test_builders_that_do_not_snapshot_ignore_the_directory(frame, tmp_path,
                                                            monkeypatch):
    from h2o3_tpu_torch.models.glm import GLM
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "1")
    for b in (XGBoost(ntrees=3, max_depth=2, booster="dart",
                      auto_recovery_dir=str(tmp_path / "dart")),
              GLM(family="binomial", auto_recovery_dir=str(tmp_path / "g"))):
        assert not b.supports_auto_recovery()
        b.train(y="yb", training_frame=frame)
        assert b.job.auto_recovery_dir is None
    assert not os.path.exists(tmp_path / "dart")
    assert not os.path.exists(tmp_path / "g")


def _grid(frame, rdir, par: int, hyper, scheduler=None, **criteria):
    return GridSearch(GBM, hyper, grid_id="g1", recovery_dir=rdir,
                      search_criteria=criteria or None, parallelism=par,
                      scheduler=scheduler, ntrees=3,
                      seed=1).train(y="yb", training_frame=frame)


@pytest.mark.parametrize("par", [1, 2])
def test_a_budget_stopped_grid_resumes_without_rebuilding(frame, tmp_path,
                                                          par, monkeypatch):
    hyper = {"max_depth": [2, 3, 4]}
    rdir = str(tmp_path / "rec")
    g1 = _grid(frame, rdir, par, hyper, max_models=2)
    assert len(g1.models) == 2 and Recovery(rdir).resuming
    built = []
    real = GBM.train

    def counted(self, *a, **k):
        built.append(self.params["max_depth"])
        return real(self, *a, **k)

    monkeypatch.setattr(GBM, "train", counted)
    DKV.clear()
    g2 = _grid(frame, rdir, par, hyper)
    assert len(built) == 1 and len(g2.models) == 3
    assert sorted(m.output["hyper_values"]["max_depth"]
                  for m in g2.models) == [2, 3, 4]
    assert not Recovery(rdir).resuming        # done() marked it complete
    monkeypatch.setattr(GBM, "train", real)
    whole = {m.output["hyper_values"]["max_depth"]: m
             for m in _grid(frame, str(tmp_path / "whole"), 1, hyper).models}
    for m in g2.models:
        w = whole[m.output["hyper_values"]["max_depth"]]
        assert m.key == w.key
        assert_same_trees(m, w)


def test_a_parallel_grid_resumes_under_a_budget(frame, tmp_path):
    """A resumed run's max_models counts the recovered models."""
    hyper = {"max_depth": [2, 3, 4, 5]}
    rdir = str(tmp_path / "recp")
    assert len(_grid(frame, rdir, 2, hyper, max_models=2).models) == 2
    assert len(_grid(frame, rdir, 3, hyper, max_models=3).models) == 3
    g3 = _grid(frame, rdir, 3, hyper)
    assert sorted(m.output["hyper_values"]["max_depth"]
                  for m in g3.models) == [2, 3, 4, 5]
    assert not Recovery(rdir).resuming


def _on_cpu(model) -> bool:
    return all(t.device.type == "cpu" for tr in _tree_sets(model)
               for t in (getattr(tr, f) for f in HEAP_FIELDS))


@pytest.mark.parametrize("what", ["build", "grid"])
def test_a_resume_loads_onto_the_training_frames_device(what, frame,
                                                        tmp_path,
                                                        monkeypatch):
    """The default device is unset for the resume, so a snapshot or a
    recovered model loaded onto the default would go to the card, or
    raise where there is none. The grid's scheduler is made on the CPU
    (it leases the default device's streams)."""
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "2")
    rdir = str(tmp_path / "rec")
    hyper = {"max_depth": [2, 3]}
    params = dict(ntrees=6, max_depth=3, seed=1)
    if what == "build":
        with monkeypatch.context() as m:
            crash_after_snapshot(m)
            with pytest.raises(Crash):
                GBM(auto_recovery_dir=rdir, **params).train(
                    y="yb", training_frame=frame)
    else:
        _grid(frame, rdir, 1, hyper, max_models=1)
    DKV.clear()
    sched = MeshScheduler(1)
    set_device(None)
    try:
        if what == "build":
            got = [GBM(auto_recovery_dir=rdir, **params).train(
                y="yb", training_frame=frame)]
        else:
            got = _grid(frame, rdir, 1, hyper, scheduler=sched).models
    finally:
        set_device("cpu")
    if what == "build":
        want = [GBM(**params).train(y="yb", training_frame=frame)]
    else:
        want = _grid(frame, str(tmp_path / "whole"), 1, hyper).models
    assert len(got) == len(want)
    for g, w in zip(sorted(got, key=lambda m: m.key),
                    sorted(want, key=lambda m: m.key)):
        assert _on_cpu(g)
        assert_same_trees(g, w)


def test_recovery_keeps_the_training_frame(frame, tmp_path):
    rec = Recovery(str(tmp_path / "r"))
    rec.begin({"grid_id": "x"}, training_frame=frame)
    back = Recovery(str(tmp_path / "r")).training_frame()
    assert back.names == frame.names
    for a, b in zip(back.vecs, frame.vecs):
        assert torch.equal(a.data, b.data)
    assert Recovery(str(tmp_path / "r")).params == {"grid_id": "x"}
