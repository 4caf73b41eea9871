"""The port's scoring replica pool (``h2o3_tpu_torch/serving/replicas.py``)
on the CPU: the replica scenarios of ``tests/test_serving_slo.py`` on the
port. A replica holds one ``MeshScheduler.lease(small=True,
algo="scoring")`` for its lifetime; the port's lease is a CUDA stream of
the scheduler's pool (on the CPU the lease has no stream), and the leases
come back on evict and shutdown. Requests route least-loaded, a fresh
replica's speculative pre-captures make its first request a cache hit,
the pool scales up on queue wait and down when idle (never past the
scheduler's streams), and the replica path's results equal ``predict``
bit for bit. Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.serving import SCORING
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_scoring():
    SCORING.reset()
    SCORING.budget_bytes = None
    yield
    SCORING.reset()
    SCORING.budget_bytes = None
    DKV.clear()


@pytest.fixture
def frame(rng):
    n = 400
    X = rng.normal(size=(n, 3)).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["y"] = np.where(X[:, 0] - X[:, 1] > 0, "yes", "no")
    fr = Frame.from_arrays(cols, key="rep_frame")
    DKV.put("rep_frame", fr)
    return fr


@pytest.fixture
def gbm(frame):
    from h2o3_tpu_torch.models.gbm import GBM
    return GBM(ntrees=4, max_depth=3, seed=7,
               model_id="rep_gbm").train(y="y", training_frame=frame)


def _rows(frame, n, start=0):
    names = [c for c in frame.names if c != "y"]
    pdf = frame[names].to_pandas().iloc[start:start + n]
    return [{k: float(v) for k, v in rec.items()}
            for rec in pdf.to_dict(orient="records")]


class TestReplicaPool:
    def test_leases_come_from_scheduler_and_release(self, frame, gbm):
        """Replica stream leases come from MeshScheduler and release
        cleanly on evict/shutdown."""
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        sched = MeshScheduler(slices=2)
        assert sched.free_count() == 2
        SCORING.configure_replicas(2, scheduler=sched)
        try:
            assert sched.free_count() == 0        # both streams leased
            pool = SCORING.pool
            reps = pool.replicas
            assert len(reps) == 2
            assert sorted(r.slice_label for r in reps) == ["0", "1"], \
                "replicas must hold DISJOINT streams"
            assert {r.devices for r in reps} == {("cpu",)}
            out = SCORING.score(gbm.key, _rows(frame, 4))
            assert out["replica"] in {r.label for r in reps}
            # evicting the model drops per-replica seats but NOT leases
            assert SCORING.evict(gbm.key) is True
            assert sched.free_count() == 0
            for r in reps:
                assert r.cache.stats()["signatures"] == 0
        finally:
            SCORING.reset()                        # shuts the pool down
        assert sched.free_count() == 2, "leases leaked past shutdown"

    def test_replica_path_matches_predict(self, frame, gbm):
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        SCORING.configure_replicas(2, scheduler=MeshScheduler(slices=2))
        try:
            rows = _rows(frame, 9)
            out = SCORING.score(gbm.key, rows)["predictions"]
            names = [c for c in frame.names if c != "y"]
            pred = gbm.predict(Frame(names, [frame.vec(c) for c in names]))
            want = np.asarray(pred.vec("pyes").to_numpy())[:9]
            assert np.array_equal(np.asarray(out["pyes"], np.float32), want)
        finally:
            SCORING.reset()

    def test_least_loaded_routing(self, frame, gbm):
        from h2o3_tpu_torch.serving.replicas import ReplicaPool
        pool = ReplicaPool(2, scheduler=None)
        try:
            r0, r1 = pool.replicas
            assert pool.route() is r0              # tie: lowest rid
            with r0._lock:                         # fake load on r0
                pass
            r0.record_dispatch(0.0, 0, 0.0)        # accounting only
            # real load: queued rows
            entry = SCORING._admit(gbm.key)
            b = r0.batcher_for(entry)
            b._window = 5.0
            done = threading.Event()

            def enqueue():
                try:
                    b.submit(np.zeros((4, 3), np.float32),
                             np.full((4, 0), -1, np.int32), 4)
                except Exception:   # noqa: BLE001 — stop() fails it at exit
                    pass
                finally:
                    done.set()

            t = threading.Thread(target=enqueue, daemon=True)
            t.start()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and r0.load() == 0:
                time.sleep(0.005)
            assert r0.load() > 0
            assert pool.route() is r1              # r0 is loaded now
            b.stop()
            done.wait(timeout=5.0)
        finally:
            pool.shutdown()
            SCORING.reset()

    def test_precompile_warms_fresh_replica(self, frame, gbm):
        """Speculative bucket pre-capture at admission: after the warm
        thread joins, the replica's first request is a pure cache hit."""
        from h2o3_tpu_torch.serving.replicas import ScoringReplica
        rep = ScoringReplica(99, scheduler=None)
        try:
            entry = SCORING._admit(gbm.key)
            rep.precompile(entry, buckets=(8, 16)).join(timeout=120)
            st = rep.cache.stats()
            assert st["signatures"] == 2
            misses0 = st["misses"]
            b = rep.batcher_for(entry)
            p = b.submit(*entry.schema.adapt_rows(_rows(frame, 4)), 4)
            assert p.result is not None
            st = rep.cache.stats()
            assert st["misses"] == misses0, \
                "first request on a pre-captured replica must not capture"
            assert rep.precaptured == 2 and rep.precapture_failed == 0
            assert st["hits"] >= 1
        finally:
            rep.stop()
            SCORING.reset()

    def test_scale_up_on_queue_wait_and_down_when_idle(self, frame, gbm):
        from h2o3_tpu_torch.serving.replicas import ReplicaPool
        pool = ReplicaPool(1, scheduler=None, max_replicas=3)
        try:
            assert len(pool.replicas) == 1
            assert pool.maybe_scale(None) is None          # no SLO: no scaling
            for _ in range(8):
                pool.observe_wait(0.5)                     # 500ms >> 25% of SLO
            pool._last_scale = 0.0                         # bypass cooldown
            assert pool.maybe_scale(100.0) == "up"
            assert len(pool.replicas) == 2
            assert pool.scale_ups == 1
            for _ in range(16):
                pool.observe_wait(0.0)                     # idle
            pool._last_scale = 0.0
            assert pool.maybe_scale(100.0) == "down"
            assert len(pool.replicas) == 1
            assert pool.scale_downs == 1
        finally:
            pool.shutdown()

    def test_scale_up_respects_mfu_ceiling(self, monkeypatch):
        from h2o3_tpu_torch.serving import replicas as rmod
        pool = rmod.ReplicaPool(1, scheduler=None, max_replicas=3)
        try:
            monkeypatch.setattr(rmod.ReplicaPool, "mfu_headroom",
                                lambda self: False)
            for _ in range(8):
                pool.observe_wait(0.5)
            pool._last_scale = 0.0
            assert pool.maybe_scale(100.0) is None, \
                "no MFU headroom -> adding replicas cannot help"
            assert len(pool.replicas) == 1
        finally:
            pool.shutdown()

    def test_pool_capped_at_scheduler_slices(self):
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        from h2o3_tpu_torch.serving.replicas import ReplicaPool
        sched = MeshScheduler(slices=2)
        pool = ReplicaPool(5, scheduler=sched)     # ask for more than streams
        try:
            assert len(pool.replicas) == 2         # an extra would park
            assert pool.max_replicas == 2
        finally:
            pool.shutdown()
        assert sched.free_count() == sched.n

    def test_evicted_entry_seat_is_not_resurrected(self, frame, gbm):
        """A score() racing an eviction between admit and routing must
        hit Evicted (-> transparent re-admit), never silently re-create
        a seat for the dropped model in the replica's cache."""
        from h2o3_tpu_torch.serving.batcher import Evicted
        SCORING.configure_replicas(1)
        try:
            SCORING.score(gbm.key, _rows(frame, 2))
            entry = SCORING._resident[gbm.key]
            rep = SCORING.pool.replicas[0]
            assert SCORING.evict(gbm.key) is True
            assert entry.stopped
            assert rep.cache.stats()["signatures"] == 0
            with pytest.raises(Evicted):
                rep.batcher_for(entry)             # the stale-entry path
            assert rep.cache.stats()["signatures"] == 0
            # the service path re-admits a FRESH entry and serves
            out = SCORING.score(gbm.key, _rows(frame, 2))
            assert len(out["predictions"]["predict"]) == 2
        finally:
            SCORING.reset()

    def test_teardown_repoints_residents_at_local_seat(self, frame, gbm):
        """configure_replicas(0) must re-point already-resident models at
        a fresh local batcher — an entry left holding the shut-down pool
        would 500 on every subsequent request."""
        SCORING.configure_replicas(1)
        try:
            out = SCORING.score(gbm.key, _rows(frame, 3))
            assert out.get("replica") is not None
            SCORING.configure_replicas(0)          # tear the pool down
            assert SCORING.pool is None
            entry = SCORING._resident[gbm.key]
            assert entry.pool is None and entry.batcher is not None
            out = SCORING.score(gbm.key, _rows(frame, 3))
            assert len(out["predictions"]["predict"]) == 3
            assert "replica" not in out
        finally:
            SCORING.reset()

    def test_scaled_up_replica_defers_routing_while_warming(self, frame,
                                                            gbm):
        """A fresh replica must not win least-loaded routing (load 0)
        while its speculative pre-captures are still running — its first
        requests would pay cold captures inside someone's budget."""
        from h2o3_tpu_torch.serving.replicas import ReplicaPool
        pool = ReplicaPool(2, scheduler=None)
        try:
            r0, r1 = pool.replicas
            with r1._lock:
                r1._warming = 1                    # pre-captures in flight
            assert pool.route() is r0, "warming replica must not serve"
            with r1._lock:
                r1._warming = 0
            assert pool.route() in (r0, r1)        # warm again: eligible
            with r0._lock, r1._lock:
                r0._warming = r1._warming = 1      # ALL warming: serve anyway
            assert pool.route() is r0
        finally:
            pool.shutdown()

    def test_env_knob_arms_pool_after_reset(self, frame, gbm, monkeypatch):
        monkeypatch.setenv("H2O3TPU_SCORE_REPLICAS", "2")
        SCORING.reset()                            # re-arms the env check
        try:
            out = SCORING.score(gbm.key, _rows(frame, 3))
            assert out.get("replica") is not None
            assert SCORING.pool is not None
            assert len(SCORING.pool.replicas) >= 1
        finally:
            monkeypatch.delenv("H2O3TPU_SCORE_REPLICAS")
            SCORING.reset()
            assert SCORING.pool is None


    def test_replica_results_equal_predict_under_threads(self, frame, gbm):
        """8 threads through a pool of 2: every reply its own rows of
        ``predict``, bit for bit, whichever replica answered."""
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        SCORING.configure_replicas(2, scheduler=MeshScheduler(slices=2))
        names = [c for c in frame.names if c != "y"]
        pred = gbm.predict(Frame(names, [frame.vec(c) for c in names]))
        want = np.asarray(pred.vec("pyes").to_numpy())
        outs, errs = [None] * 8, []

        def work(i):
            try:
                outs[i] = SCORING.score(gbm.key, _rows(frame, 5, start=5 * i))
            except Exception as e:   # noqa: BLE001 — asserted below
                errs.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs and all(o is not None for o in outs)
        for i, out in enumerate(outs):
            got = np.asarray(out["predictions"]["pyes"], np.float32)
            assert np.array_equal(got, want[5 * i:5 * i + 5]), i
            assert out["replica"] in ("r0", "r1")


@pytest.mark.parametrize("small", [None, True, False])
def test_scheduler_lease_takes_small(small):
    """``lease(small=...)`` is the reference's argument: every lease of the
    port is one stream already, so ``small`` asks for nothing more, and
    the stream comes back after the block."""
    from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
    sched = MeshScheduler(slices=2)
    with sched.lease(algo="scoring", small=small) as lease:
        assert lease.label in ("0", "1") and lease.stream is None
        assert sched.free_count() == 1
    assert sched.free_count() == 2
    one = MeshScheduler(slices=1)
    with one.lease(small=small) as lease:       # one slice: shared
        assert lease.label == "full" and one.free_count() == 1


def test_replicas_from_env_and_precapture_buckets(monkeypatch):
    from h2o3_tpu.serving import replicas as jrep
    from h2o3_tpu_torch.serving import replicas as prep
    for raw in (None, "", "0", "3", "-2", "x"):
        if raw is None:
            monkeypatch.delenv("H2O3TPU_SCORE_REPLICAS", raising=False)
        else:
            monkeypatch.setenv("H2O3TPU_SCORE_REPLICAS", raw)
        assert prep.replicas_from_env() == jrep.replicas_from_env()
    for raw in (None, "", "8,16,64", "7, 8,x,8192,32", "4096"):
        if raw is None:
            monkeypatch.delenv("H2O3TPU_SCORE_PRECOMPILE", raising=False)
        else:
            monkeypatch.setenv("H2O3TPU_SCORE_PRECOMPILE", raw)
        assert prep.precompile_buckets_from_env() == \
            jrep.precompile_buckets_from_env()
