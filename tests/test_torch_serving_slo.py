"""The port's SLO-adaptive serving (``h2o3_tpu_torch/serving/slo.py``,
the batcher's window, shedding) on the CPU: the scenarios of
``tests/test_serving_slo.py`` on the port, and the port's
``SLOController`` held to the JAX package's on the same sequences of
latencies, dispatches and admissions: the same windows (bit for bit: the
algorithm is host code copied exactly), the same sheds and the same
snapshots.

- With no SLO configured the output is the fixed-window path's
  (``mode == "fixed"``, window == base, predictions equal
  ``Model.predict``).
- Shedding is accounted in the ``GET /3/Score`` ``shed`` block, low
  priority first, and in ``h2o3_score_shed_total`` on ``/metrics``.
- The batcher window is resolved at construction, not at import.
"""

import threading
import time

import numpy as np
import pytest
import torch

from h2o3_tpu.serving import slo as jslo
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.serving import (SCORING, ServiceUnavailable, Shed,
                                    SLOController)
from h2o3_tpu_torch.serving.slo import LatencyRing, clamp_priority
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
    fr = Frame.from_arrays(cols, key="slo_frame")
    DKV.put("slo_frame", fr)
    return fr


@pytest.fixture
def gbm(frame):
    from h2o3_tpu_torch.models.gbm import GBM
    return GBM(ntrees=4, max_depth=3, seed=7,
               model_id="slo_gbm").train(y="y", training_frame=frame)


def _rows(frame, n, start=0):
    names = [c for c in frame.names if c != "y"]
    pdf = frame[names].to_pandas().iloc[start:start + n]
    return [{k: float(v) for k, v in rec.items()}
            for rec in pdf.to_dict(orient="records")]


class TestController:
    def test_ring_percentiles(self):
        ring = LatencyRing(size=64)
        assert ring.percentile(99) is None          # cold ring: no signal
        for v in range(1, 101):
            ring.record(v / 1000.0)
        assert ring.percentile(50) == pytest.approx(0.064, abs=0.015)
        assert ring.percentile(99) >= 0.099

    def test_ring_rejects_nan_negative_and_counts_drops(self):
        """A NaN in the ring makes sorted() a partial order — every
        percentile read downstream would steer the SLO controller off
        garbage. Invalid latencies drop and are counted on the ring."""
        ring = LatencyRing(size=64)
        for v in range(1, 101):
            ring.record(v / 1000.0)
        p99_clean = ring.percentile(99)
        ring.record(float("nan"))
        ring.record(-1.0)
        ring.record(float("inf"))
        assert ring.rejected == 3
        assert ring.count == 100                    # drops never landed
        assert ring.percentile(99) == p99_clean     # signal unpoisoned

    def test_no_target_is_fixed_window_and_never_sheds(self):
        c = SLOController(base_window_s=0.002, slo_ms=None)
        assert not c.active
        for _ in range(20):
            c.record_latency(10.0)                  # terrible latencies
            c.record_dispatch(10.0, 4096)
        assert c.window_s(queued_rows=10 ** 6) == 0.002
        c.admit(0, queued_rows=10 ** 6, n_rows=64)  # must not raise
        assert c.snapshot()["mode"] == "fixed"

    def test_violating_p99_narrows_hard(self):
        c = SLOController(base_window_s=0.004, slo_ms=10.0)
        for _ in range(16):
            c.record_latency(0.02)                  # p99 = 20ms > 10ms SLO
        w0 = c.window_s(0)
        assert w0 < 0.004
        assert c.window_s(0) < w0                   # keeps narrowing
        assert c.narrowed >= 2

    def test_queue_growth_widens_capped_at_quarter_slo(self):
        c = SLOController(base_window_s=0.001, slo_ms=100.0)
        for _ in range(16):
            c.record_latency(0.006)                 # healthy (p99 6% of SLO)
        c.record_dispatch(0.001, rows=8)            # last dispatch: 8 rows
        w = 0.0
        for _ in range(64):
            w = c.window_s(queued_rows=4096)        # queue grew past 8
        assert w > 0.001
        assert w <= 100.0 / 1e3 / 4.0 + 1e-12       # SLO/4 cap
        assert c.widened > 0

    def test_headroom_narrows_gently_with_floor(self):
        c = SLOController(base_window_s=0.004, slo_ms=1000.0)
        for _ in range(16):
            c.record_latency(0.001)                 # massive headroom
        c.record_dispatch(0.001, rows=4096)         # queue never "grows"
        for _ in range(200):
            c.window_s(queued_rows=0)
        assert c.current_window_s() == pytest.approx(0.004 / 16.0)

    def test_admit_sheds_low_priority_first(self):
        c = SLOController(base_window_s=0.001, slo_ms=10.0, max_bucket=64)
        c.record_dispatch(0.030, rows=64)           # 30ms per dispatch EMA
        # ~2 dispatches queued ahead -> est ~60ms+ vs 10ms budget
        with pytest.raises(Shed) as ei:
            c.admit(0, queued_rows=64, n_rows=16)
        assert ei.value.reason == "overload"
        assert ei.value.retry_after_ms >= 100
        with pytest.raises(Shed):
            c.admit(3, queued_rows=64, n_rows=16)   # 4x budget still < est
        c.admit(9, queued_rows=64, n_rows=16)       # 10x budget: admitted
        assert c.shed_count == 2

    def test_per_model_override_beats_env(self, monkeypatch):
        monkeypatch.setenv("H2O3TPU_SCORE_SLO_MS", "50")
        c = SLOController(base_window_s=0.001)
        assert c.slo_ms == 50.0
        c.set_target(200.0)
        assert c.slo_ms == 200.0
        c.set_target(None)                          # None leaves it alone
        assert c.slo_ms == 200.0

    def test_clamp_priority(self):
        assert clamp_priority(None) == 5
        assert clamp_priority(-3) == 0
        assert clamp_priority(42) == 9
        assert clamp_priority("7") == 7
        assert clamp_priority("nope") == 5


class TestWindowConstruction:
    def test_window_resolved_at_construction_not_import(self, frame, gbm,
                                                        monkeypatch):
        """A late env change must be honored by the next batcher, not
        silently ignored because the module captured the env at import."""
        from h2o3_tpu_torch.serving.batcher import ModelBatcher
        monkeypatch.setenv("H2O3TPU_SCORE_WINDOW_MS", "7.5")
        entry = SCORING._admit(gbm.key)     # admitted under the new env
        try:
            assert entry.batcher._window == pytest.approx(7.5e-3)
            assert entry.slo.base_window_s == pytest.approx(7.5e-3)
            monkeypatch.setenv("H2O3TPU_SCORE_WINDOW_MS", "0.25")
            b2 = ModelBatcher(entry)
            try:
                assert b2._window == pytest.approx(0.25e-3)
            finally:
                b2.stop()
        finally:
            SCORING.reset()

    def test_no_slo_output_bit_identical_to_fixed_window_path(self, frame,
                                                              gbm):
        """No SLO configured -> the fixed-window path, bit-identical
        predictions and a fixed window."""
        rows = _rows(frame, 17)
        out = SCORING.score(gbm.key, rows)["predictions"]
        entry = SCORING._resident[gbm.key]
        snap = entry.slo.snapshot()
        assert snap["mode"] == "fixed" and snap["target_ms"] is None
        assert entry.slo.current_window_s() == entry.slo.base_window_s
        names = [c for c in frame.names if c != "y"]
        pred = gbm.predict(Frame(names, [frame.vec(c) for c in names]))
        want = np.asarray(pred.vec("pyes").to_numpy())[:17]
        assert np.array_equal(np.asarray(out["pyes"], np.float32), want)
        assert "shed" not in {s["reason"] for s in SCORING.stats()["shed"]}


class TestShedding:
    def test_overloaded_low_priority_sheds_503_high_serves(self, frame, gbm):
        rows = _rows(frame, 4)
        SCORING.score(gbm.key, rows, slo_ms=10.0)     # admit + set target
        entry = SCORING._resident[gbm.key]
        # fake a saturated tier: ~50ms per dispatch against a 10ms SLO —
        # beyond priority 1's 20ms budget, inside priority 9's 100ms one
        # (set the EMA directly: the warm-up dispatch above seeded it with
        # its compile wall, and one record_dispatch only moves it by 0.3)
        with entry.slo._lock:
            entry.slo._ema_dispatch_s = 0.05
        with pytest.raises(ServiceUnavailable) as ei:
            SCORING.score(gbm.key, rows, priority=1)
        assert ei.value.retry_after_ms >= 100
        st = SCORING.stats()
        assert {"reason": "overload", "priority": 1, "count": 1} in st["shed"]
        assert st["shed_total"] >= 1
        # the same load admits priority 9 (10x budget tolerance)
        out = SCORING.score(gbm.key, rows, priority=9)
        assert len(out["predictions"]["predict"]) == 4
        assert out["priority"] == 9

    def test_timeout_shed_is_accounted(self, frame, gbm, monkeypatch):
        import h2o3_tpu_torch.serving.batcher as bm
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 0.05)
        entry = SCORING._admit(gbm.key)
        entry.batcher._window = 0.5              # hold the batch open
        try:
            with pytest.raises(ServiceUnavailable):
                SCORING.score(gbm.key, _rows(frame, 2))
        finally:
            entry.batcher._window = entry.slo.base_window_s
        assert {"reason": "timeout", "priority": 5, "count": 1} in \
            SCORING.stats()["shed"]

    def test_withdrawer_losing_to_eviction_gets_evicted_not_timeout(
            self, frame, gbm, monkeypatch):
        """The deterministic interleave: the caller
        TIMES OUT first (enters the withdraw path) but the eviction has
        already drained the queue — ``remove`` misses, and the caller
        must surface the retryable :class:`Evicted` (-> 503 upstream),
        not a timeout blamed on the device, and never hang."""
        import h2o3_tpu_torch.serving.batcher as bm
        from h2o3_tpu_torch.serving.batcher import Evicted, ModelBatcher
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 0.05)
        entry = SCORING._admit(gbm.key)
        b = entry.batcher
        b._window = 30.0                         # batch never dispatches
        errs: list = []

        def caller():
            try:
                b.submit(*entry.schema.adapt_rows(_rows(frame, 2)), 2)
            except BaseException as e:   # noqa: BLE001 — asserted below
                errs.append(e)

        t = threading.Thread(target=caller)
        t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:       # wait for the enqueue
            with b._cond:
                if b._queue:
                    break
            time.sleep(0.005)
        # stop()'s exact body, but ordered UNDER the condvar — acquired
        # BEFORE the caller's timeout fires and held across it, so the
        # withdrawer blocks at the lock and deterministically loses: by
        # the time it gets in, the queue is drained AND its pending failed
        with b._cond:
            time.sleep(0.1)                      # caller times out, parks
            b._stopped = True                    # on acquiring this lock
            victims = list(b._queue)
            b._queue.clear()
            for p in victims:
                ModelBatcher._fail(p, Evicted("evicted mid-queue"))
            b._cond.notify_all()
        t.join(timeout=10.0)
        assert not t.is_alive(), "withdraw+eviction must never hang"
        assert len(victims) == 1, "the pending must not be dropped"
        assert len(errs) == 1
        assert isinstance(errs[0], Evicted), errs[0]
        # the service layer maps Evicted to re-admit -> a fresh batcher
        # serves (or a persistent loss 503s); either way the tier lives
        # (normal ceiling restored)
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 30.0)
        out = SCORING.score(gbm.key, _rows(frame, 2))
        assert len(out["predictions"]["predict"]) == 2

    def test_withdraw_racing_real_eviction_stays_retryable(self, frame, gbm,
                                                           monkeypatch):
        """The same interleave with the REAL ``stop()`` racing the
        timeout: whichever side wins, the caller gets a clean result or a
        retryable 503 — never a hang, never a server error."""
        import h2o3_tpu_torch.serving.batcher as bm
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 0.1)
        entry = SCORING._admit(gbm.key)
        entry.batcher._window = 30.0             # batch never dispatches
        errs: list = []

        def caller():
            try:
                SCORING.score(gbm.key, _rows(frame, 2))
            except BaseException as e:   # noqa: BLE001 — asserted below
                errs.append(e)

        t = threading.Thread(target=caller)
        t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:       # wait for the enqueue
            with entry.batcher._cond:
                if entry.batcher._queue:
                    break
            time.sleep(0.005)
        entry.batcher.stop()                     # eviction races the wait
        t.join(timeout=15.0)
        assert not t.is_alive(), "withdraw+eviction must never hang"
        # Evicted -> transparent re-admit (success) or a retryable 503;
        # anything else (500s, TimeoutError leaking raw) is a regression
        assert errs == [] or isinstance(errs[0], ServiceUnavailable), errs
        with entry.batcher._cond:
            assert entry.batcher._queue == [], "dropped _Pending left behind"
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 30.0)
        out = SCORING.score(gbm.key, _rows(frame, 2))
        assert len(out["predictions"]["predict"]) == 2


class TestRestSurface:
    @pytest.fixture
    def server(self):
        from h2o3_tpu_torch.api import H2OServer
        s = H2OServer(port=0).start()
        yield s
        s.stop()

    @pytest.fixture
    def client(self, server):
        from h2o3_tpu_torch.api import H2OClient
        return H2OClient(server.url)

    def test_priority_and_slo_params_roundtrip(self, frame, gbm, client):
        out = client.score(gbm.key, _rows(frame, 3), priority=7, slo_ms=500)
        assert out["priority"] == 7
        st = client.serving()
        row = next(r for r in st["resident"] if r["model"] == gbm.key)
        assert row["slo"]["target_ms"] == 500.0
        assert row["slo"]["mode"] == "adaptive"
        assert st["shed"] == [] and st["shed_total"] == 0

    def test_shed_is_503_with_retry_after_and_accounted(self, frame, gbm,
                                                        client):
        client.score(gbm.key, _rows(frame, 2), slo_ms=10)
        entry = SCORING._resident[gbm.key]
        entry.slo.record_dispatch(5.0, rows=4096)   # saturate the estimator
        with pytest.raises(RuntimeError, match="503"):
            client.score(gbm.key, _rows(frame, 2), priority=0)
        st = client.serving()
        assert st["shed_total"] >= 1
        assert any(s["reason"] == "overload" and s["priority"] == 0
                   for s in st["shed"])
        text = client.metrics_text()
        assert "h2o3_score_shed_total" in text

    def test_serving_view_carries_replicas(self, frame, gbm, client):
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        SCORING.configure_replicas(2, scheduler=MeshScheduler(slices=2))
        try:
            client.score(gbm.key, _rows(frame, 2))
            st = client.serving()
            assert st["replicas"]["count"] == len(SCORING.pool.replicas)
            rep = st["replicas"]["replicas"][0]
            assert {"replica", "slice", "devices", "busy_seconds",
                    "queue_wait_seconds", "models"} <= set(rep)
        finally:
            SCORING.reset()

    def test_bad_priority_is_400(self, frame, gbm, client):
        with pytest.raises(RuntimeError, match="400"):
            client.request("POST", f"/3/Score/{gbm.key}",
                           {"rows": [{"x0": 1.0}], "priority": "high"})


# -- the port's controller against the JAX package's -------------------------

def _drive(mod, slo_ms, script):
    """Run ``script`` (a list of (op, args)) on a fresh controller of
    ``mod``; the windows, shed decisions (with their retry) and the final
    snapshot it gives."""
    c = mod.SLOController(base_window_s=0.002, slo_ms=slo_ms, max_bucket=64)
    out = []
    for op, args in script:
        if op == "lat":
            c.record_latency(*args)
        elif op == "disp":
            c.record_dispatch(*args)
        elif op == "win":
            out.append(("win", c.window_s(*args)))
        elif op == "admit":
            try:
                c.admit(*args)
                out.append(("admit", None))
            except mod.Shed as e:
                out.append(("shed", e.priority, e.reason, e.retry_after_ms))
        elif op == "target":
            c.set_target(*args)
    snap = c.snapshot()
    return out, snap


def _script(seed):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(300):
        r = rng.random()
        if r < 0.4:
            script.append(("lat", (float(rng.gamma(2.0, 0.004)),)))
        elif r < 0.55:
            script.append(("disp", (float(rng.gamma(2.0, 0.003)),
                                    int(rng.integers(1, 200)))))
        elif r < 0.8:
            script.append(("win", (int(rng.integers(0, 400)),)))
        elif r < 0.98:
            script.append(("admit", (int(rng.integers(0, 10)),
                                     int(rng.integers(0, 400)),
                                     int(rng.integers(1, 65)))))
        else:
            script.append(("target", (float(rng.choice([5.0, 20.0, 0.0])),)))
    return script


@pytest.mark.parametrize("slo_ms", [None, 8.0, 30.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decides_as_the_references(slo_ms, seed):
    script = _script(seed)
    got, gsnap = _drive(__import__("h2o3_tpu_torch.serving.slo",
                                   fromlist=["x"]), slo_ms, script)
    want, wsnap = _drive(jslo, slo_ms, script)
    assert got == want
    assert gsnap == wsnap


def test_window_from_env_and_priorities_as_the_references(monkeypatch):
    from h2o3_tpu_torch.serving import slo as pslo
    for raw in ("1.0", "7.5", "oops"):
        monkeypatch.setenv("H2O3TPU_SCORE_WINDOW_MS", raw)
        assert pslo.window_s_from_env() == jslo.window_s_from_env()
    for raw in ("", "40", "-3", "x"):
        monkeypatch.setenv("H2O3TPU_SCORE_SLO_MS", raw)
        assert pslo.slo_ms_from_env() == jslo.slo_ms_from_env()
    for p in (None, -3, 0, 5, 9, 42, "7", "nope", 3.9):
        assert clamp_priority(p) == jslo.clamp_priority(p)
