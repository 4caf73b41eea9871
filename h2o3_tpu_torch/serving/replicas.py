"""Scoring replica pool — stream-leased serving capacity — the port of
``h2o3_tpu/serving/replicas.py``.

The serving tier's resource-island half (the TensorFlow-serving case,
PAPERS.md: production inference wants its own queue and admission
policy, not best-effort sharing with training): a :class:`ReplicaPool`
holds N :class:`ScoringReplica`\\ s, each a dedicated thread holding one
``MeshScheduler.lease(small=True, algo="scoring")`` for the replica's
lifetime. The JAX package's lease is a slice of the device mesh; the
port's is a CUDA stream of the scheduler's pool
(:mod:`h2o3_tpu_torch.orchestration.scheduler`), so each replica's
captures and replays run on its own stream. Each replica owns its own
:class:`ScorerCache` (its own graphs and memory pools) and per-model
:class:`ModelBatcher` seats.

Routing is least-loaded (queued rows + in-flight dispatches). Admission
of a model onto a replica **speculatively captures the power-of-two batch
buckets** in the background (the reference pre-compiles them), so a fresh
replica serves warm from its first request instead of paying a capture
inside someone's latency budget.

Scaling: the pool scales UP when the queue-wait EMA eats more than a
quarter of the SLO budget AND the compute observatory still shows
headroom — the scoring loop's utilization against the card's peak row
(``utils/costs.py``; off the card it is unknown, which reads as headroom,
as the reference reads an unknown backend) — and scales DOWN when queue
wait is negligible. Replica count never exceeds the scheduler's stream
count and never drops below one. Leases release on
``stop()``/``shutdown()``. Pre-captures, scale events and the replica
count feed ``h2o3_score_precompile_total``,
``h2o3_score_scale_events_total`` and ``h2o3_score_replicas``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.serving.scorer import MAX_BUCKET, MIN_BUCKET, ScorerCache

#: seconds between scale decisions — the pool must not thrash a lease
#: up/down on one noisy batch
SCALE_COOLDOWN_S = 2.0


def replicas_from_env() -> int:
    """``H2O3TPU_SCORE_REPLICAS`` (resolved at call time): 0/unset = no
    pool, the in-process path."""
    try:
        return max(int(os.environ.get("H2O3TPU_SCORE_REPLICAS", "0") or 0), 0)
    except ValueError:
        return 0


def precompile_buckets_from_env() -> tuple[int, ...]:
    """Buckets speculatively captured when a model lands on a replica
    (``H2O3TPU_SCORE_PRECOMPILE``, comma-separated; empty string disables).
    Default: every power of two from the min bucket to 128."""
    raw = os.environ.get("H2O3TPU_SCORE_PRECOMPILE")
    if raw is not None:
        out = []
        for tok in raw.split(","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                b = int(tok)
            except ValueError:
                continue
            if MIN_BUCKET <= b <= MAX_BUCKET and (b & (b - 1)) == 0:
                out.append(b)
        return tuple(sorted(set(out)))
    out, b = [], MIN_BUCKET
    while b <= min(128, MAX_BUCKET):
        out.append(b)
        b <<= 1
    return tuple(out)


def mfu_ceiling_from_env() -> float:
    """Scoring-loop utilization above which scale-up stops adding
    replicas (``H2O3TPU_SCORE_MFU_CEILING``, default 0.6): past this the
    device, not the batching, is the bottleneck."""
    try:
        return float(os.environ.get("H2O3TPU_SCORE_MFU_CEILING", "0.6"))
    except ValueError:
        return 0.6


class ScoringReplica:
    """One serving replica: a lifetime stream lease + its own scorer cache
    and per-model batcher seats."""

    def __init__(self, rid: int, scheduler=None, ready_timeout: float = 30.0):
        self.rid = rid
        self.label = f"r{rid}"
        self.scheduler = scheduler
        self.cache = ScorerCache()
        self.stream = None           # the leased CUDA stream (None on the CPU)
        self.devices: tuple = ()
        self.slice_label: str | None = None
        self._batchers: dict[str, object] = {}     # model key -> ModelBatcher
        self._lock = lockwitness.lock("serving.replicas.ScoringReplica._lock")
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._lease_error: BaseException | None = None
        self.busy_seconds = 0.0
        self.dispatches = 0
        self.dispatched_rows = 0
        self.queue_wait_seconds = 0.0
        self.created_at = time.monotonic()
        self._warming = 0            # outstanding pre-capture threads
        self.precaptured = 0
        self.precapture_failed = 0
        self._thread = threading.Thread(target=self._hold_lease,
                                        name=f"score-replica-{rid}",
                                        daemon=True)
        self._thread.start()
        # bounded readiness wait: a lease that cannot be granted inside
        # the ceiling fails the replica instead of parking the admitting
        # caller forever (the holder thread notices _stop the moment a
        # stream finally frees and releases it right back)
        deadline = time.monotonic() + ready_timeout
        while not self._ready.wait(timeout=0.5):
            if time.monotonic() > deadline:
                self._stop.set()
                raise RuntimeError(
                    f"replica {self.label} could not acquire a stream lease "
                    f"within {ready_timeout:.0f}s — is every stream "
                    "leased?")
        if self._lease_error is not None:
            raise RuntimeError(
                f"replica {self.label} lease failed: {self._lease_error!r}")

    def _hold_lease(self) -> None:
        """Dedicated thread: enter the stream lease and hold it for the
        replica's lifetime (the lease context manager both takes and, on
        exit, RELEASES the stream)."""
        try:
            cm = (self.scheduler.lease(small=True, algo="scoring")
                  if self.scheduler is not None
                  else contextlib.nullcontext(None))
            with cm as lease:
                if lease is not None:
                    with self._lock:
                        self.stream = lease.stream
                        self.devices = (str(self.scheduler.device),)
                        self.slice_label = lease.label
                self._ready.set()
                while not self._stop.wait(timeout=0.5):
                    pass
        except BaseException as e:   # noqa: BLE001 — surfaced to the spawner
            with self._lock:
                self._lease_error = e
        finally:
            self._ready.set()

    # -- seats ---------------------------------------------------------------

    def batcher_for(self, entry):
        """Get-or-create this replica's batcher seat for ``entry``'s
        model; the seat captures into the REPLICA's cache and dispatches
        on the replica's stream. A STOPPED entry (eviction won
        the race between admit and routing) raises ``Evicted`` — the
        seat must not be resurrected for a model the service just
        dropped (the service re-admits and retries, exactly like the
        non-pool stopped-batcher path)."""
        from h2o3_tpu_torch.serving.batcher import Evicted, ModelBatcher
        with self._lock:
            if getattr(entry, "stopped", False):
                raise Evicted(f"model {entry.key!r} was evicted")
            b = self._batchers.get(entry.key)
            if b is None or b._entry is not entry:
                if b is not None:
                    b.stop()
                b = ModelBatcher(entry, cache=self.cache, replica=self)
                self._batchers[entry.key] = b
            return b

    def drop_model(self, key: str, model) -> None:
        with self._lock:
            b = self._batchers.pop(key, None)
        if b is not None:
            b.stop()
        self.cache.drop_model(model)

    def load(self) -> int:
        """Routing weight: queued rows across seats plus a bucket's worth
        per in-flight dispatch (a replica mid-dispatch is not free even
        with an empty queue)."""
        with self._lock:
            seats = list(self._batchers.values())
        total = 0
        for b in seats:
            with b._cond:
                total += sum(p.n for p in b._queue)
                if b._dispatching:
                    total += MIN_BUCKET
        return total

    def busy(self) -> bool:
        with self._lock:
            seats = list(self._batchers.values())
        return any(b.busy() for b in seats)

    def model_busy(self, key: str) -> bool:
        with self._lock:
            b = self._batchers.get(key)
        return b is not None and b.busy()

    def record_dispatch(self, wall_s: float, rows: int,
                        queue_wait_s: float) -> None:
        with self._lock:
            self.busy_seconds += wall_s
            self.dispatches += 1
            self.dispatched_rows += int(rows)
            self.queue_wait_seconds += max(queue_wait_s, 0.0)

    # -- speculative pre-capture ---------------------------------------------

    def precompile(self, entry, buckets=None) -> threading.Thread:
        """Capture ``entry``'s power-of-two buckets into this replica's
        cache in the background, on the replica's stream: a fresh replica
        serves warm from its first request. Returns the worker thread so
        tests can join it."""
        if buckets is None:
            buckets = precompile_buckets_from_env()
        with self._lock:
            self._warming += 1       # routing de-prefers a cold replica

        def _warm():
            try:
                for b in buckets:
                    if self._stop.is_set() or getattr(entry, "stopped",
                                                      False):
                        return
                    try:
                        _tm.SCORE_PRECOMPILE.labels(event="scheduled").inc()
                        if self.stream is not None:
                            with torch.cuda.stream(self.stream):
                                self.cache.get(entry.model, entry.schema, b)
                        else:
                            self.cache.get(entry.model, entry.schema, b)
                        with self._lock:
                            self.precaptured += 1
                        _tm.SCORE_PRECOMPILE.labels(event="compiled").inc()
                    except Exception:   # noqa: BLE001 — speculative: never fatal
                        with self._lock:
                            self.precapture_failed += 1
                        _tm.SCORE_PRECOMPILE.labels(event="failed").inc()
            finally:
                if getattr(entry, "stopped", False):
                    # an eviction raced the warm-up: a capture that was
                    # already in flight when the flag flipped must not
                    # survive drop_model (graph memory would leak past
                    # the byte-accounted residency)
                    self.cache.drop_model(entry.model)
                with self._lock:
                    self._warming -= 1

        t = threading.Thread(target=_warm, daemon=True,
                             name=f"score-precompile-{self.label}")
        t.start()
        return t

    def warming(self) -> bool:
        """True while speculative pre-captures are still running — the
        router prefers warm replicas so a freshly scaled-up one doesn't
        win least-loaded (load 0) and serve its first requests cold."""
        with self._lock:
            return self._warming > 0

    # -- lifecycle -----------------------------------------------------------

    def stop(self, timeout: float = 10.0) -> None:
        """Stop seats, release the stream lease (the holder thread exits
        its ``with lease`` block), drop captured signatures."""
        with self._lock:
            seats = list(self._batchers.values())
            self._batchers.clear()
        for b in seats:
            b.stop()
        self._stop.set()
        self._thread.join(timeout=timeout)
        self.cache.clear()

    def snapshot(self) -> dict:
        with self._lock:
            models = sorted(self._batchers)
            return {"replica": self.label,
                    "slice": self.slice_label,
                    "devices": list(self.devices),
                    "models": models,
                    "load_rows": None,    # filled by the pool (needs locks)
                    "busy_seconds": round(self.busy_seconds, 6),
                    "dispatches": self.dispatches,
                    "rows": self.dispatched_rows,
                    "queue_wait_seconds": round(self.queue_wait_seconds, 6),
                    "precaptured": self.precaptured,
                    "precapture_failed": self.precapture_failed,
                    "cache": self.cache.stats()}


class ReplicaPool:
    """N stream-leased replicas + least-loaded routing + the scale policy."""

    def __init__(self, n: int, scheduler=None, max_replicas: int | None = None):
        n = max(int(n), 1)
        self.scheduler = scheduler
        cap = max_replicas
        if cap is None:
            cap = n
        if scheduler is not None and getattr(scheduler, "n", 1) > 1:
            # an (n+1)th replica would park forever waiting for a stream
            cap = min(max(cap, n), scheduler.n)
            n = min(n, scheduler.n)
        self.min_replicas = 1
        self.max_replicas = max(cap, 1)
        self._lock = lockwitness.lock("serving.replicas.ReplicaPool._lock")
        self._next_rid = 0
        self._shutdown = False
        self._replicas: list[ScoringReplica] = []
        self._wait_ema_s: float | None = None
        self._last_scale = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        try:
            with self._lock:       # honor _spawn_locked's contract even
                for _ in range(n):  # though the pool is still unpublished
                    self._spawn_locked()
        except BaseException:
            # a half-built pool must not leak the leases it DID acquire
            for rep in self._replicas:
                rep.stop()
            self._replicas.clear()
            raise
        self._export()

    # -- membership ----------------------------------------------------------

    def _spawn_locked(self, ready_timeout: float = 30.0) -> ScoringReplica:
        rid, self._next_rid = self._next_rid, self._next_rid + 1
        rep = ScoringReplica(rid, scheduler=self.scheduler,
                             ready_timeout=ready_timeout)
        self._replicas.append(rep)
        return rep

    @property
    def replicas(self) -> list[ScoringReplica]:
        with self._lock:
            return list(self._replicas)

    def route(self) -> ScoringReplica:
        """Least-loaded replica among the WARM ones (a replica whose
        speculative pre-captures are still running only serves when every
        replica is warming); ties break to the oldest — caches warmest."""
        reps = self.replicas
        if not reps:
            raise RuntimeError("replica pool is empty (shut down?)")
        return min(reps, key=lambda r: (r.warming(), r.load(), r.rid))

    # -- scale policy --------------------------------------------------------

    def observe_wait(self, wait_s: float) -> None:
        """Fold one request's queue wait (enqueue -> dispatch start) into
        the scale signal's EMA."""
        with self._lock:
            if self._wait_ema_s is None:
                self._wait_ema_s = float(wait_s)
            else:
                self._wait_ema_s += 0.2 * (wait_s - self._wait_ema_s)

    @property
    def wait_ema_s(self) -> float | None:
        with self._lock:
            return self._wait_ema_s

    def mfu_headroom(self) -> bool:
        """True while the compute observatory shows the scoring loop
        under the MFU ceiling (its utilization against the card's peak
        row). Off the card utilization is unknown, and unknown reads as
        headroom, as the reference reads an unknown backend: there is no
        roofline to be against."""
        from h2o3_tpu_torch.utils.costs import COSTS
        util = COSTS.loops().get("scoring", {}).get("utilization")
        return util is None or util < mfu_ceiling_from_env()

    def maybe_scale(self, slo_ms: float | None,
                    resident_entries=()) -> str | None:
        """One scale decision: up when queue wait eats >25% of the SLO
        budget (and MFU headroom remains), down when it reads <2%.
        Returns "up"/"down"/None; cooldown-limited. The decision runs
        under the pool lock, the ACTION does not: a scale-up's lease wait
        (bounded 5s) and a scale-down's thread join must never block
        ``route()`` — only the one triggering request pays."""
        if slo_ms is None or slo_ms <= 0:
            return None
        budget_s = float(slo_ms) / 1e3
        victim = None
        rid = None
        with self._lock:
            ema = self._wait_ema_s
            now = time.monotonic()
            if ema is None or now - self._last_scale < SCALE_COOLDOWN_S:
                return None
            n = len(self._replicas)
            if ema > 0.25 * budget_s and n < self.max_replicas:
                if not self.mfu_headroom():
                    return None
                # reserve the decision (cooldown + rid) and spawn OUTSIDE
                self._last_scale = now
                self._wait_ema_s = None     # fresh signal for the new shape
                rid, self._next_rid = self._next_rid, self._next_rid + 1
            elif ema < 0.02 * budget_s and n > self.min_replicas:
                # retire the least-loaded idle replica
                victims = sorted(self._replicas,
                                 key=lambda r: (r.load(), -r.rid))
                victim = victims[0]
                if victim.busy():
                    return None
                self._replicas.remove(victim)
                self._last_scale = now
                self.scale_downs += 1
                self._wait_ema_s = None
            else:
                return None
        if rid is not None:
            try:
                # short lease ceiling: a layout contended by another run
                # (the stream pool is process-wide per layout) must abort
                # the scale, not stall this request 30s or surface a 500
                rep = ScoringReplica(rid, scheduler=self.scheduler,
                                     ready_timeout=5.0)
            except RuntimeError:
                return None
            for entry in resident_entries:
                rep.precompile(entry)       # route() defers to warm peers
            with self._lock:
                if self._shutdown:
                    dead = True             # reset()/shutdown won the race
                else:
                    dead = False
                    self._replicas.append(rep)
                    self.scale_ups += 1
            if dead:
                # appending to a dead pool would leak the stream lease +
                # thread forever — the no-leaked-streams contract
                rep.stop()
                return None
            _tm.SCORE_SCALE_EVENTS.labels(direction="up").inc()
            self._export()
            return "up"
        victim.stop()
        _tm.SCORE_SCALE_EVENTS.labels(direction="down").inc()
        self._export()
        return "down"

    def _export(self) -> None:
        _tm.SCORE_REPLICAS.set(len(self.replicas))

    # -- fan-out helpers (service eviction paths) ----------------------------

    def drop_model(self, key: str, model) -> None:
        for rep in self.replicas:
            rep.drop_model(key, model)

    def model_busy(self, key: str) -> bool:
        return any(rep.model_busy(key) for rep in self.replicas)

    def any_busy(self) -> bool:
        return any(rep.busy() for rep in self.replicas)

    # -- lifecycle / introspection -------------------------------------------

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True       # a racing scale-up stops its replica
            reps, self._replicas = self._replicas, []
        for rep in reps:
            rep.stop()
        self._export()

    def snapshot(self) -> dict:
        reps = self.replicas
        rows = []
        for r in reps:
            snap = r.snapshot()
            snap["load_rows"] = r.load()
            rows.append(snap)
        ema = self.wait_ema_s
        return {"count": len(reps),
                "min": self.min_replicas, "max": self.max_replicas,
                "queue_wait_ema_ms": (round(ema * 1e3, 3)
                                      if ema is not None else None),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "mfu_headroom": self.mfu_headroom(),
                "replicas": rows}
