"""ScoringService — multi-model residency with byte-accounted admission —
the port of ``h2o3_tpu/serving/service.py``.

Reference composite (PAPERS.md): TensorFlow-serving's build-once/serve-
many lifecycle plus Clipper-style multi-model residency — many models
share the device, cold ones are evicted by bytes, and an over-budget
request degrades to a retryable error instead of an OOM.

A model scored through ``/3/Score`` becomes *resident*: its serving schema
is derived once, each of its batcher seats owns a request queue, and its
captured graphs accumulate in a :class:`ScorerCache`. Residency is
byte-accounted with the same measure ``/3/Memory`` reports per DKV key
(:func:`~h2o3_tpu_torch.utils.memory.value_kind_bytes` — the memory
meter's artifact-size walk): admission of a cold model under a configured
budget (``H2O3TPU_SERVE_BUDGET_BYTES``) LRU-evicts idle resident models
first, and when nothing evictable remains the request gets
:class:`ServiceUnavailable` — the REST layer maps it to
``503 + Retry-After`` rather than letting the device OOM. Models with
in-flight batches are never evicted. Eviction drops the model's graphs
(and their memory pool) and the worker thread(s); the DKV copy is
untouched (that *is* the cold tier — the next request re-admits it). A
re-put model (a new object under the key) is refreshed at its next
request.

SLO layer: every resident model owns an
:class:`~h2o3_tpu_torch.serving.slo.SLOController` — with a target set
(``H2O3TPU_SCORE_SLO_MS`` or per-request ``slo_ms``) the collect window
adapts and overloaded admissions shed by priority with
``503 + Retry-After``; with no target the tier is the fixed-window path,
bit for bit. With ``H2O3TPU_SCORE_REPLICAS`` > 0 (or
:meth:`ScoringService.configure_replicas`) requests route least-loaded
across a :class:`~h2o3_tpu_torch.serving.replicas.ReplicaPool` of
stream-leased replicas instead of one in-process seat.

Every request counts into ``h2o3_score_requests_total{algo,status}`` and
``h2o3_score_seconds``; sheds into ``h2o3_score_shed_total``, the collect
window, queue wait and residency into their gauges and histogram. With the
ops plane loaded, a request charges its tenant's device-seconds: its share
(by rows) of the batch's time on the card, read from the CUDA events
around the batch's dispatch (the wall time of the dispatch on the CPU).
"""

from __future__ import annotations

import os
import sys
import time

from h2o3_tpu_torch.serving.batcher import Evicted, ModelBatcher
from h2o3_tpu_torch.serving.schema import NotServable, serving_schema
from h2o3_tpu_torch.serving.scorer import ScorerCache
from h2o3_tpu_torch.serving.slo import SLOController, Shed, clamp_priority
from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils.memory import MEMORY, value_kind_bytes
from h2o3_tpu_torch.utils.registry import DKV

#: requests between opportunistic replica scale checks (cheap, but not
#: free — snapshot reads under locks)
_SCALE_CHECK_EVERY = 32


def _tenancy_mod():
    """The ops plane's tenancy module ONLY if something already imported it
    — the scoring hot path must not be what pulls in multi-tenancy."""
    return sys.modules.get("h2o3_tpu_torch.ops_plane.tenancy")


class ServiceUnavailable(RuntimeError):
    """Admission refused under the residency budget (HTTP 503 + retry)."""

    def __init__(self, msg: str, retry_after_ms: int = 1000):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class _Resident:
    """One resident model: schema + SLO controller + batcher seat(s) +
    byte accounting. With a replica pool the seats live on the replicas
    (one per replica that served this model); without one, ``batcher`` is
    the single in-process seat."""

    __slots__ = ("key", "model", "schema", "cache", "batcher", "nbytes",
                 "last_used", "requests", "slo", "pool", "stopped")

    def __init__(self, key: str, model, schema, cache: ScorerCache,
                 nbytes: int, pool=None):
        self.key = key
        self.model = model
        self.schema = schema
        self.cache = cache
        self.nbytes = nbytes     # computed once by the admitting caller
        self.last_used = time.monotonic()
        self.requests = 0
        self.slo = SLOController()
        self.pool = pool
        self.stopped = False     # set by eviction; replica seats check it
        self.batcher = ModelBatcher(self) if pool is None else None

    def submit(self, num, cat, n: int, priority: int):
        """Route to the least-loaded replica seat (pool) or the local
        batcher; returns ``(pending, replica_label)``."""
        pool = self.pool
        if pool is None:
            return self.batcher.submit(num, cat, n, priority=priority), None
        rep = pool.route()
        return rep.batcher_for(self).submit(num, cat, n,
                                            priority=priority), rep.label

    def busy(self) -> bool:
        if self.pool is None:
            return self.batcher.busy()
        return self.pool.model_busy(self.key)

    def stop(self) -> None:
        # the flag FIRST: a score() racing this eviction between _admit
        # and submit must find a dead entry (batcher_for refuses to
        # resurrect a seat for it), not re-create what we just dropped
        self.stopped = True
        if self.batcher is not None:
            self.batcher.stop()
        if self.pool is not None:
            self.pool.drop_model(self.key, self.model)


class ScoringService:
    """Process-wide scoring tier (singleton :data:`SCORING`)."""

    def __init__(self, budget_bytes: int | None = None):
        env = os.environ.get("H2O3TPU_SERVE_BUDGET_BYTES")
        #: residency budget in artifact bytes; None = unlimited (no eviction)
        self.budget_bytes = budget_bytes if budget_bytes is not None else (
            int(env) if env else None)
        self._lock = lockwitness.rlock("serving.service.ScoringService._lock")
        self._resident: dict[str, _Resident] = {}
        self.cache = ScorerCache()
        self.evictions = 0
        #: replica pool — created lazily on first admission (constructing
        #: it eagerly would touch the card at module import) or
        #: explicitly via :meth:`configure_replicas`
        self.pool = None
        self._pool_checked = False
        self._shed: dict[tuple, int] = {}      # (reason, priority) -> count
        self._admission_base: dict[str, float] = {}  # key -> original slo_ms

    # -- replica pool ---------------------------------------------------------

    def configure_replicas(self, n: int, scheduler=None) -> None:
        """Install a replica pool of ``n`` stream-leased replicas (``0``
        tears any pool down). ``scheduler`` defaults to a fresh
        ``MeshScheduler(slices=n)`` so each replica leases a stream of its
        own. Pool CONSTRUCTION (lease waits, up to 30s per replica on a
        contended layout) runs OUTSIDE the service lock — warm-path
        scorers of other models must not stall behind it."""
        from h2o3_tpu_torch.serving.replicas import ReplicaPool
        new_pool = None
        if n and int(n) > 0:
            if scheduler is None:
                from h2o3_tpu_torch.orchestration.scheduler import \
                    MeshScheduler
                scheduler = MeshScheduler(slices=int(n))
            new_pool = ReplicaPool(int(n), scheduler=scheduler)
        with self._lock:
            old, self.pool = self.pool, new_pool
            self._pool_checked = True
            # existing residents re-point at the NEW pool — or, on
            # teardown (n=0), back at a local seat: an entry left holding
            # the shut-down pool would 500 on every request
            for entry in self._resident.values():
                if new_pool is None:
                    # the local seat must exist BEFORE pool goes None: a
                    # concurrent submit() reads pool first, batcher second
                    # — the reverse order would hand it a None batcher
                    if entry.batcher is None or entry.batcher._stopped:
                        entry.batcher = ModelBatcher(entry)
                    entry.pool = None
                else:
                    entry.pool = new_pool
                    if entry.batcher is not None:
                        entry.batcher.stop()    # seats live on replicas now
                        entry.batcher = None
                    for rep in new_pool.replicas:
                        rep.precompile(entry)
        if old is not None:
            old.shutdown()

    def _ensure_pool(self):
        """Resolve ``H2O3TPU_SCORE_REPLICAS`` once per service lifetime
        (reset() re-arms it) — lazily, so importing the serving package
        never takes streams. A construction failure (the stream layout
        contended by other runs past the lease ceiling) re-arms
        the check and surfaces RETRYABLE 503, never a 500."""
        with self._lock:
            if self._pool_checked:
                return self.pool
            self._pool_checked = True
        from h2o3_tpu_torch.serving.replicas import replicas_from_env
        n = replicas_from_env()
        if n > 0:
            try:
                self.configure_replicas(n)
            except RuntimeError as e:
                with self._lock:
                    self._pool_checked = False   # next admission retries
                raise ServiceUnavailable(
                    f"scoring replica pool unavailable: {e}") from None
        return self.pool

    # -- admission widening (ops-plane overload relief) ----------------------

    def widen_admission(self, factor: float = 1.5,
                        cap: float = 4.0) -> "list[dict]":
        """Overload relief without a replica: raise every resident model's
        SLO admission target by ``factor`` so the shed estimator admits a
        deeper queue. Cumulative widening is bounded at ``cap``× each
        model's ORIGINAL target (recorded on first widen). Models with no
        target are untouched. Returns ``[{model, target_ms}]`` for the
        audit record; :meth:`restore_admission` is the rollback."""
        with self._lock:
            entries = list(self._resident.values())
            plan = []
            for e in entries:
                target = e.slo.slo_ms
                if not target:
                    continue
                base = self._admission_base.setdefault(e.key, target)
                new_target = min(target * factor, base * cap)
                if new_target > target:
                    plan.append((e, new_target))
        changed = []
        for e, new_target in plan:
            # set_target outside the service lock (slo has its own lock;
            # keep the order service→slo one-way and brief)
            e.slo.set_target(new_target)
            changed.append({"model": e.key,
                            "target_ms": round(new_target, 3)})
        return changed

    def restore_admission(self) -> "list[dict]":
        """Undo :meth:`widen_admission`: every widened resident returns to
        its recorded original target."""
        with self._lock:
            base = dict(self._admission_base)
            self._admission_base.clear()
            entries = {e.key: e for e in self._resident.values()}
        restored = []
        for key, orig in base.items():
            e = entries.get(key)
            if e is not None:
                e.slo.set_target(orig)
                restored.append({"model": key, "target_ms": orig})
        return restored

    # -- scoring -------------------------------------------------------------

    def score(self, model_key: str, rows, columns=None, priority=None,
              slo_ms=None) -> dict:
        """Score JSON ``rows`` against ``model_key`` through the batched
        path; returns the ``/3/Score`` payload dict. ``priority`` (0-9,
        default 5) orders shedding under overload; ``slo_ms`` overrides
        the model's latency target at admit."""
        t0 = time.perf_counter()
        if not isinstance(rows, (list, tuple)) or not rows:
            # reject before admission: an invalid request must not be able
            # to churn residency (evicting warm models under a budget) for
            # rows that could never score
            raise ValueError("rows must be a non-empty JSON array")
        pr = clamp_priority(priority)
        try:
            entry = self._admit(model_key)
        except Exception:
            _tm.SCORE_REQUESTS.labels(algo="unknown", status="error").inc()
            raise
        if slo_ms is not None:
            entry.slo.set_target(slo_ms)
        algo = getattr(entry.model, "algo", "model")
        replica = None
        # an eviction can race the window between _admit releasing the
        # service lock and submit() enqueueing (budgeted admit of another
        # model, or a key re-put): transient — re-admit once rather than
        # surfacing a server error
        try:
            for attempt in (0, 1):
                num, cat = entry.schema.adapt_rows(rows, columns)
                try:
                    pending, replica = entry.submit(num, cat, len(rows), pr)
                    break
                except Shed as e:
                    # the admission estimator turned this request away
                    # before it entered the queue: accounted, retryable
                    self._count_shed(e.reason, pr)
                    raise ServiceUnavailable(
                        str(e), retry_after_ms=e.retry_after_ms) from None
                except TimeoutError as e:
                    # a queue that never drained within the wait ceiling
                    # is a load condition: retryable 503, not a fault
                    self._count_shed("timeout", pr)
                    raise ServiceUnavailable(str(e)) from None
                except Evicted:
                    if attempt:
                        self._count_shed("evicted", pr)
                        raise ServiceUnavailable(
                            f"{model_key!r} keeps losing residency under "
                            "the budget; retry shortly")
                    with self._lock:
                        # a stopped batcher can never serve again: drop
                        # the entry if it somehow remained resident, so
                        # the re-admit below builds a fresh one
                        if self._resident.get(model_key) is entry:
                            self._evict_locked(entry)
                    entry = self._admit(model_key)
            out = _finalize(entry.model, pending.result, len(rows))
        except Exception:
            _tm.SCORE_REQUESTS.labels(algo=algo, status="error").inc()
            raise
        latency = time.perf_counter() - t0
        entry.slo.record_latency(latency)
        # the label's cardinality is bounded by residency (the budget's LRU)
        _tm.SCORE_WINDOW_MS.labels(model=model_key).set(
            entry.slo.current_window_s() * 1e3)
        if pending.queue_wait_s is not None:
            _tm.SCORE_QUEUE_WAIT.observe(pending.queue_wait_s)
            if entry.pool is not None:
                entry.pool.observe_wait(pending.queue_wait_s)
        _tm.SCORE_REQUESTS.labels(algo=algo, status="ok").inc()
        _tm.SCORE_SECONDS.labels(algo=algo).observe(latency)
        ten = _tenancy_mod()
        if ten is not None:
            busy = pending.device_s
            if busy is None:
                busy = latency - (pending.queue_wait_s or 0.0)
            share = max(busy, 0.0) * (
                len(rows) / max(pending.batch_rows or 0, len(rows)))
            ten.QUOTAS.charge_device_seconds(ten.current_tenant(), share)
        if entry.pool is not None and entry.requests % _SCALE_CHECK_EVERY == 0:
            with self._lock:
                residents = list(self._resident.values())
            entry.pool.maybe_scale(entry.slo.slo_ms,
                                   resident_entries=residents)
        out.update(model=model_key, rows=len(rows),
                   batch_rows=pending.batch_rows,
                   batch_requests=pending.batch_requests,
                   priority=pr)
        if replica is not None:
            out["replica"] = replica
        return out

    def _count_shed(self, reason: str, priority: int) -> None:
        with self._lock:
            k = (reason, priority)
            self._shed[k] = self._shed.get(k, 0) + 1
        _tm.SCORE_SHED.labels(reason=reason, priority=str(priority)).inc()

    # -- residency / admission ----------------------------------------------

    def _admit(self, model_key: str) -> _Resident:
        self._ensure_pool()
        # DKV.get can fault a spilled model in from disk — a full snapshot
        # load plus device transfer — so it must run BEFORE the service
        # lock, or every warm-path scorer of every other model stalls
        # behind one cold fault-in
        current = DKV.get(model_key)
        with self._lock:
            entry = self._resident.get(model_key)
            if entry is not None and entry.model is current:
                entry.last_used = time.monotonic()
                entry.requests += 1
                return entry
        # cold path: the heavy work — artifact byte walk + schema/level-map
        # derivation — runs OUTSIDE the service lock so warm-path scorers
        # of other models never stall behind an admission (same reason
        # ScorerCache compiles outside its lock); re-checked under the lock
        # below since a concurrent admit may have won
        model = current
        if model is None:
            model = DKV[model_key]     # KeyError → 404 upstream
        if not hasattr(model, "_score_raw"):
            raise NotServable(f"{model_key!r} is not a scorable model")
        incoming = value_kind_bytes(model)[1]
        schema = serving_schema(model)
        with self._lock:
            entry = self._resident.get(model_key)
            if entry is not None and entry.model is model:
                entry.last_used = time.monotonic()
                entry.requests += 1
                return entry           # concurrent admit won the race
            if entry is not None:      # key re-put: stale resident copy
                self._evict_locked(entry)
            self._make_room_locked(incoming, model_key)
            # pool re-read UNDER the lock: an admission that lost the
            # _ensure_pool race must not pin its model to a local seat
            # for the resident's whole lifetime
            pool = self.pool
            entry = _Resident(model_key, model, schema, self.cache, incoming,
                              pool=pool)
            self._resident[model_key] = entry
            entry.requests += 1
            self._export_locked()
        if pool is not None:
            # speculative bucket pre-capture at admission: every replica
            # warms the power-of-two buckets in the background, so
            # wherever routing lands this model next, the graph is
            # already there
            for rep in pool.replicas:
                rep.precompile(entry)
        return entry

    def _make_room_locked(self, incoming: int, for_key: str) -> None:
        if self.budget_bytes is None:
            return
        if incoming > self.budget_bytes:
            # no amount of eviction can ever fit it: a terminal client
            # error, not a 503 a well-behaved retrier would loop on forever
            raise NotServable(
                f"{for_key!r} needs {incoming} artifact bytes but the "
                f"residency budget is {self.budget_bytes}; raise "
                "H2O3TPU_SERVE_BUDGET_BYTES to serve this model")
        def resident_bytes():   # noqa: E306
            return sum(e.nbytes for e in self._resident.values())
        if resident_bytes() + incoming <= self.budget_bytes:
            return
        # LRU eviction of IDLE models only: a model with queued requests or
        # a batch on the device is hot by definition. Feasibility first —
        # evicting warm signatures for a request that 503s anyway would
        # make an infeasible admission also destroy working residents.
        victims = [v for v in sorted(self._resident.values(),
                                     key=lambda e: e.last_used)
                   if v.key != for_key and not v.busy()]
        evictable = sum(v.nbytes for v in victims)
        if resident_bytes() - evictable + incoming > self.budget_bytes:
            raise ServiceUnavailable(
                f"scoring tier over budget: {incoming} artifact bytes for "
                f"{for_key!r} do not fit in "
                f"{self.budget_bytes} with {len(self._resident)} resident "
                "model(s) busy; retry shortly")
        for v in victims:
            self._evict_locked(v)
            if resident_bytes() + incoming <= self.budget_bytes:
                return

    def _evict_locked(self, entry: _Resident) -> None:
        self._resident.pop(entry.key, None)
        entry.stop()
        self.cache.drop_model(entry.model)
        self.evictions += 1
        self._export_locked()

    def _export_locked(self) -> None:
        _tm.SCORE_RESIDENT_MODELS.set(len(self._resident))
        _tm.SCORE_RESIDENT_BYTES.set(
            sum(e.nbytes for e in self._resident.values()))

    def evict(self, model_key: str) -> bool:
        """Explicit eviction (REST DELETE + tests)."""
        with self._lock:
            entry = self._resident.get(model_key)
            if entry is None:
                return False
            if entry.busy():
                raise ServiceUnavailable(
                    f"{model_key!r} has in-flight batches; retry")
            self._evict_locked(entry)
            return True

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """The ``GET /3/Score`` payload: residency + cache counters (with
        each model's scorer modes, ``"graph"`` or ``"eager"``) + the
        SLO/shed/replica view; the device/host watermarks ride along so
        admission decisions can be read against the same numbers
        ``/3/Memory`` serves."""
        with self._lock:
            resident = [{"model": e.key,
                         "algo": getattr(e.model, "algo", "model"),
                         "bytes": e.nbytes, "requests": e.requests,
                         "idle_secs": round(time.monotonic() - e.last_used, 3),
                         "slo": e.slo.snapshot()}
                        for e in sorted(self._resident.values(),
                                        key=lambda e: -e.last_used)]
            budget = self.budget_bytes
            evictions = self.evictions
            shed = [{"reason": r, "priority": p, "count": c}
                    for (r, p), c in sorted(self._shed.items())]
            pool = self.pool
        return {"resident": resident,
                "resident_bytes": sum(r["bytes"] for r in resident),
                "budget_bytes": budget, "evictions": evictions,
                "cache": self.cache.stats(),
                "modes": self.cache.modes(),
                "shed": shed,
                "shed_total": sum(s["count"] for s in shed),
                "replicas": pool.snapshot() if pool is not None else None,
                "watermarks": MEMORY.watermarks}

    def reset(self) -> None:
        """Evict everything and zero counters (tests + shutdown). The
        cache clears wholesale. The replica pool shuts down (leases
        released) and the env knob is re-armed for the next admission."""
        with self._lock:
            for entry in list(self._resident.values()):
                entry.stop()
            self._resident.clear()
            self.cache.clear()
            self.evictions = 0
            self._shed.clear()
            self._admission_base.clear()
            pool, self.pool = self.pool, None
            self._pool_checked = False
            self._export_locked()
        if pool is not None:
            pool.shutdown()


def _finalize(model, raw, n: int) -> dict:
    """Raw device predictions → the response payload, mirroring
    :meth:`Model.predict` exactly (labels via the resettable binomial
    threshold / argmax, ``p{level}`` probability columns) so batched REST
    results are bit-identical to the frame path."""
    import numpy as np
    import torch

    from h2o3_tpu_torch.models.model_base import decision_labels
    raw = np.asarray(raw)[:n]
    nclasses = getattr(model, "nclasses", 0)
    if not nclasses or nclasses < 2 or raw.ndim != 2:
        if raw.ndim == 2:       # multi-output regression (PCA/GLRM shapes)
            return {"predictions": {f"predict_{k}": raw[:, k].tolist()
                                    for k in range(raw.shape[1])}}
        return {"predictions": {"predict": raw.tolist()}}
    # the port's argument order is (raw, model)
    labels = decision_labels(torch.from_numpy(np.ascontiguousarray(raw)),
                             model).numpy().astype(np.int64)
    domain = list(getattr(model, "response_domain", None)
                  or [str(k) for k in range(raw.shape[1])])
    preds = {"predict": [domain[int(c)] for c in labels]}
    for k, lvl in enumerate(domain[: raw.shape[1]]):
        preds[f"p{lvl}"] = raw[:, k].tolist()
    return {"predictions": preds}


#: the process-wide scoring tier (reference: the serving sidecar singleton)
SCORING = ScoringService()
