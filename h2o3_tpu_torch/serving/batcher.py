"""Dynamic micro-batcher — coalesce concurrent score requests per model —
the port of ``h2o3_tpu/serving/batcher.py``.

Reference (PAPERS.md, the TensorFlow-serving batching design): concurrent
small inference requests for one model enqueue; a short accumulation
window fuses them into ONE device dispatch and each caller gets back its
slice. Dispatch overhead (host→device copy, graph replay, the copy back)
is paid once per batch instead of once per request — p50 moves by at
most the window, throughput multiplies under load.

The window: with no SLO configured it is the fixed
``H2O3TPU_SCORE_WINDOW_MS`` (default 1 ms) — resolved at batcher
CONSTRUCTION, not at module import, so late env changes and test
monkeypatching take effect. With an SLO
target set (``H2O3TPU_SCORE_SLO_MS`` / per-request ``slo_ms``) each
batch's window comes from the model's :class:`~h2o3_tpu_torch.serving.slo.
SLOController` feedback loop instead — widened when queue depth grows,
narrowed when p99 headroom exists (docs/SERVING.md "SLO & replicas").
Either way the window closes EARLY when the queued rows fill the largest
batch bucket — a full bucket gains nothing by waiting. One daemon worker
thread per (model, replica) seat owns its queue; eviction stops the
thread.

Admission shedding rides here too: ``submit()`` asks the controller to
:meth:`~h2o3_tpu_torch.serving.slo.SLOController.admit` BEFORE enqueueing, so
overload turns into an early 503 (``Shed``) instead of a timeout burned
inside the queue.

A replica seat dispatches on its replica's CUDA stream (the stream its
scheduler lease holds); the scorer serialises replays, so two seats never
replay one graph at once.

The request that opens a fresh batch is its leader: its REST trace
context is captured, and the worker adopts it for the batch, so the
``score:batch`` span and a ``score:dispatch`` span a bucket land in the
leader's trace. Each batch feeds ``h2o3_score_batch_size`` and
``h2o3_score_batch_requests``; each request carries the batch's device
seconds (the scorers' CUDA events) for its tenant's charge.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

from h2o3_tpu_torch.serving.scorer import MAX_BUCKET
from h2o3_tpu_torch.serving.slo import window_s_from_env
from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils import tracing as _tr

#: a caller never blocks longer than this on its slice (seconds)
SCORE_TIMEOUT_S = float(os.environ.get("H2O3TPU_SCORE_TIMEOUT_S", "30"))


class Evicted(RuntimeError):
    """The model lost residency between admission and dispatch (a racing
    eviction or key re-put). Transient by construction — the service layer
    re-admits and retries; it must never surface as a client 500."""


class _Pending:
    """One request's seat in the batch: inputs, completion event, slice."""

    __slots__ = ("num", "cat", "n", "ctx", "event", "result", "error",
                 "batch_rows", "batch_requests", "priority", "t_enq",
                 "queue_wait_s", "device_s")

    def __init__(self, num: np.ndarray, cat: np.ndarray, n: int, ctx=None,
                 priority: int = 5):
        self.num = num
        self.cat = cat
        self.n = n
        self.ctx = ctx     # the batch leader's retained trace context
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.batch_rows = 0
        self.batch_requests = 0
        self.priority = priority
        self.t_enq = time.monotonic()
        self.queue_wait_s: float | None = None
        # the batch's seconds on the card (None where no event timed it)
        self.device_s: float | None = None


class ModelBatcher:
    """Per-(model, replica) request queue + dispatch worker.

    ``cache`` defaults to the entry's shared :class:`ScorerCache`; a
    replica seat passes its own so its captured graphs live with the
    replica's stream lease. ``replica`` (a
    :class:`~h2o3_tpu_torch.serving.replicas.ScoringReplica`) makes
    dispatches run on the replica's stream and feeds its utilization
    accounting.
    """

    def __init__(self, entry, window_s: float | None = None, cache=None,
                 replica=None):
        self._entry = entry          # serving/service.py _Resident
        # resolved at CONSTRUCTION (not import): late env changes and
        # monkeypatch.setenv are honored — and the SLO controller derives
        # its base window through the same seam
        self._window = float(window_s) if window_s is not None \
            else window_s_from_env()
        self._cache = cache if cache is not None else entry.cache
        self._replica = replica
        label = f"score-{entry.key}" if replica is None \
            else f"score-{entry.key}@{replica.label}"
        self._cond = lockwitness.condition(
            "serving.batcher.ModelBatcher._cond")
        self._queue: list[_Pending] = []
        self._stopped = False
        self._dispatching = False    # a drained batch is on the device
        self._thread = threading.Thread(target=self._run, name=label,
                                        daemon=True)
        self._thread.start()

    # -- caller side ---------------------------------------------------------

    def submit(self, num: np.ndarray, cat: np.ndarray, n: int,
               priority: int = 5) -> _Pending:
        """Enqueue ``n`` rows; blocks until the batch containing them has
        dispatched and this request's slice is ready (or raises). With an
        SLO set, overload sheds HERE (:class:`~h2o3_tpu_torch.serving.slo.Shed`)
        — before the rows ever enter the queue."""
        slo = getattr(self._entry, "slo", None)
        with self._cond:
            if self._stopped:
                raise Evicted(f"model {self._entry.key!r} was evicted")
            if slo is not None:
                # sheds by raising — the queue is untouched, the caller
                # gets a 503 + Retry-After in microseconds, not a timeout
                slo.admit(priority, sum(p.n for p in self._queue), n)
            # the request opening a fresh batch is its leader: capture the
            # REST root context so the batch/dispatch spans land in a trace
            ctx = _tr.TRACER.capture() if not self._queue else None
            p = _Pending(num, cat, n, ctx, priority=priority)
            self._queue.append(p)
            self._cond.notify_all()
        if not p.event.wait(SCORE_TIMEOUT_S):
            # withdraw from the queue so abandoned rows are not dispatched
            # to the device after the caller is gone — under overload that
            # would turn every timeout into wasted work plus a retry
            with self._cond:
                try:
                    self._queue.remove(p)
                    withdrawn = True
                except ValueError:
                    withdrawn = False   # already drained: the dispatch owns
                if withdrawn and p.ctx is not None:   # the ctx lifecycle
                    _tr.TRACER.release(p.ctx)
                    p.ctx = None
                self._cond.notify_all()    # let the worker re-arm now
            # an eviction may have raced the timeout: stop() already failed
            # this pending with Evicted — surface THAT (a retryable
            # residency loss), not a timeout blamed on the device
            if p.error is not None and isinstance(p.error, Evicted):
                raise p.error
            raise TimeoutError(
                f"scoring {self._entry.key!r} timed out after "
                f"{SCORE_TIMEOUT_S:.0f}s "
                + ("(batch never dispatched)" if withdrawn else
                   "(batch still on the device — likely a cold compile "
                   "or a wedged dispatch)"))
        if p.error is not None:
            raise p.error
        return p

    def busy(self) -> bool:
        """True while requests are queued or a batch is on the device —
        the residency layer must not evict a model mid-flight."""
        with self._cond:
            return bool(self._queue) or self._dispatching

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            victims = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        err = Evicted(f"model {self._entry.key!r} evicted mid-queue")
        for p in victims:
            self._fail(p, err)

    @staticmethod
    def _fail(p: _Pending, err: BaseException) -> None:
        if p.ctx is not None:
            _tr.TRACER.release(p.ctx)
            p.ctx = None
        p.error = err
        p.event.set()

    # -- worker side ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            finally:
                with self._cond:
                    self._dispatching = False

    def _collect_window_s(self, queued_rows: int) -> float:
        """This batch's accumulation window: the SLO controller's when a
        target is set (one control-law step per batch), else the fixed
        construction-time window, bit for bit."""
        slo = getattr(self._entry, "slo", None)
        if slo is not None and slo.active:
            return slo.window_s(queued_rows)
        return self._window

    def _collect(self) -> "list[_Pending] | None":
        """Block for the first request, then hold the accumulation window
        (early-out on a full max bucket), then drain the queue."""
        with self._cond:
            while True:
                # bounded wait + predicate recheck: a lost wakeup
                # re-polls within a second instead of parking the worker
                # thread forever
                while not self._queue and not self._stopped:
                    self._cond.wait(timeout=1.0)
                if self._stopped:
                    return None
                window = self._collect_window_s(sum(p.n for p in self._queue))
                deadline = time.monotonic() + window
                while self._queue:
                    rows = sum(p.n for p in self._queue)
                    left = deadline - time.monotonic()
                    if left <= 0 or rows >= MAX_BUCKET or self._stopped:
                        break
                    self._cond.wait(left)
                if not self._queue:
                    continue     # every waiter withdrew (timeouts) — re-arm
                batch = self._queue[:]
                self._queue.clear()
                self._dispatching = True
                return batch

    def _dispatch(self, batch: list[_Pending]) -> None:
        entry = self._entry
        total = sum(p.n for p in batch)
        t_start = time.monotonic()
        for p in batch:
            p.queue_wait_s = max(t_start - p.t_enq, 0.0)
        leader_ctx = next((p.ctx for p in batch if p.ctx is not None), None)
        try:
            with _tr.TRACER.adopt(leader_ctx, "score:batch", kind="serving",
                                  attrs={"model": entry.key,
                                         "requests": len(batch),
                                         "rows": total}) as bspan:
                results, device_s = self._score_slices(batch, total, bspan)
        except Exception as e:   # noqa: BLE001 — every waiter must wake
            for p in batch:
                if p.ctx is leader_ctx:
                    p.ctx = None     # adopt() released the retention already
                self._fail(p, e)
            return
        wall = time.monotonic() - t_start
        slo = getattr(entry, "slo", None)
        if slo is not None:
            slo.record_dispatch(wall, total)
        if self._replica is not None:
            self._replica.record_dispatch(
                wall, total, max(p.queue_wait_s or 0.0 for p in batch))
        _tm.SCORE_BATCH_SIZE.observe(total)
        _tm.SCORE_BATCH_REQUESTS.observe(len(batch))
        for p, res in zip(batch, results):
            p.ctx = None             # retention released by adopt()
            p.result = res
            p.batch_rows = total
            p.batch_requests = len(batch)
            p.device_s = device_s
            p.event.set()

    def _score_slices(self, batch: list[_Pending], total: int,
                      bspan) -> tuple[list[np.ndarray], float | None]:
        """Fuse the batch into bucket-padded arrays, dispatch (slicing into
        max-bucket chunks when oversized), hand each request its rows; also
        returns the dispatches' seconds on the card (None where no event
        timed them). A replica seat captures and replays on its replica's
        stream."""
        entry = self._entry
        num = np.concatenate([p.num for p in batch], axis=0) \
            if len(batch) > 1 else batch[0].num
        cat = np.concatenate([p.cat for p in batch], axis=0) \
            if len(batch) > 1 else batch[0].cat
        stream = self._replica.stream if self._replica is not None else None
        stream_cm = (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext())
        outs: list[np.ndarray] = []
        device_s: float | None = None
        start = 0
        with stream_cm:
            while start < total:
                n = min(total - start, MAX_BUCKET)
                # cache-level selection so an ops-plane pin (recompile-storm
                # remediation) takes effect at the one serving call site
                bucket = self._cache.bucket_for(n)
                pnum = np.zeros((bucket, num.shape[1]), dtype=np.float32)
                pcat = np.full((bucket, cat.shape[1]), -1, dtype=np.int32)
                pnum[:n] = num[start:start + n]
                pcat[:n] = cat[start:start + n]
                scorer = self._cache.get(entry.model, entry.schema, bucket)
                if bspan is not None:
                    with _tr.TRACER.span("score:dispatch", kind="dispatch",
                                         attrs={"bucket": bucket, "rows": n,
                                                "mode": scorer.mode}):
                        raw, dt = scorer.score_timed(pnum, pcat)
                else:
                    raw, dt = scorer.score_timed(pnum, pcat)
                if dt is not None:
                    device_s = (device_s or 0.0) + dt
                outs.append(raw[:n])
                start += n
        full = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        results, off = [], 0
        for p in batch:
            results.append(full[off:off + p.n])
            off += p.n
        return results, device_s
