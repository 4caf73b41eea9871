"""Timeline + profiling — the port of ``h2o3_tpu/utils/timeline.py``.

Reference: ``water/TimeLine.java:12-42`` — per-node lock-free ring buffer of
the last 2048 network events (every UDP/TCP send/recv, nanotime, drop bits),
snapshotted cluster-wide via ``water/api/TimelineHandler``; sampling profiler
``water/util/ProfileCollectorTask`` + ``JStackCollectorTask`` behind
``/3/Profiler`` and ``/3/JStack``; per-process CPU/IO meters
(``WaterMeterCpuTicks``, ``WaterMeterIo``).

Mapping: the "network events" of this runtime are **the builders'
dispatches** (GBM chunks, IRLS iterations, DeepLearning epochs, model fits)
— recorded into the same fixed-size ring buffer; thread stacks come from
``sys._current_frames`` (the JStack analog); kernel-level profiles are
``torch.profiler`` captures (CUPTI's CUDA kernel events on the card); CPU/IO
meters read ``/proc``.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
import time
import traceback

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import tracing as _tracing

RING_SIZE = 2048   # reference: TimeLine.MAX_EVENTS=2048


class TimeLine:
    """Fixed-size event ring (reference: water/TimeLine ring buffer).

    Events carry a monotonic **epoch**: :meth:`clear` bumps it instead of
    swapping the buffer out, so a reader that raced a clear can never be
    served stale-index events from the previous generation — snapshot
    filters on the epoch it captured under the lock."""

    def __init__(self, size: int = RING_SIZE):
        self._size = size
        # (ns, kind, what, dur_ns, epoch)
        self._events: list[tuple] = [None] * size
        self._idx = 0
        self._epoch = 0
        self._lock = lockwitness.lock("utils.timeline.TimeLine._lock")

    def record(self, kind: str, what: str, dur_ns: int = 0) -> None:
        with self._lock:
            self._events[self._idx % self._size] = (
                time.time_ns(), kind, what, dur_ns, self._epoch)
            self._idx += 1

    def snapshot(self) -> list[dict]:
        """Events oldest→newest (reference: TimelineHandler snapshot)."""
        with self._lock:
            epoch = self._epoch
            n = min(self._idx, self._size)
            start = self._idx - n
            evs = [self._events[(start + i) % self._size] for i in range(n)]
        return [dict(ns=e[0], kind=e[1], what=e[2], dur_ns=e[3])
                for e in evs if e is not None and e[4] == epoch]

    def clear(self) -> None:
        # epoch bump retires every live event without reallocating the
        # buffer or letting a concurrent snapshot mix generations
        with self._lock:
            self._epoch += 1
            self._idx = 0


TIMELINE = TimeLine()


class timed_event:
    """Context manager recording a timed event into the global timeline.

    ``observe`` optionally takes a telemetry histogram child (anything
    with an ``observe(seconds)`` method) so convergence-loop call sites
    feed the ``h2o3_iteration_seconds`` histogram and the timeline ring
    from one wrapper. The same wrapper also opens a child **span** under
    the active trace (:mod:`h2o3_tpu_torch.utils.tracing`) — IRLS iterations,
    DL epochs, and GBM chunks become span-tree nodes with zero extra
    instrumentation at the call sites (and zero cost when no trace is
    active: the span hook is a contextvar read returning None)."""

    def __init__(self, kind: str, what: str, observe=None):
        self.kind, self.what = kind, what
        self._observe = observe
        self._mem0 = None

    def __enter__(self):
        self._scope = _tracing.TRACER.span(self.what, kind=self.kind)
        self._span = self._scope.__enter__()
        if self.kind == "model":
            # device-byte attribution at build granularity (two full samples
            # per fit — never per iteration, where the live-array fallback
            # walk would cost); also advances the host/device watermarks
            from h2o3_tpu_torch.utils.memory import MEMORY
            try:
                self._mem0 = MEMORY.sample()
            except Exception:   # noqa: BLE001 — metering must never break a fit
                self._mem0 = None
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.time_ns() - self._t0
        TIMELINE.record(self.kind, self.what, dur_ns)
        if self._observe is not None:
            self._observe.observe(dur_ns / 1e9)
        if self._mem0 is not None:
            from h2o3_tpu_torch.utils.memory import MEMORY
            try:
                rss1, dev1 = MEMORY.sample()
                peak = max(self._mem0[1], dev1)
                if self._span is not None:
                    # the fit span carries its own peak/delta; the trace
                    # ROOT max-merges the peak so "which build ate HBM" is
                    # one attr lookup on the root (docs/OBSERVABILITY.md)
                    self._span.set_attrs(
                        peak_device_bytes=peak,
                        device_bytes_delta=dev1 - self._mem0[1],
                        host_rss_bytes=rss1)
                    _tracing.TRACER.annotate_root(
                        self._span.trace_id, peak_device_bytes=peak)
            except Exception:   # noqa: BLE001
                pass
        self._scope.__exit__(*exc)
        return False


def jstack(exclude: "set[int] | None" = None) -> list[dict]:
    """All Python thread stacks (reference: JStackCollectorTask → /3/JStack).

    ``exclude`` drops the given thread idents — the sampling profiler passes
    its own ident so profiles show real work, not the sampler itself
    (reference: ProfileCollectorTask skips the collector thread)."""
    frames = sys._current_frames()
    out = []
    for th in threading.enumerate():
        if exclude and th.ident in exclude:
            continue
        fr = frames.get(th.ident)
        stack = traceback.format_stack(fr) if fr is not None else []
        out.append(dict(name=th.name, daemon=th.daemon, alive=th.is_alive(),
                        stack="".join(stack)))
    return out


def cpu_ticks() -> dict:
    """Per-CPU tick counters (reference: WaterMeterCpuTicks reads /proc/stat)."""
    out = {}
    try:
        with open("/proc/stat") as f:
            for line in f:
                if line.startswith("cpu"):
                    parts = line.split()
                    out[parts[0]] = [int(v) for v in parts[1:8]]
    except OSError:
        pass
    return out


def io_stats() -> dict:
    """Process IO counters (reference: WaterMeterIo reads /proc/self/io)."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                out[k.strip()] = int(v)
    except OSError:
        pass
    return out


#: elastic-worker identity for fault scoping: the elastic group's worker
#: threads run their round work under :func:`worker_scope`, and the injector
#: consults it so a chaos scenario can make EXACTLY ONE worker straggle or
#: die (``FaultInjector(worker_rates={1: {...}})``) while its peers run clean
_WORKER_ID: contextvars.ContextVar["int | str | None"] = \
    contextvars.ContextVar("h2o3_fault_worker_id", default=None)


def current_worker_id() -> "int | str | None":
    """The elastic worker id bound to this context, or None outside one."""
    return _WORKER_ID.get()


@contextlib.contextmanager
def worker_scope(worker_id: "int | str"):
    """Bind an elastic worker id to this thread/task for fault scoping and
    membership attribution (parallel/elastic.py worker threads)."""
    token = _WORKER_ID.set(worker_id)
    try:
        yield
    finally:
        _WORKER_ID.reset(token)


class FaultInjector:
    """Random fault injection for the communication substrate (reference:
    the ``-random_udp_drop`` flag ``water/H2O.java:446`` drops UDP packets to
    exercise the RPC retry path; here faults hit dispatch call sites
    (the builders' chunk and iteration dispatches, the REST accept loop) — a random
    delay models a straggler shard, a raised ``FaultInjected`` models a lost
    reduction (absorbed by the dispatch retry loop,
    :func:`h2o3_tpu_torch.ops.map_reduce.retrying`),
    a ``stall`` is a BOUNDED hold on a gate that :meth:`release_stalls` (or
    the bound) releases — a hung worker, as distinct from ``delay``'s fixed
    sleep — and a ``crash`` is process-fatal (``os._exit``) so auto-recovery
    resume paths can be exercised end to end.

    ``site_rates`` overrides rates per call site::

        FaultInjector(site_rates={"gbm_chunk": {"drop_rate": 1.0,
                                                "after": 1}})

    ``after`` skips the first N calls at that site — deterministic
    "fail the second chunk" scenarios for checkpoint-resume tests.

    ``worker_rates`` scopes overrides to ONE elastic worker (keyed by the
    :func:`worker_scope` id the elastic group binds around its round work)::

        FaultInjector(worker_rates={1: {"stall_rate": 1.0,
                                        "stall_ms": 30_000, "after": 2}})

    Worker overrides take precedence over site overrides, which take
    precedence over the global rates; the per-worker ``after``/
    ``crash_after`` thresholds count that worker's own faultable calls.

    Thread-safe: chaos runs under ``windowed_parallel`` hit this from
    concurrent dispatch threads, so the RNG draw and the fault counters
    mutate under one lock (unlocked, concurrent ``random.Random`` calls can
    return duplicate draws and drop increments)."""

    def __init__(self, drop_rate: float = 0.0, delay_ms: float = 0.0,
                 delay_rate: float = 0.0, seed: int = 17,
                 crash_rate: float = 0.0, crash_after: int = 0,
                 stall_ms: float = 0.0, stall_rate: float = 0.0,
                 site_rates: "dict[str, dict] | None" = None,
                 worker_rates: "dict | None" = None):
        import random
        self.drop_rate = drop_rate
        self.delay_ms = delay_ms
        self.delay_rate = delay_rate
        self.crash_rate = crash_rate
        self.stall_ms = stall_ms
        self.stall_rate = stall_rate
        # crash on the Nth faultable call overall (0 = disabled) — the
        # deterministic kill for resume tests
        self.crash_after = int(crash_after)
        self.site_rates = dict(site_rates or {})
        self.worker_rates = dict(worker_rates or {})
        self._rng = random.Random(seed)
        self._lock = lockwitness.lock("utils.timeline.FaultInjector._lock")
        # stall gate: held stalls block on this event up to their bound;
        # release_stalls() wakes every held worker early (bounded hold that
        # RELEASES — a stall can never wedge a test past its bound)
        self._stall_gate = threading.Event()
        self._calls = 0
        self._site_calls: dict[str, int] = {}
        self._worker_calls: dict = {}
        self.dropped = 0
        self.delayed = 0
        self.crashed = 0
        self.stalled = 0

    def _site(self, what: str, key: str, default):
        # precedence: worker override > site override > global rate. A
        # worker block only overrides the keys it names — scoping a fault
        # to one worker means giving ONLY that worker a nonzero rate (the
        # globals stay 0, so its peers run clean).
        wid = current_worker_id()
        if wid is not None and wid in self.worker_rates:
            w = self.worker_rates[wid]
            if key in w:
                return w[key]
        return self.site_rates.get(what, {}).get(key, default)

    def release_stalls(self) -> None:
        """Release every held ``stall`` fault immediately (tests/teardown)."""
        self._stall_gate.set()

    def maybe_fault(self, what: str) -> None:
        # injected faults surface as metrics too, so fault-injection runs are
        # observable through /metrics alongside the timeline events; the
        # active span (if a trace is open) is marked so fault-injection runs
        # are visible in trace trees
        from h2o3_tpu_torch.utils.telemetry import FAULTS_INJECTED
        wid = current_worker_id()
        with self._lock:
            self._calls += 1
            calls = self._calls
            site_calls = self._site_calls[what] = \
                self._site_calls.get(what, 0) + 1
            # a worker-scoped `after`/`crash_after` counts THAT worker's own
            # faultable calls, not the site's (its peers advance the site
            # counter too, which would make "fail my 2nd call" racy)
            armed_calls = site_calls
            if wid is not None and wid in self.worker_rates:
                armed_calls = self._worker_calls[wid] = \
                    self._worker_calls.get(wid, 0) + 1
            armed = armed_calls > int(self._site(what, "after", 0))
            drop_rate = self._site(what, "drop_rate", self.drop_rate)
            delay_rate = self._site(what, "delay_rate", self.delay_rate)
            delay_ms = self._site(what, "delay_ms", self.delay_ms)
            crash_rate = self._site(what, "crash_rate", self.crash_rate)
            stall_rate = self._site(what, "stall_rate", self.stall_rate)
            stall_ms = self._site(what, "stall_ms", self.stall_ms)
            # deterministic kills: Nth faultable call overall (crash_after)
            # or Nth call at THIS site (site_rates[what]["crash_after"])
            site_crash_after = int(self._site(what, "crash_after", 0))
            r = self._rng.random()
            r2 = self._rng.random()
            crash = (
                bool(self.crash_after and calls >= self.crash_after)
                or bool(site_crash_after
                        and armed_calls >= site_crash_after)
                or (armed and crash_rate > 0 and r < crash_rate))
            drop = (not crash) and armed and drop_rate > 0 and r < drop_rate
            stall = (not crash and not drop) and armed \
                and stall_rate > 0 and r < stall_rate
            delay = (not crash and not drop and not stall) and armed \
                and delay_rate > 0 and r2 < delay_rate
            if crash:
                self.crashed += 1
            elif drop:
                self.dropped += 1
            elif stall:
                self.stalled += 1
        if crash:
            # process-fatal (reference: a kill -9 mid-build, the scenario
            # hex/faulttolerance/Recovery.java exists for). Recorded first so
            # an inherited log/timeline snapshot shows the cause of death;
            # os._exit skips atexit — nothing may "clean up" a crash test.
            TIMELINE.record("fault", f"crash:{what}")
            FAULTS_INJECTED.labels(kind="crash").inc()
            import os as _os
            _os._exit(86)
        if drop:
            TIMELINE.record("fault", f"drop:{what}")
            FAULTS_INJECTED.labels(kind="drop").inc()
            _tracing.TRACER.mark_active(status="error",
                                        fault=f"drop:{what}")
            raise FaultInjected(what)
        if stall:
            # bounded hold: the caller hangs on the gate until
            # release_stalls() fires or the bound elapses — a hung worker
            # the elastic membership layer must eject, not a fixed sleep
            # (the gate makes the hold interruptible; the bound makes it
            # impossible to wedge a run forever)
            t0 = time.time_ns()
            self._stall_gate.wait(timeout=stall_ms / 1000.0)
            dur_ns = time.time_ns() - t0
            TIMELINE.record("fault", f"stall:{what}", dur_ns)
            FAULTS_INJECTED.labels(kind="stall").inc()
            _tracing.TRACER.mark_active(status="stalled",
                                        fault=f"stall:{what}",
                                        stall_ns=dur_ns)
            return
        if delay:
            t0 = time.time_ns()
            time.sleep(delay_ms / 1000.0)
            dur_ns = time.time_ns() - t0
            with self._lock:
                self.delayed += 1
            # the event carries the TRUE injected stall, not 0 — delay
            # faults are stragglers and must read as such in the timeline
            TIMELINE.record("fault", f"delay:{what}", dur_ns)
            FAULTS_INJECTED.labels(kind="delay").inc()
            _tracing.TRACER.mark_active(status="delayed",
                                        fault=f"delay:{what}",
                                        delay_ns=dur_ns)


class FaultInjected(RuntimeError):
    pass


FAULTS: FaultInjector | None = None


class inject_faults:
    """Context manager enabling fault injection (tests only)."""

    def __init__(self, **kw):
        self.injector = FaultInjector(**kw)

    def __enter__(self):
        global FAULTS
        FAULTS = self.injector
        return self.injector

    def __exit__(self, *exc):
        global FAULTS
        FAULTS = None
        # unstick any worker still held on the stall gate — a finished
        # chaos scenario must never leave a thread parked on its injector
        self.injector.release_stalls()
        return False


#: the open ``torch.profiler.profile`` of :func:`start_profiler` and the
#: directory its trace goes to
_PROFILE: "tuple | None" = None


def start_profiler(log_dir: str) -> None:
    """Start a kernel-level trace (reference analog: /3/Profiler): a
    ``torch.profiler`` session over the CPU and, on a card, CUDA activity;
    :func:`stop_profiler` writes its Chrome trace under ``log_dir``."""
    global _PROFILE
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _PROFILE = (prof, log_dir)


def stop_profiler() -> str | None:
    """Stop the :func:`start_profiler` session; returns the path of its
    Chrome trace (``trace.json`` under the session's ``log_dir``)."""
    global _PROFILE
    import os
    if _PROFILE is None:
        return None
    (prof, log_dir), _PROFILE = _PROFILE, None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def device_memory_profile() -> bytes:
    """The caching allocator's state as a pickle of
    ``torch.cuda.memory._snapshot()`` (segments, blocks and, when history
    recording is on, the allocation stacks) — the port's counterpart of
    the reference's pprof device-memory profile. Raises without a card."""
    import pickle

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device")
    return pickle.dumps(torch.cuda.memory._snapshot())
