"""MeshScheduler — CUDA streams for concurrent model builds — the port of
``h2o3_tpu/orchestration/scheduler.py``.

The JAX package carves its device mesh into disjoint slices so that
overlapped builds never share a collective; a small build leases one
slice, a big one the whole mesh. One card has no mesh to carve. Here a
lease gives its build a CUDA stream from a pool of ``slices`` streams, so
two builds' kernels are free to run side by side on the card; on entry the
stream waits on the caller's current stream (the build sees every write
the caller enqueued before it), and on exit the caller's stream waits on
the build's (whatever the build made is complete before the caller's next
op reads it). A stream does not partition the card, so no build needs it
whole: every lease is slice-sized. With one slice, builds share its stream and are not serialised,
as the reference's one-slice layout is not.

On the CPU (``set_device("cpu")``) a lease has no stream: there is no
device queue to overlap. Left out: the ``H2O3TPU_MESH_SLICES`` and
``H2O3TPU_SLICE_ROWS_MAX`` overrides (they choose device sets that one card
does not have), the re-homing of artifacts across slices, tracing spans
and telemetry gauges. :data:`SLICE_STATS` keeps the process-wide
utilization rollup (builds, busy and queue-wait seconds per stream).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from h2o3_tpu_torch.device import resolve_device

class _SliceStats:
    """Process-wide utilization rollup: schedulers are per run, the view
    outlives them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._per: dict[str, dict] = {}

    def configure(self, n: int) -> int:
        """Note a layout of ``n`` streams; returns the largest seen."""
        with self._lock:
            self._count = max(self._count, n)
            return self._count

    def record(self, label: str, busy_s: float, wait_s: float) -> None:
        with self._lock:
            st = self._per.setdefault(label, {"builds": 0,
                                              "busy_seconds": 0.0,
                                              "queue_wait_seconds": 0.0})
            st["builds"] += 1
            st["busy_seconds"] = round(st["busy_seconds"] + busy_s, 6)
            st["queue_wait_seconds"] = round(
                st["queue_wait_seconds"] + wait_s, 6)

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self._count,
                    "slices": [{"slice": k, **v}
                               for k, v in sorted(self._per.items())]}

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._per = {}


#: the process-wide utilization view
SLICE_STATS = _SliceStats()


class _StreamPool:
    """The streams of one (device, count) layout and their free list,
    shared process-wide: two runs that ask for the same layout contend on
    one free list, so a stream is leased to one build at a time."""

    _registry: dict[tuple, "_StreamPool"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, device: torch.device, n: int):
        self.cv = threading.Condition()
        self.free = list(range(n))
        self.streams = ([torch.cuda.Stream(device=device) for _ in range(n)]
                        if device.type == "cuda" else [None] * n)

    @classmethod
    def for_layout(cls, device: torch.device, n: int) -> "_StreamPool":
        with cls._registry_lock:
            key = (str(device), n)
            pool = cls._registry.get(key)
            if pool is None:
                pool = cls._registry[key] = cls(device, n)
            return pool


class SliceLease:
    """What a build holds while it runs: its stream and its attribution."""

    __slots__ = ("stream", "index", "label", "queue_wait_s")

    def __init__(self, stream, index: int, label: str, wait_s: float):
        self.stream = stream        # torch.cuda.Stream, None on the CPU
        self.index = index          # -1: the one shared stream
        self.label = label
        self.queue_wait_s = wait_s


class MeshScheduler:
    """Leases CUDA streams to concurrent builds on the card that
    :func:`~h2o3_tpu_torch.device.resolve_device` names."""

    def __init__(self, slices: int | None = None):
        self.n = max(int(slices or 1), 1)
        self.device = resolve_device()
        self._pool = _StreamPool.for_layout(self.device, self.n)
        SLICE_STATS.configure(self.n)

    def free_count(self) -> int:
        """Streams not leased now (the one shared stream counts as free)."""
        if self.n <= 1:
            return self.n
        with self._pool.cv:
            return len(self._pool.free)

    @contextlib.contextmanager
    def _on(self, stream):
        """Run the body on ``stream``, ordered after the caller's stream
        on entry and before it on exit."""
        if stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            caller.wait_stream(stream)

    @contextlib.contextmanager
    def lease(self, rows: int | None = None, algo: str | None = None):
        """Take a stream (waiting until one is free, in bounded waits that
        re-check), run the body on it, and give it back. With one slice the
        stream is shared and the lease never waits. Every build takes one
        stream, whatever its ``rows`` and ``algo``."""
        pool = self._pool
        t0 = time.monotonic()
        if self.n <= 1:
            t1 = time.monotonic()
            try:
                with self._on(pool.streams[0]):
                    yield SliceLease(pool.streams[0], -1, "full", 0.0)
            finally:
                SLICE_STATS.record("full", time.monotonic() - t1, 0.0)
            return
        idx: int | None = None
        t1 = t0
        try:
            with pool.cv:
                while not pool.free:
                    pool.cv.wait(timeout=1.0)
                idx = pool.free.pop(0)
            t1 = time.monotonic()
            with self._on(pool.streams[idx]):
                yield SliceLease(pool.streams[idx], idx, str(idx), t1 - t0)
        finally:
            if idx is not None:
                SLICE_STATS.record(str(idx), time.monotonic() - t1, t1 - t0)
                with pool.cv:
                    pool.free.append(idx)
                    pool.cv.notify_all()
