"""On-demand device profiler — bounded ``torch.profiler`` captures — the
port of ``h2o3_tpu/utils/profiling.py``.

The span tracer (``utils/tracing.py``) answers *which request/iteration was
slow*; this module answers *what the card and the host were doing while it
was slow*: ``POST /3/Profiler/capture`` opens a
``torch.profiler.profile(activities=[CPU, CUDA])`` around a bounded window
and keeps the resulting Chrome trace (gzip JSON, loadable in Perfetto) for
listing and download.

While a capture is open, every span the tracer starts additionally enters a
``torch.profiler.record_function`` named after the span (via
``tracing.SPAN_HOOK``), so the capture carries the SAME names the span tree
uses — host spans and the CUDA kernels they launched line up in one view.

On a card a capture must hold CUDA kernel events (CUPTI's ``kernel``
category): a capture without any is an error (:class:`CaptureEmpty`), not
an empty file. One capture at a time: the profiler is process-global
state, so a second concurrent ``capture()`` raises :class:`CaptureBusy`
(the REST layer maps it to a structured 409). Artifacts live under
``H2O3TPU_PROFILE_DIR`` (default: a per-process dir under the system
tempdir) and the registry keeps the last :data:`MAX_CAPTURES` — older
artifact directories are deleted.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import tempfile
import threading
import time
import uuid

#: captures are bounded: 10 ms .. 30 s
MIN_CAPTURE_MS = 10
MAX_CAPTURE_MS = 30_000

MAX_CAPTURES = 8

ARTIFACT = "trace.json.gz"


class CaptureBusy(RuntimeError):
    """A capture is already open — the profiler is process-global, so
    concurrent captures would interleave into one corrupt artifact."""


class CaptureEmpty(RuntimeError):
    """A capture on the card recorded no CUDA kernel event (CUPTI traced
    nothing): the artifact would show host time only."""


def _base_dir() -> str:
    d = os.environ.get("H2O3TPU_PROFILE_DIR", "").strip()
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         f"h2o3_tpu_torch_profiles_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


def _all_threads():
    """The profiler's config to record every thread's ``record_function``
    ranges (a build traced through REST runs on its job's thread, not on
    the thread that opens the capture); None where this torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def kernel_events(trace: dict) -> list[dict]:
    """The CUDA kernel events (``cat == "kernel"``) of a Chrome trace."""
    return [e for e in trace.get("traceEvents", ())
            if e.get("cat") == "kernel"]


class DeviceProfiler:
    """Single-flight ``torch.profiler`` capture manager."""

    def __init__(self):
        self._busy = threading.Lock()
        self._reg_lock = threading.Lock()
        self._captures: list[dict] = []

    def capture(self, duration_ms: int = 500, exercise: bool = True) -> dict:
        """Open a profiler session for ``duration_ms`` (clamped to
        [10 ms, 30 s]), annotate spans for the window, and register the
        artifact. ``exercise`` runs one tiny product under a
        ``profiler:exercise`` span so an otherwise-idle server still yields
        a non-empty, annotation-carrying capture. Raises
        :class:`CaptureBusy` when a capture is already open,
        :class:`CaptureEmpty` when a capture on a card holds no kernel."""
        duration_ms = max(MIN_CAPTURE_MS, min(int(duration_ms),
                                              MAX_CAPTURE_MS))
        if not self._busy.acquire(blocking=False):
            raise CaptureBusy(
                "a profiler capture is already in progress (the profiler "
                "is process-global; retry when it completes)")
        try:
            import torch

            from h2o3_tpu_torch.utils import tracing as _tr
            on_card = torch.cuda.is_available()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            cap_id = f"cap_{uuid.uuid4().hex[:12]}"
            out_dir = os.path.join(_base_dir(), cap_id)
            os.makedirs(out_dir, exist_ok=True)
            t0 = time.time()
            prof = torch.profiler.profile(activities=acts,
                                          experimental_config=_all_threads())
            prof.__enter__()
            _tr.SPAN_HOOK = _annotation_hook
            try:
                deadline = time.perf_counter() + duration_ms / 1e3
                if exercise:
                    self._exercise(on_card)
                while time.perf_counter() < deadline:
                    time.sleep(min(0.01, max(
                        deadline - time.perf_counter(), 0.0)))
            finally:
                _tr.SPAN_HOOK = None
                prof.__exit__(None, None, None)
            return self._register(cap_id, out_dir, prof, duration_ms, t0,
                                  on_card)
        finally:
            self._busy.release()

    @staticmethod
    def _exercise(on_card: bool) -> None:
        """One tiny product under a span, so the capture provably carries
        span-derived annotations even on an idle server (on a card the
        product's kernel is in the window too)."""
        import torch

        from h2o3_tpu_torch.utils import tracing as _tr
        with _tr.TRACER.span("profiler:exercise", kind="profile", root=True,
                             ephemeral=True):
            x = torch.ones((128, 128), dtype=torch.float32,
                           device="cuda" if on_card else "cpu")
            (x @ x).sum()

    def _register(self, cap_id: str, out_dir: str, prof, duration_ms: int,
                  t0: float, on_card: bool) -> dict:
        raw = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as f:
            body = f.read()
        os.remove(raw)
        trace = json.loads(body)
        kernels = kernel_events(trace)
        if on_card and not kernels:
            shutil.rmtree(out_dir, ignore_errors=True)
            raise CaptureEmpty(
                f"capture {cap_id} recorded no CUDA kernel event (CUPTI "
                "traced no device activity)")
        artifact = os.path.join(out_dir, ARTIFACT)
        with gzip.open(artifact, "wb") as f:
            f.write(body)
        rec = {"capture_id": cap_id, "duration_ms": duration_ms,
               "started_at_ms": int(t0 * 1000), "artifact": ARTIFACT,
               "bytes": os.path.getsize(artifact), "path": artifact}
        with self._reg_lock:
            self._captures.append(rec)
            while len(self._captures) > MAX_CAPTURES:
                old = self._captures.pop(0)
                shutil.rmtree(os.path.join(_base_dir(), old["capture_id"]),
                              ignore_errors=True)
        return {k: v for k, v in rec.items() if k != "path"}

    def list_captures(self) -> list[dict]:
        with self._reg_lock:
            return [{k: v for k, v in rec.items() if k != "path"}
                    for rec in self._captures]

    def artifact_bytes(self, capture_id: str) -> tuple[bytes, str]:
        """(gzip bytes, filename) of a capture's Chrome trace artifact.
        Raises ``KeyError`` for unknown/evicted ids."""
        with self._reg_lock:
            rec = next((r for r in self._captures
                        if r["capture_id"] == capture_id), None)
        if rec is None or not rec.get("path"):
            raise KeyError(f"no profiler capture {capture_id!r} "
                           "(the registry keeps the last "
                           f"{MAX_CAPTURES})")
        with open(rec["path"], "rb") as f:
            return f.read(), rec["artifact"]

    def clear(self) -> None:
        """Tests only: drop the registry and its artifact dirs."""
        with self._reg_lock:
            for rec in self._captures:
                shutil.rmtree(os.path.join(_base_dir(), rec["capture_id"]),
                              ignore_errors=True)
            self._captures.clear()


def _annotation_hook(name: str):
    """``tracing.SPAN_HOOK`` payload: enter a
    ``torch.profiler.record_function`` carrying the span's name. Returns
    the live context manager, or None on a profiler problem — tracing must
    never break on one."""
    try:
        import torch
        ann = torch.profiler.record_function(name)
        ann.__enter__()
        return ann
    except Exception:   # noqa: BLE001 — annotation is best-effort
        return None


PROFILER = DeviceProfiler()
