"""SLO-adaptive batching controller + priority-based admission shedding —
the port of ``h2o3_tpu/serving/slo.py`` (host code, the algorithm copied
exactly: the ring, the narrow/widen/headroom rules, admission by
``(1 + p)`` budgets; with no target it is the fixed window, bit for bit).

Latency-SLO-driven adaptive batching windows and priority-based request
shedding under overload: a plain micro-batcher runs one fixed
accumulation window (``H2O3TPU_SCORE_WINDOW_MS``) whatever
the load. This module replaces that constant with a per-model feedback
loop over a sliding latency ring, and turns hopeless requests away AT
ADMISSION instead of letting them burn their whole timeout inside the
batcher queue.

Controller algorithm (docs/SERVING.md "SLO & replicas"):

- The target is ``H2O3TPU_SCORE_SLO_MS`` (or a per-model override passed
  with the request — ``slo_ms`` on ``POST /3/Score``). **No target means
  no controller**: :meth:`SLOController.window_s` returns the fixed base
  window and :meth:`SLOController.admit` never sheds, so the tier degrades
  bit-identically to the fixed-window path (pinned by test).
- Every completed request's end-to-end latency lands in a bounded ring;
  each batch collection reads the ring's p99 against the target:

  * ``p99 >= 0.9 x SLO`` — the window itself is now latency the budget
    cannot afford: **narrow hard** (x0.5).
  * queue depth grew past the last dispatch — demand outruns dispatch
    rate: **widen** (x1.25, capped at ``SLO/4``) so each dispatch
    amortizes over more rows.
  * ``p99 <= 0.5 x SLO`` — headroom: **narrow gently** (x0.9) back toward
    interactive latency; the floor is 1/16 of the base window.

- Shedding: the admission estimator multiplies the EMA dispatch wall by
  the dispatches queued ahead (queue depth over the max bucket) and
  compares it to the remaining SLO budget. A priority-``p`` request
  (0..9, default 5) is shed once the estimate exceeds ``(1 + p)`` SLO
  budgets — low-priority work is turned away first and earliest, with
  ``503 + Retry-After`` sized from the estimate, and the drop is
  accounted (``ScoringService.stats()["shed"]``) instead of surfacing
  as an in-queue timeout minutes later.

A non-finite latency is dropped, counted in ``LatencyRing.rejected`` and
in the telemetry registry's ``h2o3_telemetry_rejected_total``
(``where="latency_ring"``).
"""

from __future__ import annotations

import math
import os

from h2o3_tpu_torch.utils import lockwitness

#: priority scale: 0 (shed first) .. 9 (effectively never shed)
MIN_PRIORITY, MAX_PRIORITY, DEFAULT_PRIORITY = 0, 9, 5

#: latency samples the sliding ring keeps per model
RING_SIZE = 256


def window_s_from_env() -> float:
    """The base accumulation window, resolved AT CALL TIME (a
    module-level read would freeze the env at import and silently ignore
    monkeypatch.setenv / late exports)."""
    try:
        return float(os.environ.get("H2O3TPU_SCORE_WINDOW_MS", "1.0")) / 1e3
    except ValueError:
        return 1e-3


def slo_ms_from_env() -> float | None:
    """Process-default latency target (``H2O3TPU_SCORE_SLO_MS``); None =
    no SLO = the fixed-window behavior."""
    raw = os.environ.get("H2O3TPU_SCORE_SLO_MS", "").strip()
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        return None
    return ms if ms > 0 else None


def clamp_priority(priority) -> int:
    if priority is None:
        return DEFAULT_PRIORITY
    try:
        return max(MIN_PRIORITY, min(MAX_PRIORITY, int(priority)))
    except (TypeError, ValueError):
        return DEFAULT_PRIORITY


class Shed(RuntimeError):
    """Admission refused by the SLO estimator: the queue ahead cannot be
    served inside this priority's budget. Maps to ``503 + Retry-After``
    at the REST layer — early, cheap, and accounted — instead of a
    timeout burned inside the batcher."""

    def __init__(self, msg: str, priority: int, reason: str = "overload",
                 retry_after_ms: int = 1000):
        super().__init__(msg)
        self.priority = priority
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class LatencyRing:
    """Bounded ring of recent end-to-end request latencies (seconds) with
    percentile reads — the controller's feedback signal."""

    __slots__ = ("_buf", "_size", "_next", "_count", "_lock", "rejected")

    def __init__(self, size: int = RING_SIZE):
        self._size = max(int(size), 8)
        self._buf: list[float] = [0.0] * self._size
        self._next = 0
        self._count = 0
        self._lock = lockwitness.lock("serving.slo.LatencyRing._lock")
        self.rejected = 0

    def record(self, latency_s: float) -> None:
        v = float(latency_s)
        if not math.isfinite(v) or v < 0.0:
            # a NaN in the buffer poisons every percentile read (sorted()
            # with NaN is partial order — the controller would steer the
            # window off garbage); drop and account instead
            with self._lock:
                self.rejected += 1
            from h2o3_tpu_torch.utils.telemetry import METRICS
            METRICS.reject("latency_ring")
            return
        with self._lock:
            self._buf[self._next] = v
            self._next = (self._next + 1) % self._size
            self._count += 1

    def percentile(self, p: float) -> float | None:
        """p in [0, 100]; None until at least 8 samples landed (a cold
        ring must not steer the window)."""
        with self._lock:
            n = min(self._count, self._size)
            if n < 8:
                return None
            vals = sorted(self._buf[:n])
        k = min(n - 1, max(0, int(math.ceil(p / 100.0 * n)) - 1))
        return vals[k]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class SLOController:
    """Per-model feedback loop: latency ring -> collect window, plus the
    shedding admission estimator. Shared by every replica seat of one
    model so the ring sees the model's whole traffic."""

    def __init__(self, base_window_s: float | None = None,
                 slo_ms: float | None = None, max_bucket: int | None = None):
        if base_window_s is None:
            base_window_s = window_s_from_env()
        if slo_ms is None:
            slo_ms = slo_ms_from_env()
        if max_bucket is None:
            from h2o3_tpu_torch.serving.scorer import MAX_BUCKET
            max_bucket = MAX_BUCKET
        self.base_window_s = float(base_window_s)
        self.max_bucket = int(max_bucket)
        self._lock = lockwitness.lock("serving.slo.SLOController._lock")
        self._slo_ms = float(slo_ms) if slo_ms else None
        self._window = self.base_window_s
        self._ring = LatencyRing()
        self._ema_dispatch_s: float | None = None
        self._last_queue_rows = 0
        self.shed_count = 0
        self.widened = 0
        self.narrowed = 0

    # -- target --------------------------------------------------------------

    @property
    def slo_ms(self) -> float | None:
        with self._lock:
            return self._slo_ms

    @property
    def active(self) -> bool:
        """True when a target is set — False IS the fixed window."""
        return self.slo_ms is not None

    def set_target(self, slo_ms: float | None) -> None:
        """Per-model override at admit (request ``slo_ms`` beats the env
        default; ``None`` leaves the current target untouched)."""
        if slo_ms is None:
            return
        with self._lock:
            ms = float(slo_ms)
            self._slo_ms = ms if ms > 0 else None
            if self._slo_ms is None:
                self._window = self.base_window_s

    # -- feedback inputs -----------------------------------------------------

    def record_latency(self, latency_s: float) -> None:
        """End-to-end request latency (score() entry -> reply built)."""
        self._ring.record(latency_s)

    def record_dispatch(self, wall_s: float, rows: int) -> None:
        """One batch dispatch's device wall: feeds the shedding
        estimator's EMA (alpha 0.3 — a few batches of history, quick to
        follow a compile or a load shift)."""
        with self._lock:
            if self._ema_dispatch_s is None:
                self._ema_dispatch_s = float(wall_s)
            else:
                self._ema_dispatch_s += 0.3 * (wall_s - self._ema_dispatch_s)
            self._last_queue_rows = int(rows)

    @property
    def ema_dispatch_s(self) -> float | None:
        with self._lock:
            return self._ema_dispatch_s

    # -- the control law -----------------------------------------------------

    def window_s(self, queued_rows: int = 0) -> float:
        """The collect window for the batch being formed. Without a
        target this IS ``base_window_s``, every time — the fixed-window
        degrade the bit-identity test pins."""
        with self._lock:
            if self._slo_ms is None:
                return self.base_window_s
            slo_s = self._slo_ms / 1e3
            w = self._window
            p99 = self._ring.percentile(99)
            if p99 is not None:
                if p99 >= 0.9 * slo_s:
                    w *= 0.5
                    self.narrowed += 1
                elif queued_rows > self._last_queue_rows:
                    w *= 1.25
                    self.widened += 1
                elif p99 <= 0.5 * slo_s:
                    w *= 0.9
                    self.narrowed += 1
            w = max(self.base_window_s / 16.0, min(w, slo_s / 4.0))
            self._window = w
            return w

    def current_window_s(self) -> float:
        with self._lock:
            return self._window if self._slo_ms is not None \
                else self.base_window_s

    # -- shedding admission estimator ----------------------------------------

    def admit(self, priority: int, queued_rows: int, n_rows: int) -> None:
        """Raise :class:`Shed` when the estimated queue service time
        exceeds ``(1 + priority)`` SLO budgets. No target = no shedding."""
        with self._lock:
            if self._slo_ms is None or self._ema_dispatch_s is None:
                return      # cold tier (or no SLO): nothing to estimate yet
            slo_s = self._slo_ms / 1e3
            # dispatches queued ahead of this request's batch, plus its own
            ahead = math.ceil((queued_rows + n_rows) / self.max_bucket)
            est_s = self._ema_dispatch_s * max(ahead, 1) + self._window
            budget_s = slo_s * (1 + priority)
            if est_s <= budget_s:
                return
            self.shed_count += 1
            slo_ms = self._slo_ms
            retry_ms = max(100, int(math.ceil((est_s - slo_s) * 1e3)))
        raise Shed(
            f"estimated queue service time {est_s * 1e3:.1f}ms exceeds "
            f"priority-{priority} budget {budget_s * 1e3:.1f}ms "
            f"(SLO {slo_ms:.0f}ms); shed early, retry shortly",
            priority=priority, reason="overload", retry_after_ms=retry_ms)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """The per-model ``slo`` block inside ``GET /3/Score``."""
        p50 = self._ring.percentile(50)
        p99 = self._ring.percentile(99)
        with self._lock:
            return {
                "target_ms": self._slo_ms,
                "mode": "adaptive" if self._slo_ms is not None else "fixed",
                "window_ms": round((self._window if self._slo_ms is not None
                                    else self.base_window_s) * 1e3, 4),
                "base_window_ms": round(self.base_window_s * 1e3, 4),
                "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
                "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
                "samples": self._ring.count,
                "ema_dispatch_ms": (round(self._ema_dispatch_s * 1e3, 3)
                                    if self._ema_dispatch_s is not None
                                    else None),
                "widened": self.widened, "narrowed": self.narrowed,
                "shed": self.shed_count,
            }
