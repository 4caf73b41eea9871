"""The dispatch retry budget — the host-side part of
``h2o3_tpu/ops/map_reduce.py`` that one card needs.

The JAX package's ``map_reduce`` runs the MRTask contract over a device
mesh, and its :func:`retrying` wraps every dispatch in a retry budget with
backoff, so a transient failure (an injected drop, a transient runtime
error) is absorbed instead of killing a build. The port's builders
dispatch whole chunks of work to one card; :func:`retrying` wraps those
(the GBM's chunk of rounds) and the REST accept loop's fault point.
``map_reduce``'s collectives and its elastic ejection hook come with the
multi-GPU slice.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable


class DispatchFailed(RuntimeError):
    """A dispatch kept failing after its retry budget was exhausted.

    ``fn`` names the call site; ``history`` is the per-attempt record
    (error + backoff) that Job surfaces to pollers."""

    def __init__(self, fn: str, history: "list[dict]"):
        self.fn = fn
        self.history = history
        last = history[-1]["error"] if history else "unknown"
        super().__init__(f"dispatch {fn!r} failed after {len(history)} "
                         f"attempt(s); last error: {last}")


def retry_budget() -> int:
    """Retry attempts after the first try (``H2O3TPU_DISPATCH_RETRIES``,
    default 3; 0 disables the retry machinery — failures pass through
    unchanged)."""
    try:
        return max(int(os.environ.get("H2O3TPU_DISPATCH_RETRIES", "") or 3),
                   0)
    except ValueError:
        return 3


def _backoff_ms(attempt: int) -> float:
    """Exponential backoff with jitter: base * 2^attempt * U(0.5, 1.5)
    (``H2O3TPU_DISPATCH_BACKOFF_MS``, default 25)."""
    try:
        base = float(os.environ.get("H2O3TPU_DISPATCH_BACKOFF_MS", "")
                     or 25.0)
    except ValueError:
        base = 25.0
    return base * (2 ** attempt) * (0.5 + random.random())


#: status words that mark a RuntimeError DETERMINISTIC, not transient:
#: re-dispatching an out-of-memory or an invalid launch burns device time
#: on a failure that cannot change
_NON_TRANSIENT = ("out of memory", "RESOURCE_EXHAUSTED", "INVALID_ARGUMENT",
                  "invalid argument", "FAILED_PRECONDITION", "UNIMPLEMENTED")


def retrying(what: str, thunk: Callable, *, span=None,
             retry_runtime_errors: bool = True):
    """Run ``thunk`` under the dispatch retry budget.

    Fault injection (``FAULTS.maybe_fault(what)``) fires before every
    attempt, so chaos drops exercise this exact path. ``FaultInjected`` is
    always retryable (it is raised before the dispatch); ``RuntimeError``
    from the dispatch itself is retried only when ``retry_runtime_errors``
    and its message names no deterministic failure. Each retry increments
    ``h2o3_dispatch_retries_total{fn,outcome="retried"}`` and notes itself
    on the active Job; exhaustion increments ``outcome="exhausted"`` and
    raises :class:`DispatchFailed` with the attempt history."""
    from h2o3_tpu_torch.models.job import note_dispatch_retry
    from h2o3_tpu_torch.utils import telemetry as _tm
    from h2o3_tpu_torch.utils import timeline as _tl
    from h2o3_tpu_torch.utils import tracing as _trc
    budget = retry_budget()
    history: list[dict] = []
    attempt = 0
    while True:
        try:
            if _tl.FAULTS is not None:
                _tl.FAULTS.maybe_fault(what)
            out = thunk()
        except (_tl.FaultInjected, RuntimeError) as e:
            if isinstance(e, DispatchFailed):
                raise          # a nested dispatch already exhausted its budget
            if budget == 0:
                raise          # retries disabled: pure pass-through
            if not isinstance(e, _tl.FaultInjected) and (
                    not retry_runtime_errors
                    or any(tag in str(e) for tag in _NON_TRANSIENT)):
                raise          # deterministic failure: surface immediately
            history.append({"attempt": attempt,
                            "error": f"{type(e).__name__}: {e}"})
            if attempt >= budget:
                _tm.DISPATCH_RETRIES.labels(fn=what,
                                            outcome="exhausted").inc()
                if span is not None:
                    span.set_attrs(retries=attempt)
                raise DispatchFailed(what, history) from e
            delay = _backoff_ms(attempt)
            history[-1]["backoff_ms"] = round(delay, 1)
            _tm.DISPATCH_RETRIES.labels(fn=what, outcome="retried").inc()
            note_dispatch_retry()
            time.sleep(delay / 1000.0)
            attempt += 1
            continue
        if attempt:
            # absorbed faults still read in trace trees: the span carries
            # how many retries the dispatch cost and a "retried" status
            # (overriding the error mark the injected drop left); builder
            # call sites mark their ACTIVE span (the chunk's)
            if span is not None:
                span.set_attrs(retries=attempt)
                span.set_status("retried")
            else:
                _trc.TRACER.mark_active(status="retried", force=True,
                                        retries=attempt)
        return out
