"""map_reduce — the MRTask contract over the rank mesh — the port of
``h2o3_tpu/ops/map_reduce.py``.

Reference: ``water/MRTask.java`` — user code supplies ``map(Chunk[])``
producing per-chunk partial state and ``reduce`` merging two partials; the
runtime fans out over nodes and reduces partials up a tree over RPC. The
JAX package maps that onto ``shard_map`` + ``lax.psum``, and XLA inserts
the same collectives into any plain reduction over a sharded column. The
port has no such partitioner: every reduction over rows that a rank-aware
builder makes goes through :func:`map_reduce` (or an explicit
:func:`~h2o3_tpu_torch.parallel.distributed.all_reduce`), which maps over
this rank's row block and sums the partials with one all_reduce over the
bound mesh's group. On a mesh of one rank the all_reduce is the identity.

:func:`retrying` wraps every dispatch in a retry budget with backoff, so a
transient failure (an injected drop, a transient runtime error) is
absorbed instead of killing a build; under :func:`ejection_scope` an
exhausted budget is reported to a membership hook before it raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import random
import time
from typing import Callable

import torch


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


#: elastic-membership ejection hook: a worker running under
#: ``ejection_scope(cb)`` turns an exhausted retry budget into a membership
#: event — :func:`retrying` calls the hook with the call site's name and
#: attempt history right before raising :class:`DispatchFailed`
_EJECT_HOOK: contextvars.ContextVar = contextvars.ContextVar(
    "h2o3_torch_eject_hook", default=None)


@contextlib.contextmanager
def ejection_scope(hook: "Callable[[str, list], None]"):
    """Route retry exhaustion in this context to ``hook(fn, history)``
    (called before :class:`DispatchFailed` is raised)."""
    token = _EJECT_HOOK.set(hook)
    try:
        yield
    finally:
        _EJECT_HOOK.reset(token)


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
                hook = _EJECT_HOOK.get()
                if hook is not None:
                    # a membership event, recorded before the exception
                    # unwinds; a hook error must not mask DispatchFailed
                    try:
                        hook(what, history)
                    except Exception as he:   # noqa: BLE001
                        _tl.TIMELINE.record("elastic",
                                            f"eject_hook_error:{he}")
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


# Sampled telemetry of the dispatches: every Nth dispatch
# (H2O3TPU_DISPATCH_SAMPLE, default 16; the first always) is timed, by CUDA
# events read later without a wait (``settle``) on the card, by the host
# clock on the CPU, into ``h2o3_mapreduce_dispatch_seconds``. Every rank
# counts its dispatches alike, so the ranks sample the same dispatches.
_SAMPLE_EVERY = max(int(os.environ.get("H2O3TPU_DISPATCH_SAMPLE", "16")
                        or 16), 1)
_dispatch_seq = itertools.count()
#: (fn, start event, end event) of sampled dispatches on the card
_pending: list[tuple] = []
_MAX_PENDING = 64


def settle() -> None:
    """Observe every sampled dispatch whose end event has completed
    (``Event.query``, never a wait); the others stay pending."""
    from h2o3_tpu_torch.utils import telemetry as _tm
    done = [p for p in _pending if p[2].query()]
    for p in done:
        _pending.remove(p)
        _tm.MR_DISPATCH_SECONDS.labels(fn=p[0]).observe(
            p[1].elapsed_time(p[2]) / 1e3)


def _flatten(tree) -> tuple[list, Callable]:
    """The tensors of a partial (a tensor, or a dict / list / tuple of
    them) and a function that rebuilds it from replacements."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"map_reduce partials must be tensors, got "
                        f"{type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]

    def rebuild(new):
        out, i = [], 0
        for (_, rb), n in zip(parts, sizes):
            out.append(rb(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def reduce_partials(leaves: list, mesh) -> list:
    """Sum partial tensors over ``mesh``'s ranks: one all_reduce a dtype
    of all the leaves flattened together (usually one); the leaves
    themselves on a mesh of one rank."""
    if mesh.size == 1:
        return leaves
    from h2o3_tpu_torch.parallel.distributed import all_reduce
    out = list(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault((x.dtype, x.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        all_reduce(flat, group=mesh.group)
        at = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[at:at + n].reshape(leaves[i].shape)
            at += n
    return out


def _rank_seconds(seconds: float) -> list[float]:
    """Every rank's map seconds of one dispatch (a W-float all_gather)."""
    from h2o3_tpu_torch.parallel.distributed import all_gather_values
    return [v[0] for v in all_gather_values([seconds])]


def map_reduce(map_fn: Callable, *cols: torch.Tensor, donate: bool = False):
    """Run ``map_fn`` on this rank's row block of ``cols``; sum the
    partials over the bound mesh with one all_reduce (a dtype).

    ``map_fn(*blocks) -> tensor, or dict / list / tuple of tensors`` must
    produce partials whose elementwise sum is the global result (the
    MRTask ``reduce`` contract specialised to addition: histograms, Gram
    matrices, gradient sums, counts). Every rank of the mesh must call it,
    in the same order. ``donate`` (the reference's buffer donation) only
    turns off retries of a dispatch that may have consumed its inputs.

    Under ``H2O3TPU_TRACE_PARTITIONS=1`` (a process-wide setting, so every
    rank takes the same branch) each dispatch also gathers every rank's
    map seconds and, inside a trace, records a ``partition:<i>`` span a
    rank and the straggler's attributes on the dispatch's span; this
    waits for the map's end event, the probe's one sync."""
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    from h2o3_tpu_torch.utils import telemetry as _tm
    from h2o3_tpu_torch.utils import timeline as _tl
    from h2o3_tpu_torch.utils import tracing as _tr
    mesh = get_mesh()
    name = getattr(map_fn, "__name__", "map_reduce")
    full = _tr.trace_partitions_enabled()
    sampled = full or next(_dispatch_seq) % _SAMPLE_EVERY == 0
    dev = next((c.device for c in cols if isinstance(c, torch.Tensor)
                and c.device.type == "cuda"), None)
    dur_box = [0]
    settle()
    with _tr.TRACER.span(f"map_reduce:{name}", kind="dispatch",
                         attrs={"fn": name, "partitions": mesh.size,
                                "sampled": sampled}) as span:
        def _attempt():
            t0 = time.time_ns()
            ev = None
            if sampled and dev is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record(torch.cuda.current_stream(dev))
            leaves, rebuild = _flatten(map_fn(*cols))
            if ev is not None:
                ev[1].record(torch.cuda.current_stream(dev))
            t_map = time.time_ns()
            out = rebuild(reduce_partials(leaves, mesh))
            if not sampled:
                return out
            if ev is not None:
                ev[2].record(torch.cuda.current_stream(dev))
                _pending.append((name, ev[0], ev[2]))
                del _pending[:-_MAX_PENDING]
            else:
                dur_box[0] = time.time_ns() - t0
                _tm.MR_DISPATCH_SECONDS.labels(fn=name).observe(
                    dur_box[0] / 1e9)
            if full:
                if ev is not None:
                    ev[1].synchronize()
                    mine = ev[0].elapsed_time(ev[1]) / 1e3
                else:
                    mine = (t_map - t0) / 1e9
                secs = _rank_seconds(mine)
                if span is not None:
                    _emit_partition_spans(span, mesh, secs, t0)
            return out

        out = retrying("map_reduce", _attempt, span=span,
                       retry_runtime_errors=not donate)
    _tl.TIMELINE.record("collective", name, dur_box[0])
    _tm.MR_DISPATCHES.labels(fn=name).inc()
    _tm.MR_PARTITIONS.inc(mesh.size)
    return out


def _emit_partition_spans(span, mesh, secs: list[float], t0: int) -> None:
    """A ``partition:<i>`` child span a rank (its map seconds from the
    dispatch's start) and the straggler's attributes. Best-effort: a trace
    never breaks a dispatch."""
    try:
        from h2o3_tpu_torch.utils import tracing as _tr
        ns = [int(s * 1e9) for s in secs]
        argmax = ns.index(max(ns))
        for i, d in enumerate(ns):
            _tr.TRACER.add_span(f"partition:{i}", "partition", span,
                                start_ns=t0, end_ns=t0 + d,
                                attrs={"rank": mesh.ranks[i], "wait_ns": d},
                                tid=f"partition-{i}")
        span.set_attrs(part_dur_min_ns=min(ns), part_dur_max_ns=max(ns),
                       straggler=argmax, straggler_rank=mesh.ranks[argmax])
    except Exception:   # noqa: BLE001 — tracing is best-effort by contract
        pass


def map_cols(fn: Callable, *cols: torch.Tensor) -> torch.Tensor:
    """Elementwise or column transform of this rank's row blocks (an MRTask
    with ``NewChunk`` outputs: a map with no reduce). Rows stay where they
    are, so nothing crosses ranks."""
    return fn(*cols)


def segment_sum_cols(values: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Segment sums over the mesh's rows (the building block of group-by
    and histogram accumulation): ``values`` [rows] or [rows, k], ``ids``
    [rows] int with negative ids dropped; one ``index_add_`` on this
    rank's block, then the all_reduce."""
    def segment_sum(v, ids):
        ok = ids >= 0
        out = torch.zeros((num_segments,) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        return out.index_add_(0, ids[ok].long(), v[ok])

    return map_reduce(segment_sum, values, segment_ids)


def mesh_reduce(map_fn: Callable, *cols: torch.Tensor):
    """A model builder's reduction over the rows: ``map_fn(*cols)`` (partial sums
    of this rank's rows) through :func:`map_reduce` under a mesh of more
    than one rank, and ``map_fn(*cols)`` alone on one rank, where there is
    nothing to sum and nothing to trace."""
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    if get_mesh().size == 1:
        return map_fn(*cols)
    return map_reduce(map_fn, *cols)
