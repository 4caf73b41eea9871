"""Request tracing — span trees from REST to the builders' dispatches — the
port of ``h2o3_tpu/utils/tracing.py``.

Reference: ``water/TimeLine`` + ``water/api/TimelineHandler`` snapshot
causally-ordered send/recv events cluster-wide so a slow request can be
walked back to the node and packet that stalled it. The flat event ring
(:mod:`h2o3_tpu_torch.utils.timeline`) keeps that role for aggregate history; this
module adds the **per-request causality** the ring cannot express: a GBM
build's chunks under its job under the originating REST request, as one
tree of spans.

Model:

- A **span** is ``(trace_id, span_id, parent_id, name, kind, attrs,
  start/end ns, status)``. Spans nest via a :mod:`contextvars` context so
  the active span propagates through plain function calls with no plumbing.
- A **trace** is the set of spans sharing a ``trace_id``; it is *completed*
  once every span (and every retained hand-off, see :meth:`Tracer.capture`)
  has ended, then moves into a bounded ring of the last N completed traces.
- **W3C propagation**: incoming ``traceparent`` headers join the caller's
  trace; responses carry the root span's ``traceparent`` back.

Everything here is host-side stdlib — no span reads a device value or
waits on the card, and a span begin/end is a lock-protected dict update
(~µs).
``H2O3TPU_TRACE_OFF=1`` disables root-span creation entirely (child spans
never start without an active trace, so the whole stack quiesces).
"""

from __future__ import annotations

import collections
import contextvars
import os
import re
import threading
import time
import uuid

#: completed-trace ring capacity (the TimeLine ring analog, per trace)
TRACE_RING_SIZE = int(os.environ.get("H2O3TPU_TRACE_RING", "128"))

#: open (in-flight) traces beyond this are force-finalized oldest-first —
#: a Job that never ran must not pin its trace in memory forever
MAX_OPEN_TRACES = 64

#: spans beyond this per trace are counted, not stored (an AutoML run with
#: CV folds can emit thousands of iteration spans; the tree stays bounded)
MAX_SPANS_PER_TRACE = 4096

_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: the active span's context for the current thread/task
_CURRENT: contextvars.ContextVar["SpanContext | None"] = \
    contextvars.ContextVar("h2o3_span", default=None)

#: set by utils/profiling.py while a device-profiler capture is open: every
#: span entered during the window additionally opens a
#: ``torch.profiler.record_function`` named after the span, so the Chrome
#: trace of the capture carries span-derived names. None (the default) costs one
#: is-not-None check per span — the always-on tracer budget is untouched.
SPAN_HOOK = None


def enabled() -> bool:
    return os.environ.get("H2O3TPU_TRACE_OFF", "") != "1"


def trace_partitions_enabled() -> bool:
    """Full-fidelity partition tracing: with ``H2O3TPU_TRACE_PARTITIONS=1``
    every ``map_reduce`` dispatch gathers each rank's map seconds and, in
    a trace, records a partition span a rank with the straggler's
    attributes (``ops/map_reduce.py``). Off by default: reading the map's
    end event waits for the card. Read per call, so it can be flipped at
    run time."""
    return os.environ.get("H2O3TPU_TRACE_PARTITIONS", "") == "1"


class SpanContext:
    """Immutable (trace_id, span_id) pair — what propagates."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"SpanContext({self.trace_id}, {self.span_id})"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """W3C ``traceparent`` → :class:`SpanContext` (None on absent/invalid)."""
    if not header:
        return None
    m = _TRACEPARENT.match(header.strip().lower())
    if not m or m.group(1) == "ff":
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


class Span:
    """One timed operation; mutable until :meth:`Tracer.end` seals it."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind", "attrs",
                 "start_ns", "end_ns", "status", "tid")

    def __init__(self, trace_id: str, span_id: str, parent_id: str | None,
                 name: str, kind: str, attrs: dict | None, tid: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.attrs = dict(attrs or {})
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.status = "ok"
        self.tid = tid

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attrs(self, **attrs) -> None:
        self.attrs.update(attrs)

    def set_status(self, status: str) -> None:
        self.status = status

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "kind": self.kind, "start_ns": self.start_ns,
                "end_ns": self.end_ns,
                "dur_ns": max(self.end_ns - self.start_ns, 0),
                "status": self.status, "tid": self.tid, "attrs": self.attrs}


class _SpanScope:
    """Context manager activating a span (or a no-op when tracing yields
    no span — off, or no active trace to parent under)."""

    __slots__ = ("_tracer", "_span", "_token", "_ann")

    def __init__(self, tracer: "Tracer", span: Span | None):
        self._tracer = tracer
        self._span = span
        self._token = None
        self._ann = None

    def __enter__(self) -> Span | None:
        if self._span is not None:
            self._token = _CURRENT.set(self._span.context)
            if SPAN_HOOK is not None:    # device-profiler capture open
                self._ann = SPAN_HOOK(self._span.name)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._span is not None:
            if self._ann is not None:
                try:
                    self._ann.__exit__(None, None, None)
                except Exception:   # noqa: BLE001 — annotation best-effort
                    pass
                self._ann = None
            if self._token is not None:
                _CURRENT.reset(self._token)
            if exc_type is not None and self._span.status == "ok":
                self._span.status = "error"
                self._span.attrs.setdefault(
                    "exception", f"{exc_type.__name__}: {exc}")
            self._tracer.end(self._span, self._span.status)
        return False


class _AdoptScope:
    """Context manager for a captured (retained) context: activates it in
    the adopting thread, opens a child span, releases the retention."""

    __slots__ = ("_tracer", "_ctx", "_name", "_kind", "_attrs", "_scope")

    def __init__(self, tracer: "Tracer", ctx: SpanContext | None,
                 name: str, kind: str, attrs: dict | None):
        self._tracer = tracer
        self._ctx = ctx
        self._name = name
        self._kind = kind
        self._attrs = attrs
        self._scope: _SpanScope | None = None

    def __enter__(self) -> Span | None:
        if self._ctx is None:
            return None
        span = self._tracer.begin(self._name, kind=self._kind,
                                  parent=self._ctx, attrs=self._attrs)
        self._scope = _SpanScope(self._tracer, span)
        return self._scope.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self._scope is not None:
                self._scope.__exit__(exc_type, exc, tb)
        finally:
            if self._ctx is not None:
                self._tracer.release(self._ctx)
        return False


class Tracer:
    """Thread-safe span recorder with a bounded completed-trace ring."""

    def __init__(self, capacity: int = TRACE_RING_SIZE,
                 max_open: int = MAX_OPEN_TRACES):
        self._lock = threading.Lock()
        self._max_open = max_open
        # trace_id → {"spans": [dict], "open": {span_id: Span},
        #             "pending": int, "dropped": int, "root": Span|None}
        self._active: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._done: collections.deque = collections.deque(maxlen=capacity)

    # -- span lifecycle ------------------------------------------------------

    def current(self) -> SpanContext | None:
        """The active span context in this thread/task (no retention)."""
        return _CURRENT.get()

    def begin(self, name: str, kind: str = "internal",
              parent: SpanContext | None = None, attrs: dict | None = None,
              root: bool = False, ephemeral: bool = False) -> Span | None:
        """Start a span. Without ``root``, a span only starts under an
        active trace (explicit ``parent`` or the contextvar) — library-level
        instrumentation stays silent until something opens a trace.
        ``ephemeral`` roots propagate normally (context, traceparent) but
        their finished trace is DISCARDED instead of entering the completed
        ring — for high-frequency polling/scrape endpoints whose one-span
        traces would otherwise churn out the traces worth keeping."""
        ctx = parent if parent is not None else _CURRENT.get()
        if root:
            if not enabled():
                return None
            trace_id = ctx.trace_id if ctx is not None else uuid.uuid4().hex
            parent_id = ctx.span_id if ctx is not None else None
        else:
            if ctx is None:
                return None
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        span = Span(trace_id, uuid.uuid4().hex[:16], parent_id, name, kind,
                    attrs, tid=str(threading.get_ident()))
        with self._lock:
            tr = self._active.get(trace_id)
            if tr is None:
                tr = {"spans": [], "open": {}, "pending": 0, "dropped": 0,
                      "root": None, "ephemeral": bool(root and ephemeral)}
                self._active[trace_id] = tr
                self._evict_open_locked()
            if tr["root"] is None and span.parent_id is None or root:
                tr["root"] = tr["root"] or span
            tr["open"][span.span_id] = span
        return span

    def end(self, span: Span | None, status: str | None = None) -> None:
        if span is None:
            return
        span.end_ns = time.time_ns()
        if status is not None:
            span.status = status
        with self._lock:
            tr = self._active.get(span.trace_id)
            if tr is None:
                return
            tr["open"].pop(span.span_id, None)
            if len(tr["spans"]) < MAX_SPANS_PER_TRACE:
                tr["spans"].append(span.to_dict())
            else:
                tr["dropped"] += 1
            self._maybe_finalize_locked(span.trace_id)

    def span(self, name: str, kind: str = "internal",
             attrs: dict | None = None, parent: SpanContext | None = None,
             root: bool = False, ephemeral: bool = False) -> _SpanScope:
        """``with TRACER.span("glm:fit", kind="model") as s:`` — begins,
        activates, and ends a span around the block (no-op off-trace)."""
        return _SpanScope(self, self.begin(name, kind=kind, parent=parent,
                                           attrs=attrs, root=root,
                                           ephemeral=ephemeral))

    def add_span(self, name: str, kind: str, parent: Span,
                 start_ns: int, end_ns: int, attrs: dict | None = None,
                 tid: str | None = None, status: str = "ok") -> None:
        """Record an already-timed child span (e.g. per-partition readiness
        measured after a dispatch) without touching the contextvar."""
        span = Span(parent.trace_id, uuid.uuid4().hex[:16], parent.span_id,
                    name, kind, attrs, tid=tid or str(threading.get_ident()))
        span.start_ns, span.end_ns, span.status = start_ns, end_ns, status
        with self._lock:
            tr = self._active.get(parent.trace_id)
            if tr is None:
                return
            if len(tr["spans"]) < MAX_SPANS_PER_TRACE:
                tr["spans"].append(span.to_dict())
            else:
                tr["dropped"] += 1

    # -- cross-thread hand-off ----------------------------------------------

    def capture(self) -> SpanContext | None:
        """Capture the active context for another thread, RETAINING its
        trace: the trace will not finalize until :meth:`release` (a Job's
        worker span may begin after the creating request's root span ends —
        the retention bridges that gap)."""
        ctx = _CURRENT.get()
        if ctx is None:
            return None
        with self._lock:
            tr = self._active.get(ctx.trace_id)
            if tr is None:
                return None
            tr["pending"] += 1
        return ctx

    def release(self, ctx: SpanContext | None) -> None:
        if ctx is None:
            return
        with self._lock:
            tr = self._active.get(ctx.trace_id)
            if tr is None:
                return
            tr["pending"] = max(tr["pending"] - 1, 0)
            self._maybe_finalize_locked(ctx.trace_id)

    def adopt(self, ctx: SpanContext | None, name: str, kind: str = "job",
              attrs: dict | None = None) -> _AdoptScope:
        """``with TRACER.adopt(captured_ctx, "job:GLM") as s:`` in the
        worker thread — child span under the captured context, retention
        released at exit."""
        return _AdoptScope(self, ctx, name, kind, attrs)

    def make_ephemeral(self, trace_id: str) -> None:
        """Flag an in-flight trace for discard at finalize — for requests
        that turn out to be noise only after routing (404s, auth failures:
        a scanner must not be able to churn the completed ring)."""
        with self._lock:
            tr = self._active.get(trace_id)
            if tr is not None:
                tr["ephemeral"] = True

    def annotate_root(self, trace_id: str, **attrs) -> None:
        """Roll an attribute up to an in-flight trace's ROOT span — numeric
        values max-merge so many child samples yield the trace-wide peak
        (memory attribution: every model fit under a request reports its
        device-byte peak, and the root carries the request's maximum).
        Works on a SEALED root too, as long as the trace is still open: a
        REST build's root closes when the response is sent, before the
        background Job even starts the fit — the retained trace's stored
        root record is updated in place."""
        def merge(target: dict) -> None:
            for k, v in attrs.items():
                old = target.get(k)
                if isinstance(old, (int, float)) and \
                        isinstance(v, (int, float)):
                    target[k] = max(old, v)
                else:
                    target[k] = v

        with self._lock:
            tr = self._active.get(trace_id)
            root = tr.get("root") if tr is not None else None
            if root is None:
                return                       # trace unknown or rootless
            if root.span_id in tr["open"]:
                merge(root.attrs)            # still open: seals with attrs
                return
            for rec in tr["spans"]:          # sealed: patch the stored dict
                if rec["span_id"] == root.span_id:
                    merge(rec["attrs"])
                    return

    def mark_active(self, status: str | None = None, force: bool = False,
                    **attrs) -> None:
        """Annotate the innermost active span (fault injection hooks).

        By default a status only lands on a still-"ok" span (the FIRST
        fault wins); ``force=True`` overrides — the dispatch retry layer
        uses it to flip an injected drop's "error" into "retried" once the
        re-attempt succeeds (the fault was absorbed, not fatal)."""
        ctx = _CURRENT.get()
        if ctx is None:
            return
        with self._lock:
            tr = self._active.get(ctx.trace_id)
            span = tr["open"].get(ctx.span_id) if tr else None
        if span is not None:
            if status is not None and (force or span.status == "ok"):
                span.status = status
            span.attrs.update(attrs)

    # -- store ---------------------------------------------------------------

    def _maybe_finalize_locked(self, trace_id: str) -> None:
        tr = self._active.get(trace_id)
        if tr is None or tr["open"] or tr["pending"]:
            return
        del self._active[trace_id]
        if tr.get("ephemeral"):
            return            # polling/scrape noise: never enters the ring
        self._done.append(self._summarize(trace_id, tr))

    def _evict_open_locked(self) -> None:
        while len(self._active) > self._max_open:
            # prefer victims nobody retains: evicting a pending trace would
            # let its Job's later adopt() recreate the entry and emit a
            # duplicate record for the same trace_id
            tid = next((k for k, t in self._active.items()
                        if not t["pending"]), None)
            if tid is None:
                tid = next(iter(self._active))    # all retained: oldest goes
            tr = self._active.pop(tid)
            if tr.get("ephemeral"):
                continue
            for s in tr["open"].values():
                s.end_ns = s.end_ns or time.time_ns()
                tr["spans"].append(s.to_dict())
            rec = self._summarize(tid, tr)
            rec["status"] = "truncated"
            self._done.append(rec)

    @staticmethod
    def _summarize(trace_id: str, tr: dict) -> dict:
        spans = tr["spans"]
        start = min((s["start_ns"] for s in spans), default=0)
        end = max((s["end_ns"] for s in spans), default=0)
        root = tr.get("root")
        status = "ok"
        if any(s["status"] == "error" for s in spans):
            status = "error"
        elif any(s["status"] == "delayed" for s in spans):
            status = "delayed"
        return {"trace_id": trace_id,
                "name": root.name if root is not None else
                (spans[0]["name"] if spans else ""),
                "start_ns": start, "dur_ns": max(end - start, 0),
                "nspans": len(spans), "dropped": tr["dropped"],
                "status": status, "spans": spans}

    def list_traces(self) -> list[dict]:
        """Completed-trace summaries, newest first (span lists omitted)."""
        with self._lock:
            done = list(self._done)
        return [{k: v for k, v in t.items() if k != "spans"}
                for t in reversed(done)]

    def get_trace(self, trace_id: str) -> dict:
        """Full completed trace; an in-flight trace returns its partial
        span list with ``in_progress: true``. Raises ``KeyError`` if the
        id is unknown (evicted or never seen)."""
        with self._lock:
            # newest record wins: same-traceparent callers produce several
            # completed records per trace_id; the latest is the one with
            # the substantive spans
            for t in reversed(self._done):
                if t["trace_id"] == trace_id:
                    return dict(t)
            tr = self._active.get(trace_id)
            if tr is not None:
                partial = {"spans": list(tr["spans"]),
                           "dropped": tr["dropped"], "root": tr.get("root")}
        if tr is not None:
            rec = self._summarize(trace_id, partial)
            rec["in_progress"] = True
            return rec
        raise KeyError(f"no trace {trace_id!r}")

    def clear(self) -> None:
        """Drop every trace (tests only)."""
        with self._lock:
            self._active.clear()
            self._done.clear()


TRACER = Tracer()


def run_in_context(ctx: SpanContext | None, fn, *args, **kwargs):
    """Run ``fn`` with ``ctx`` as the active span context — the hand-off
    for worker-pool threads whose submitter remains blocked (no retention
    needed; the submitting span outlives the call)."""
    if ctx is None:
        return fn(*args, **kwargs)
    token = _CURRENT.set(ctx)
    try:
        return fn(*args, **kwargs)
    finally:
        _CURRENT.reset(token)


# ---------------------------------------------------------------------------
# Trace analysis + export


def span_tree(trace: dict) -> list[dict]:
    """Nested ``{**span, "children": [...]}`` forest from a trace's flat
    span list (roots = spans whose parent is absent from the trace)."""
    spans = trace.get("spans", [])
    nodes = {s["span_id"]: {**s, "children": []} for s in spans}
    roots = []
    for s in spans:
        node = nodes[s["span_id"]]
        parent = nodes.get(s["parent_id"]) if s["parent_id"] else None
        if parent is None:
            roots.append(node)
        else:
            parent["children"].append(node)
    for n in nodes.values():
        n["children"].sort(key=lambda c: c["start_ns"])
    roots.sort(key=lambda c: c["start_ns"])
    return roots


def critical_path(trace: dict) -> list[dict]:
    """The chain of spans that determined the trace's wall time: from the
    root, repeatedly descend into the child that finished last. Each entry
    reports its span and ``self_ns`` — time not accounted to the next span
    on the path (host work between dispatches)."""
    roots = span_tree(trace)
    if not roots:
        return []
    cur = max(roots, key=lambda n: n["end_ns"])
    path = []
    while True:
        nxt = max(cur["children"], key=lambda n: n["end_ns"], default=None)
        path.append({"span_id": cur["span_id"], "name": cur["name"],
                     "kind": cur["kind"], "dur_ns": cur["dur_ns"],
                     "self_ns": max(cur["dur_ns"] - (nxt["dur_ns"] if nxt
                                                     else 0), 0)})
        if nxt is None:
            return path
        cur = nxt


def to_chrome_trace(trace: dict) -> dict:
    """Chrome trace-event JSON (``ph``/``ts``/``dur``/``pid``/``tid``) —
    loadable in Perfetto / chrome://tracing. Spans become complete ("X")
    events; per-thread (and per-partition) lanes get thread_name metadata.
    Timestamps are µs relative to the trace start."""
    spans = trace.get("spans", [])
    t0 = trace.get("start_ns") or min(
        (s["start_ns"] for s in spans), default=0)
    pid = os.getpid()
    tids = {}
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": f"h2o3_tpu trace {trace.get('trace_id')}"}}]
    for s in spans:
        lane = s.get("tid") or "0"
        if lane not in tids:
            tids[lane] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[lane],
                           "args": {"name": lane if not lane.isdigit()
                                    else f"thread-{lane}"}})
        events.append({
            "ph": "X", "name": s["name"], "cat": s["kind"],
            "ts": (s["start_ns"] - t0) / 1e3,
            "dur": max(s["dur_ns"] / 1e3, 0.001),
            "pid": pid, "tid": tids[lane],
            "args": {"span_id": s["span_id"], "parent_id": s["parent_id"],
                     "status": s["status"], **s["attrs"]}})
    return {"displayTimeUnit": "ms", "traceEvents": events}
