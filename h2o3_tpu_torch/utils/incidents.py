"""Structured incidents — rule trips with correlated context, in a ring.

The port of ``h2o3_tpu/utils/incidents.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: H2O-3 operators diagnose a sick cloud from ``h2o logs download``
— one archive whose value is that every signal was captured *at the same
moment*. This module gives rule trips (:mod:`h2o3_tpu_torch.utils.health`) the
same property live: when a health rule crosses its threshold, an
**incident** opens and auto-captures the correlated context *at trip
time* — the recent trace ids, the last-N log-ring lines, the memory
top-keys, the compute-table loop rows, and the tripping rule's recent
observed-value window — so the operator reads what the system looked like
when it happened, not whatever is left when a human shows up.

Semantics:

- **One open incident per rule.** A rule that keeps tripping sweep after
  sweep updates its open incident (``repeats`` + latest observed) instead
  of flooding the ring; when the rule stops tripping the incident resolves
  (``status: resolved``, ``resolved_ms``/``resolved_at`` stamped; an
  incident the remediation engine acted on names its ``action_id``).
- **Rising edges notify.** A listener registered with
  :meth:`IncidentLog.add_listener` fires once per incident OPEN (never on
  repeats) — the subscription seam the ops-plane remediation engine
  (:mod:`h2o3_tpu_torch.ops_plane.remediate`) hangs off. Listeners run outside
  the ring lock and are fault-isolated.
- **Bounded.** The ring keeps the most recent ``H2O3TPU_INCIDENT_RING``
  records (default 64), oldest evicted first; ``h2o3_incidents_total
  {rule,subsystem}`` counts every OPEN over the process lifetime.
- **Compute-class trips can profile themselves.** With
  ``H2O3TPU_INCIDENT_PROFILE=1``, a compute-subsystem incident fires one
  single-flight device-profiler capture in the background (a
  concurrent capture is skipped, never queued — the profiler runtime is
  process-global) and stamps the ``capture_id`` into the incident context.

Everything here is host-side stdlib; capture helpers are individually
fault-isolated — a broken registry can never turn an incident into a
crash of the sweep thread that reported it.
"""

from __future__ import annotations

import os
import threading
import time
import uuid

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

#: every incident OPEN, by rule and subsystem (repeats do not re-count)
INCIDENTS_TOTAL = _tm.METRICS.counter(
    "h2o3_incidents", "health-rule incidents opened", ("rule", "subsystem"))

#: log-ring lines / trace summaries captured into an incident's context
CAPTURE_LOG_LINES = 30
CAPTURE_TRACES = 8


def ring_size_from_env(default: int = 64) -> int:
    try:
        return max(int(os.environ.get("H2O3TPU_INCIDENT_RING", "")
                       or default), 4)
    except ValueError:
        return default


def profile_on_incident() -> bool:
    """Opt-in: compute-class incidents fire a single-flight profiler
    capture (``H2O3TPU_INCIDENT_PROFILE=1``). Off by default — a capture
    costs a bounded ``torch.profiler`` window, which an operator
    should choose, not inherit."""
    return os.environ.get("H2O3TPU_INCIDENT_PROFILE", "") == "1"


# -- context capture (each helper fault-isolated) ----------------------------

def _capture_traces() -> list:
    from h2o3_tpu_torch.utils.tracing import TRACER
    return [{"trace_id": t["trace_id"], "name": t["name"],
             "dur_ms": round(t.get("dur_ns", 0) / 1e6, 3),
             "status": t.get("status")}
            for t in TRACER.list_traces()[:CAPTURE_TRACES]]


def _capture_logs() -> list:
    ring = _tm.install_log_ring()
    return ring.lines()[-CAPTURE_LOG_LINES:]


def _capture_memory() -> dict:
    from h2o3_tpu_torch.utils.memory import MEMORY
    return {"top_keys": MEMORY.top_keys(5),
            "watermarks": MEMORY.watermarks}


def _capture_compute() -> dict:
    from h2o3_tpu_torch.utils.costs import COSTS
    snap = COSTS.snapshot()
    return {"loops": snap["loops"],
            "recompile_events": snap["recompile_events"],
            "signature_count": snap["signature_count"]}


def _capture_flight_window(rule: str,
                           source_series: "str | None") -> "dict | None":
    """The ±window of the tripping series from the flight recorder: the
    rule's declared source series (trend rules) when it holds samples,
    else the rule's own recorded observed series (``health.rule.<rule>``).
    None — cleanly, never a crash — when the recorder is off
    (``H2O3TPU_FLIGHT_OFF=1``), not yet started, or holds no samples for
    either name: the point-sample ``series`` fallback stands alone."""
    from h2o3_tpu_torch.utils.flight import FLIGHT
    win = None
    if source_series:
        win = FLIGHT.window(source_series)
    if win is None:
        win = FLIGHT.window(f"health.rule.{rule}")
    return win


def capture_context(rule: str, subsystem: str,
                    series: "list | None" = None,
                    source_series: "str | None" = None) -> dict:
    """The correlated context stamped into a new incident: what the
    observability pillars showed AT TRIP TIME. Every capture is
    individually fault-isolated (a failed one records its error string).
    ``flight_window`` carries the ±window of the tripping series from the
    flight recorder when one holds samples; incidents opened before the
    recorder starts (or with ``H2O3TPU_FLIGHT_OFF=1``) degrade to the
    point-sample ``series`` list — ``flight_window`` is then None."""
    ctx: dict = {"series": list(series or [])}
    for name, fn in (("traces", _capture_traces), ("logs", _capture_logs),
                     ("memory", _capture_memory),
                     ("compute", _capture_compute)):
        try:
            ctx[name] = fn()
        except Exception as e:   # noqa: BLE001 — capture must never raise
            ctx[name] = {"error": f"{type(e).__name__}: {e}"}
    try:
        ctx["flight_window"] = _capture_flight_window(rule, source_series)
    except Exception as e:   # noqa: BLE001 — capture must never raise
        ctx["flight_window"] = {"error": f"{type(e).__name__}: {e}"}
    return ctx


class IncidentLog:
    """Bounded ring of incident records, one open incident per rule
    (``GET /3/Incidents`` / ``GET /3/Incidents/{id}``)."""

    def __init__(self, capacity: int | None = None):
        self._lock = lockwitness.lock("utils.incidents.IncidentLog._lock")
        self._capacity = capacity if capacity is not None \
            else ring_size_from_env()
        self._ring: "dict[str, dict]" = {}          # id -> record
        self._order: list[str] = []                 # oldest first
        self._open_by_rule: dict[str, str] = {}     # rule -> incident id
        self._opened_total = 0
        self._listeners: list = []                  # rising-edge subscribers

    # -- subscriptions -------------------------------------------------------

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(record_snapshot, log)`` to incident OPENs (rising
        edges only — repeat trips fold into the open record silently).
        Listeners run on the opener's thread, outside the ring lock, after
        the trip-time context is stamped; a raising listener is swallowed
        (remediation must never crash the health sweep)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- lifecycle -----------------------------------------------------------

    def open(self, rule: str, subsystem: str, severity: str, message: str,
             observed, threshold, series=None,
             source_series: "str | None" = None) -> str:
        """Open (or update) the incident for ``rule``. Returns its id.
        A rule with an incident already open updates it in place —
        ``repeats`` increments, ``observed``/``last_seen_ms`` refresh —
        so a storm of identical trips is one record, not a flood."""
        now_ms = int(time.time() * 1000)
        with self._lock:
            open_id = self._open_by_rule.get(rule)
            if open_id is not None and open_id in self._ring:
                rec = self._ring[open_id]
                rec["repeats"] += 1
                rec["observed"] = observed
                # message/threshold track the LATEST trip too — a record
                # showing observed=50 with a message still claiming the
                # original "observed 3" reads as contradictory numbers
                rec["message"] = message
                rec["threshold"] = threshold
                rec["last_seen_ms"] = now_ms
                return open_id
            iid = f"inc_{uuid.uuid4().hex[:10]}"
            rec = {"id": iid, "rule": rule, "subsystem": subsystem,
                   "severity": severity, "status": "open",
                   "message": message, "observed": observed,
                   "threshold": threshold, "repeats": 1,
                   "opened_ms": now_ms, "last_seen_ms": now_ms,
                   "resolved_ms": None, "resolved_at": None,
                   "action_id": None, "context": None}
            self._ring[iid] = rec
            self._order.append(iid)
            self._open_by_rule[rule] = iid
            self._opened_total += 1
            while len(self._order) > self._capacity:
                # evict the oldest RESOLVED record first: evicting a
                # still-open incident would make its next trip mint a new
                # id and re-count h2o3_incidents_total mid-episode —
                # breaking the one-open-per-rule / repeats-fold-in
                # contract. Only a ring made ENTIRELY of open incidents
                # (more simultaneously-open rules than capacity) falls
                # back to evicting the oldest open one.
                old = next((i for i in self._order
                            if self._ring[i]["status"] != "open"),
                           self._order[0])
                self._order.remove(old)
                dead = self._ring.pop(old, None)
                if dead is not None and \
                        self._open_by_rule.get(dead["rule"]) == old:
                    del self._open_by_rule[dead["rule"]]
        INCIDENTS_TOTAL.labels(rule=rule, subsystem=subsystem).inc()
        # context capture OUTSIDE the lock: the helpers read other
        # registries (their own locks) — holding ours across them invites
        # ordering trouble for zero benefit
        ctx = capture_context(rule, subsystem, series,
                              source_series=source_series)
        with self._lock:
            if iid in self._ring:
                self._ring[iid]["context"] = ctx
            snapshot = dict(self._ring.get(iid) or rec)
            listeners = list(self._listeners)
        # rising-edge notification AFTER context capture, so a remediation
        # listener reads the same trip-time picture an operator would;
        # each listener fault-isolated — acting must never break reporting
        for fn in listeners:
            try:
                fn(snapshot, self)
            except Exception:   # noqa: BLE001 — subscriber bug stays local
                pass
        if subsystem == "compute" and profile_on_incident():
            self._fire_profile(iid)
        return iid

    def resolve(self, rule: str) -> None:
        """The rule stopped tripping: close its open incident (no-op when
        none is open — resolution is edge-triggered by the evaluator)."""
        with self._lock:
            iid = self._open_by_rule.pop(rule, None)
            rec = self._ring.get(iid) if iid else None
            if rec is not None:
                now = time.time()
                rec["status"] = "resolved"
                rec["resolved_ms"] = int(now * 1000)
                rec["resolved_at"] = time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(now))

    def annotate_action(self, incident_id: str, action_id: str) -> None:
        """Stamp the remediation ``action_id`` onto its trigger incident —
        a resolved-by-action incident names what touched it (satellite:
        the /3/Incidents record answers "did the machine do this?")."""
        with self._lock:
            rec = self._ring.get(incident_id)
            if rec is not None:
                rec["action_id"] = action_id
                if isinstance(rec.get("context"), dict):
                    rec["context"]["remediation_action"] = action_id

    def _fire_profile(self, incident_id: str) -> None:
        """Single-flight background profiler capture for a compute-class
        incident; a concurrent capture (409-class CaptureBusy) is skipped,
        and the capture id lands in the incident context when done."""
        def run():
            try:
                from h2o3_tpu_torch.utils.profiling import PROFILER, CaptureBusy
                try:
                    rec = PROFILER.capture(duration_ms=200)
                except CaptureBusy:
                    return
            except Exception:   # noqa: BLE001 — best-effort enrichment
                return
            with self._lock:
                inc = self._ring.get(incident_id)
                if inc is not None and isinstance(inc.get("context"), dict):
                    inc["context"]["profiler_capture"] = rec.get("capture_id")

        threading.Thread(target=run, daemon=True,
                         name="h2o3-incident-profile").start()

    # -- views ---------------------------------------------------------------

    def list(self, state: str | None = None) -> list[dict]:
        """Summaries, newest first (context omitted — fetch one by id).
        ``state`` filters to ``"open"`` or ``"resolved"`` records."""
        if state not in (None, "open", "resolved"):
            raise ValueError(f"state must be open|resolved, got {state!r}")
        with self._lock:
            out = []
            for iid in reversed(self._order):
                rec = self._ring[iid]
                if state is not None and rec["status"] != state:
                    continue
                out.append({k: rec.get(k) for k in
                            ("id", "rule", "subsystem", "severity", "status",
                             "message", "observed", "threshold", "repeats",
                             "opened_ms", "last_seen_ms", "resolved_ms",
                             "resolved_at", "action_id")})
            return out

    def get(self, incident_id: str) -> dict:
        with self._lock:
            rec = self._ring.get(incident_id)
            if rec is None:
                raise KeyError(f"no incident {incident_id!r} (ring keeps "
                               f"the last {self._capacity})")
            return {**rec, "context": dict(rec["context"] or {})}

    def export(self) -> list[dict]:
        """Full records (context included), newest first — the bundle's
        ``incidents.json``."""
        with self._lock:
            return [dict(self._ring[iid]) for iid in reversed(self._order)]

    def opened_total(self) -> int:
        """Monotonic count of incidents OPENED this process — the bench
        hollow-watchdog guard windows on its delta."""
        with self._lock:
            return self._opened_total

    def open_rules(self) -> list[str]:
        with self._lock:
            return sorted(self._open_by_rule)

    def reset(self) -> None:
        """Drop everything (tests/bench isolation only)."""
        with self._lock:
            self._ring.clear()
            self._order.clear()
            self._open_by_rule.clear()
            self._opened_total = 0


#: the process-wide incident ring (``GET /3/Incidents``)
INCIDENTS = IncidentLog()
