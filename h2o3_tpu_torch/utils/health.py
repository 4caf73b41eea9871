"""Cluster self-watching — declarative health rules over the live registries.

The port of ``h2o3_tpu/utils/health.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: H2O-3's cloud is self-monitoring — nodes gossip heartbeats into
a consensus view, ``GET /3/Cloud`` answers "is this cloud healthy and why
not" (``cloud_healthy`` / ``bad_nodes``), and ``h2o logs download`` ships
the whole diagnostic state in one call. This module is the evaluation
layer our four observability pillars (metrics, traces, memory,
compute) were missing: a **declarative rule set** swept by a
bounded-interval background thread over the live registries —

- heartbeat-lease gaps and SUSPECT dwell from the elastic membership view
  (the reference's ``parallel/elastic.py``; empty until multi-GPU), plus ejection deltas;
- shed-rate and p99-vs-SLO from the serving tier (``serving/service.py``);
- spill/fault-in thrash (``utils/cleaner.py``) and leak-detector growth
  flags (``utils/memory.py``);
- recompile storms and MFU collapse from the compute observatory
  (``utils/costs.py``);
- dispatch-retry exhaustion streaks from the reliability metrics.

Each sweep folds rule results into a subsystem-scored verdict
(``healthy`` / ``degraded`` / ``unhealthy`` per subsystem) served by
``GET /3/Health``; every finding names the tripping **rule**, the
**observed** value, and the **threshold** — never a bare boolean. Rule
trips open structured incidents (:mod:`h2o3_tpu_torch.utils.incidents`) that
auto-capture correlated context at trip time, and
:func:`diagnostic_bundle` is the ``h2o logs download`` analog: one call
tars a gzip archive of every pillar's snapshot plus incidents, logs,
hardware fingerprint, and a secrets-redacted config dump
(``POST /3/Diagnostics/bundle``).

Thresholds are env-tunable per rule (``H2O3TPU_HEALTH_*``, see
docs/OBSERVABILITY.md "Health & incidents"); ``H2O3TPU_HEALTH_OFF=1``
disables the evaluator entirely (the bench's overhead comparator).
Everything is host-side stdlib; a probe that raises is reported and
skipped, never fatal to the sweep.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import tarfile
import threading
import time

from h2o3_tpu_torch.utils import flight as _fl
from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils.incidents import INCIDENTS

_LOG = logging.getLogger("h2o3_tpu_torch")

#: wall seconds per health evaluation (thread sweeps and inline calls) —
#: the observe-the-observers instrument: a sweep dragging toward its own
#: interval is a probe reading a sick registry (docs/OBSERVABILITY.md)
HEALTH_SWEEP_SECONDS = _tm.METRICS.histogram(
    "h2o3_health_sweep_seconds",
    "wall seconds per health-evaluator sweep")

HEALTHY, DEGRADED, UNHEALTHY = "healthy", "degraded", "unhealthy"
_RANK = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2}

SUBSYSTEMS = ("elastic", "serving", "memory", "compute", "dispatch")

#: observed-value window retained per rule (the incident "metric series")
SERIES_LEN = 32


def health_off() -> bool:
    return os.environ.get("H2O3TPU_HEALTH_OFF", "") == "1"


def interval_from_env(default: float = 5.0) -> float:
    """Sweep interval seconds (``H2O3TPU_HEALTH_INTERVAL_SECS``) — the
    bound on how stale a served verdict can be with the thread running."""
    try:
        return max(float(os.environ.get("H2O3TPU_HEALTH_INTERVAL_SECS", "")
                         or default), 0.05)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _metric_total(family, **match) -> float:
    """Sum a metric family's child values over label-matching children —
    the window-delta inputs (retry exhaustions, elastic ejections, score
    requests) read the counters the subsystems already publish."""
    total = 0.0
    for labels, child in family.children():
        if all(labels.get(k) == v for k, v in match.items()):
            total += child.value
    return total


# -- registry providers (module-level seams: tests monkeypatch these) --------

def _elastic_rows() -> list:
    """Membership rows of LIVE elastic groups. Elastic local-SGD comes with
    the multi-GPU slice, so the port has no live group: the rows are empty,
    as the reference's are with no live elastic group."""
    return []


def lease_secs_from_env(default: float = 30.0) -> float:
    """Heartbeat lease: a worker silent longer than this is considered
    dead, not slow (``H2O3TPU_ELASTIC_LEASE_SECS``, the reference's
    ``parallel/elastic.py`` knob)."""
    try:
        return float(os.environ.get("H2O3TPU_ELASTIC_LEASE_SECS", "")
                     or default)
    except ValueError:
        return default


def _serving_stats() -> "dict | None":
    """The scoring tier's stats — only when serving is actually loaded
    (the sweep thread must not be the thing that imports the stack)."""
    import sys
    svc = sys.modules.get("h2o3_tpu_torch.serving.service")
    return svc.SCORING.stats() if svc is not None else None


def _cleaner_stats() -> dict:
    from h2o3_tpu_torch.utils.cleaner import CLEANER
    return CLEANER.stats()


def _leak_growth_flags() -> list:
    """Keys the leak detector flags as GROWING (bytes strictly rising
    across sweeps). Idle-only flags are expected from back-to-back sweeps
    and annotate, not page — same policy as the bench memory gate."""
    from h2o3_tpu_torch.utils.memory import MEMORY
    return [f for f in MEMORY.leak_report()["flagged"]
            if "growing" in f.get("reasons", ())]


def _recompile_total() -> float:
    from h2o3_tpu_torch.utils.costs import COSTS
    return float(COSTS.recompile_count())


def _compute_loops() -> dict:
    from h2o3_tpu_torch.utils.costs import COSTS
    return COSTS.loops()


def _exhausted_total() -> float:
    return _metric_total(_tm.DISPATCH_RETRIES, outcome="exhausted")


def _ejections_total() -> float:
    return _metric_total(_tm.ELASTIC_EJECTIONS)


def _score_requests_total() -> float:
    return _metric_total(_tm.SCORE_REQUESTS)


# -- rules -------------------------------------------------------------------

class Rule:
    """One declarative health rule: a probe over the live registries, a
    threshold (env-overridable), and a severity. ``direction`` is the trip
    comparison: ``above`` pages when observed > threshold, ``below`` when
    observed < threshold (MFU collapse). A probe returning None means
    not-applicable this sweep (no data — never a trip)."""

    def __init__(self, name: str, subsystem: str, severity: str,
                 probe, *, env: str, default, direction: str = "above",
                 unit: str = "", description: str = "",
                 source_series: "str | None" = None):
        self.name = name
        self.subsystem = subsystem
        self.severity = severity
        self.probe = probe
        self.env = env
        self.default = default
        self.direction = direction
        self.unit = unit
        self.description = description
        #: the flight-recorder series this rule trends over (trend rules);
        #: the incident context captures its ±window instead of only the
        #: rule's own point samples
        self.source_series = source_series

    def threshold(self) -> float:
        dflt = self.default() if callable(self.default) else self.default
        return _env_float(self.env, float(dflt))

    def tripped(self, observed, threshold: float) -> bool:
        if observed is None:
            return False
        return (observed > threshold if self.direction == "above"
                else observed < threshold)


# probe implementations take the evaluator (for window deltas / streaks)

def _probe_heartbeat_gap(ev: "HealthEvaluator"):
    gaps = [r["last_heartbeat_ago_ms"] / 1e3 for r in _elastic_rows()
            if r.get("state") in ("ACTIVE", "SUSPECT", "JOINING")]
    return round(max(gaps), 3) if gaps else None


def _probe_suspect_dwell(ev: "HealthEvaluator"):
    suspects = sum(1 for r in _elastic_rows() if r.get("state") == "SUSPECT")
    return float(ev._streak("elastic_suspect", suspects > 0))


def _probe_ejections(ev: "HealthEvaluator"):
    return ev._delta("elastic_ejections", _ejections_total())


def _probe_shed_rate(ev: "HealthEvaluator"):
    stats = _serving_stats()
    if stats is None:
        return None
    shed = ev._delta("score_shed", float(stats.get("shed_total") or 0))
    total = ev._delta("score_requests", _score_requests_total())
    if shed <= 0 and total <= 0:
        return None          # no traffic this window — nothing to rate
    # every shed ALSO lands in the request counter (service.score counts
    # the ServiceUnavailable as status=error on its way out), so the
    # all-status request delta already IS the full admission count —
    # dividing by shed+total would double-count sheds and saturate the
    # rate at 0.5. A shed recorded astride a window edge can still leave
    # shed > total; clamp so the rate stays in [0, 1].
    total = max(total, shed)
    return round(shed / total, 4)


def _probe_p99_vs_slo(ev: "HealthEvaluator"):
    stats = _serving_stats()
    if stats is None:
        return None
    ratios = []
    for row in stats.get("resident") or ():
        slo = row.get("slo") or {}
        target, p99 = slo.get("target_ms"), slo.get("p99_ms")
        if target and p99 is not None:
            ratios.append(p99 / target)
    return round(max(ratios), 4) if ratios else None


def _probe_spill_thrash(ev: "HealthEvaluator"):
    st = _cleaner_stats()
    spills = ev._delta("spills", float(st.get("spill_count") or 0))
    restores = ev._delta("restores", float(st.get("restore_count") or 0))
    return min(spills, restores)


def _probe_leak_growth(ev: "HealthEvaluator"):
    return float(len(_leak_growth_flags()))


def _probe_recompile_storm(ev: "HealthEvaluator"):
    return ev._delta("recompiles", _recompile_total())


def _probe_mfu_collapse(ev: "HealthEvaluator"):
    utils = [st.get("utilization") for st in _compute_loops().values()
             if st.get("utilization") is not None
             and st.get("samples", 0) >= 3]
    return round(min(utils), 6) if utils else None


def _probe_retry_exhaustion(ev: "HealthEvaluator"):
    delta = ev._delta("dispatch_exhausted", _exhausted_total())
    return float(ev._streak("dispatch_exhausted", delta > 0))


# -- trend probes (sustained-slope detectors over the flight recorder) -------
#
# Point rules answer "is it bad NOW"; trend rules answer "is it HEADING
# bad" — a slow leak, a creeping p99, an MFU slide. Each reads a retained
# series from the flight recorder (utils/flight.py) and compares the tail
# of the window against its head, so a single noisy sample never pages.
# With the recorder off (H2O3TPU_FLIGHT_OFF=1), not started, or not yet
# holding a full window, every probe returns None (not-applicable) — the
# clean-degrade contract incidents rely on.

def trend_window() -> int:
    """Raw samples a trend probe needs before it speaks
    (``H2O3TPU_FLIGHT_TREND_SAMPLES``, default 12, min 4)."""
    try:
        return max(int(os.environ.get("H2O3TPU_FLIGHT_TREND_SAMPLES", "")
                       or 12), 4)
    except ValueError:
        return 12


def _trend_vals(name: str) -> "list | None":
    """The last trend-window values of a flight series, or None when the
    window isn't full yet (an under-filled window must not fabricate a
    slope from two samples)."""
    n = trend_window()
    vals = _fl.FLIGHT.values(name, last_n=n)
    return vals if len(vals) >= n else None


def _edge_means(vals: list) -> "tuple[float, float]":
    """(head_mean, tail_mean) over the window's first and last quartiles
    — a noise-damped two-point slope."""
    q = max(len(vals) // 4, 1)
    head = sum(vals[:q]) / q
    tail = sum(vals[-q:]) / q
    return head, tail


def _probe_trend_rss(ev: "HealthEvaluator"):
    """Relative RSS growth across the trend window (0.05 = +5%)."""
    vals = _trend_vals("derived.host_rss_bytes")
    if vals is None:
        return None
    head, tail = _edge_means(vals)
    if head <= 0 or tail <= head:
        return 0.0
    return round((tail - head) / head, 4)


def _probe_trend_p99(ev: "HealthEvaluator"):
    """p99/SLO-ratio rise across the window — only while the tail is
    already near the SLO (a creep from 0.1 to 0.2 is headroom, not
    danger)."""
    vals = _trend_vals("derived.p99_slo_ratio")
    if vals is None:
        return None
    head, tail = _edge_means(vals)
    if tail < 0.8 or tail <= head:
        return 0.0
    return round(tail - head, 4)


def _probe_trend_mfu(ev: "HealthEvaluator"):
    """MFU lost across the window (positive = declining utilization)."""
    vals = _trend_vals("derived.mfu_min")
    if vals is None:
        return None
    head, tail = _edge_means(vals)
    return round(max(head - tail, 0.0), 6)


def _probe_trend_shed(ev: "HealthEvaluator"):
    """Shed-rate acceleration: sheds in the window's second half minus
    sheds in its first (the cumulative counter's second difference) — a
    steady overload pages the point rule; this one pages when shedding
    is getting WORSE."""
    vals = _trend_vals("derived.score_shed_total")
    if vals is None:
        return None
    mid = len(vals) // 2
    first = vals[mid] - vals[0]
    second = vals[-1] - vals[mid]
    return round(max(second - first, 0.0), 4)


def default_rules() -> list[Rule]:
    """The rule catalog (docs/OBSERVABILITY.md "Health & incidents" is the
    operator-facing table; keep both in step)."""
    return [
        Rule("elastic_heartbeat_gap", "elastic", UNHEALTHY,
             _probe_heartbeat_gap,
             env="H2O3TPU_HEALTH_HEARTBEAT_GAP_SECS",
             default=lease_secs_from_env, unit="s",
             description="max heartbeat silence of a live elastic worker "
                         "exceeds the lease — a worker is dead or wedged"),
        Rule("elastic_suspect_dwell", "elastic", DEGRADED,
             _probe_suspect_dwell,
             env="H2O3TPU_HEALTH_SUSPECT_SWEEPS", default=1, unit="sweeps",
             description="SUSPECT workers present for consecutive sweeps — "
                         "a straggler is dwelling instead of recovering"),
        Rule("elastic_ejections", "elastic", DEGRADED,
             _probe_ejections,
             env="H2O3TPU_HEALTH_EJECTIONS", default=0, unit="ejections",
             description="workers ejected from elastic groups this window "
                         "(membership decayed; training throughput lost)"),
        Rule("serving_shed_rate", "serving", DEGRADED,
             _probe_shed_rate,
             env="H2O3TPU_HEALTH_SHED_RATE", default=0.05, unit="fraction",
             description="fraction of scoring admissions shed with 503 "
                         "this window — the tier is overloaded"),
        Rule("serving_p99_slo", "serving", UNHEALTHY,
             _probe_p99_vs_slo,
             env="H2O3TPU_HEALTH_P99_RATIO", default=1.0, unit="ratio",
             description="a resident model's p99 latency exceeds its SLO "
                         "target (ratio of p99 to target)"),
        Rule("memory_spill_thrash", "memory", DEGRADED,
             _probe_spill_thrash,
             env="H2O3TPU_HEALTH_THRASH_CYCLES", default=2, unit="cycles",
             description="spill/fault-in cycles this window — the working "
                         "set no longer fits the Cleaner budget"),
        Rule("memory_leak_growth", "memory", DEGRADED,
             _probe_leak_growth,
             env="H2O3TPU_HEALTH_LEAK_KEYS", default=0, unit="keys",
             description="DKV keys the leak detector flags as GROWING "
                         "across sweeps"),
        Rule("compute_recompile_storm", "compute", DEGRADED,
             _probe_recompile_storm,
             env="H2O3TPU_HEALTH_RECOMPILES", default=2, unit="recompiles",
             description="recompile events this window — signatures are "
                         "churning (shape/dtype instability)"),
        Rule("compute_mfu_collapse", "compute", DEGRADED,
             _probe_mfu_collapse, direction="below",
             env="H2O3TPU_HEALTH_MFU_FLOOR", default=0.02, unit="MFU",
             description="a rated loop's utilization fell below the floor "
                         "(only on backends in the peak table)"),
        Rule("dispatch_retry_exhaustion", "dispatch", UNHEALTHY,
             _probe_retry_exhaustion,
             env="H2O3TPU_HEALTH_EXHAUSTION_SWEEPS", default=0,
             unit="sweeps",
             description="consecutive sweeps with dispatch-retry budgets "
                         "exhausted — dispatches are failing through their "
                         "whole retry budget"),
        # trend rules: sustained-slope detectors over the flight recorder
        # (not-applicable — never a trip — while the recorder is off or
        # its window unfilled; docs/OBSERVABILITY.md "Flight recorder")
        Rule("trend_rss_growth", "memory", DEGRADED,
             _probe_trend_rss,
             env="H2O3TPU_HEALTH_TREND_RSS_GROWTH", default=0.05,
             unit="fraction", source_series="derived.host_rss_bytes",
             description="host RSS grew steadily across the trend window "
                         "— a slow leak the point rules cannot see"),
        Rule("trend_p99_creep", "serving", DEGRADED,
             _probe_trend_p99,
             env="H2O3TPU_HEALTH_TREND_P99_CREEP", default=0.1,
             unit="ratio", source_series="derived.p99_slo_ratio",
             description="a resident model's p99/SLO ratio is rising while "
                         "already near the target — creeping toward an SLO "
                         "breach"),
        Rule("trend_mfu_decline", "compute", DEGRADED,
             _probe_trend_mfu,
             env="H2O3TPU_HEALTH_TREND_MFU_DECLINE", default=0.05,
             unit="MFU", source_series="derived.mfu_min",
             description="a rated loop's utilization slid across the trend "
                         "window — throughput is decaying, not collapsed"),
        Rule("trend_shed_accel", "serving", DEGRADED,
             _probe_trend_shed,
             env="H2O3TPU_HEALTH_TREND_SHED_ACCEL", default=5,
             unit="sheds", source_series="derived.score_shed_total",
             description="scoring sheds accelerated window-over-window — "
                         "overload is compounding, not steady"),
    ]


# -- the evaluator -----------------------------------------------------------

class HealthEvaluator:
    """Background health sweep: a bounded-interval thread running the rule
    set over the live registries, folding results into the subsystem
    verdict ``GET /3/Health`` serves and opening/resolving incidents on
    rule edges. Usable inline too — :meth:`evaluate` is what the REST
    handler calls when no thread is running."""

    def __init__(self, interval_s: float | None = None,
                 rules: list[Rule] | None = None,
                 incidents=None):
        self._interval_explicit = interval_s is not None
        self.interval_s = (interval_s if interval_s is not None
                           else interval_from_env())
        self.rules = list(rules) if rules is not None else default_rules()
        self.incidents = incidents if incidents is not None else INCIDENTS
        # verdict + lifecycle state
        self._lock = lockwitness.lock("utils.health.HealthEvaluator._lock")
        # one evaluation at a time
        self._eval_lock = lockwitness.lock(
            "utils.health.HealthEvaluator._eval_lock")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last: dict | None = None
        self._prev: dict[str, float] = {}     # window-delta baselines
        self._streaks: dict[str, int] = {}
        self._series: dict[str, list] = {}
        self._active: set[str] = set()        # rules currently tripped
        self._sweeps = 0
        self._thread_sweeps = 0               # sweeps the THREAD ran

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> bool:
        """Start the sweep thread (idempotent; False when already running
        or disabled via ``H2O3TPU_HEALTH_OFF=1``)."""
        if health_off():
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            if not self._interval_explicit:
                # the process-wide evaluator is built at
                # import, but the knob must land when exported before
                # launch — resolve the cadence at start, not import
                self.interval_s = interval_from_env()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="h2o3-health-sweep")
            self._thread.start()
            return True

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
            # set INSIDE the lock: set-after-release races a concurrent
            # start() — it could clear a new thread's event (killing the
            # sweep it just launched) or miss the old one entirely
            self._stop.set()
        if thread is not None:
            thread.join(timeout=timeout)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        # bounded wait: stop() wakes it immediately, the interval
        # bounds it otherwise; the sweep itself never raises out
        from h2o3_tpu_torch.utils import blackbox as _bb
        from h2o3_tpu_torch.utils import timeline as _tl
        while not self._stop.wait(self.interval_s):
            with self._lock:
                if self._thread is not threading.current_thread():
                    # a stop() whose join timed out on a wedged probe left
                    # this thread alive; a later start() must not revive
                    # it — two sweeps would split every window delta
                    return
            # heartbeat BEFORE the sweep: the black-box watchdog pages on
            # silence, and the sweep body is exactly what can wedge (the
            # chaos seam below is the injectable stall the bench drives;
            # BLACKBOX looked up per sweep so tests can swap the instance)
            _bb.BLACKBOX.beat("health_sweep")
            if _tl.FAULTS is not None:
                _tl.FAULTS.maybe_fault("health.sweep")
            try:
                # a stop() landing while this sweep is in flight drains it:
                # the abort seam is checked between rules AND between a
                # probe and its incident open, so the final sweep can never
                # open an incident after shutdown
                verdict = self.evaluate(abort=self._stop.is_set)
                if verdict is None:
                    return
                with self._eval_lock:
                    # thread-driven sweeps counted apart from inline
                    # evaluate() calls: the bench's hollow-watchdog guard
                    # must prove the WATCHDOG ran, not its own probes
                    self._thread_sweeps += 1
            except Exception:   # noqa: BLE001 — the watcher must outlive
                _LOG.exception("health sweep failed")   # what it watches

    # -- window helpers (probes call back into these) ------------------------

    def _delta(self, key: str, total: float) -> float:
        """Counter movement since the previous sweep; the FIRST sweep
        baselines (returns 0) so pre-existing totals never page."""
        prev = self._prev.get(key)
        self._prev[key] = total
        return 0.0 if prev is None else max(total - prev, 0.0)

    def _streak(self, key: str, condition: bool) -> int:
        self._streaks[key] = self._streaks.get(key, 0) + 1 if condition else 0
        return self._streaks[key]

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, abort=None) -> "dict | None":
        """Run every rule once; fold into the verdict; open/resolve
        incidents on rule edges. Thread-safe and re-entrant-free (one
        evaluation at a time — window deltas must not interleave).
        ``abort`` (a zero-arg truth callable — the sweep thread passes its
        stop flag) drains the sweep: checked between rules and between a
        probe and its incident open, an aborted sweep returns ``None``
        without opening incidents or publishing a verdict."""
        t0 = time.perf_counter()
        with self._eval_lock:
            verdict = self._evaluate_locked(abort)
        if verdict is not None:
            # aborted (drained) sweeps don't observe: a shutdown-time
            # partial sweep would poison the duration distribution low
            HEALTH_SWEEP_SECONDS.observe(time.perf_counter() - t0)
        return verdict

    def _evaluate_locked(self, abort=None) -> "dict | None":
        self._sweeps += 1
        findings: list[dict] = []
        statuses = {s: HEALTHY for s in SUBSYSTEMS}
        tripped_rules: set[str] = set()
        failed_rules: set[str] = set()
        for rule in self.rules:
            if abort is not None and abort():
                return None
            try:
                observed = rule.probe(self)
            except Exception as e:   # noqa: BLE001 — a sick registry is a
                # finding, not a sweep crash
                failed_rules.add(rule.name)
                findings.append({"rule": rule.name,
                                 "subsystem": rule.subsystem,
                                 "severity": DEGRADED, "observed": None,
                                 "threshold": None,
                                 "message": f"probe failed: "
                                            f"{type(e).__name__}: {e}"})
                statuses[rule.subsystem] = max(
                    statuses[rule.subsystem], DEGRADED, key=_RANK.get)
                continue
            series = self._series.setdefault(rule.name, [])
            if observed is not None:
                series.append(observed)
                del series[:-SERIES_LEN]
                # every rule's observed value is ALSO a retained flight
                # series (health.rule.<name>) — the incident ±window and
                # /3/TimeSeries read it; a no-op when the recorder is off
                try:
                    _fl.FLIGHT.ingest(f"health.rule.{rule.name}", observed)
                except Exception:   # noqa: BLE001 — recording must never
                    pass            # break evaluating
            threshold = rule.threshold()
            if not rule.tripped(observed, threshold):
                continue
            tripped_rules.add(rule.name)
            cmp = ">" if rule.direction == "above" else "<"
            message = (f"{rule.name}: observed {observed} {cmp} threshold "
                       f"{threshold}{' ' + rule.unit if rule.unit else ''} "
                       f"— {rule.description}")
            findings.append({"rule": rule.name, "subsystem": rule.subsystem,
                             "severity": rule.severity, "observed": observed,
                             "threshold": threshold, "message": message})
            statuses[rule.subsystem] = max(
                statuses[rule.subsystem], rule.severity, key=_RANK.get)
            if abort is not None and abort():
                # the stop flag rose while this rule's probe ran — the
                # drained sweep must not open an incident after shutdown
                return None
            self.incidents.open(rule.name, rule.subsystem, rule.severity,
                                message, observed, threshold,
                                series=series,
                                source_series=rule.source_series)
        # falling edges resolve their incidents — but a FAILED probe is
        # blindness, not recovery: a rule whose probe raised stays in
        # whatever state it was (an open incident must not read "resolved"
        # because the registry it watches got sick)
        for name in self._active - tripped_rules - failed_rules:
            self.incidents.resolve(name)
        self._active = tripped_rules | (self._active & failed_rules)
        overall = max(statuses.values(), key=_RANK.get)
        verdict = {
            "status": overall,
            "healthy": overall == HEALTHY,
            "subsystems": {
                s: {"status": statuses[s],
                    "findings": [f for f in findings
                                 if f["subsystem"] == s]}
                for s in SUBSYSTEMS},
            "findings": findings,
            "sweep": self._sweeps,
            "interval_s": self.interval_s,
            "evaluated_ms": int(time.time() * 1000),
            "open_incidents": self.incidents.open_rules(),
            "rules": [{"rule": r.name, "subsystem": r.subsystem,
                       "severity": r.severity, "threshold": r.threshold(),
                       "direction": r.direction, "unit": r.unit,
                       "env": r.env}
                      for r in self.rules],
        }
        with self._lock:
            self._last = verdict
        return verdict

    def verdict(self) -> dict:
        """What ``GET /3/Health`` serves: the sweep thread's latest verdict
        when one is running (staleness bounded by the interval), else an
        inline evaluation. Disabled (``H2O3TPU_HEALTH_OFF=1``) reports so
        instead of pretending health was checked."""
        if health_off():
            return {"status": "disabled", "healthy": None,
                    "subsystems": {}, "findings": [], "sweep": 0,
                    "open_incidents": [],
                    "message": "H2O3TPU_HEALTH_OFF=1 — evaluator disabled"}
        if self.running():
            with self._lock:
                if self._last is not None:
                    return self._last
        return self.evaluate()

    def last_verdict(self) -> "dict | None":
        """The most recently PUBLISHED verdict, never evaluating inline —
        the flight recorder's health-status series reads this each tick
        (a recorder tick must not become a health sweep)."""
        with self._lock:
            return self._last

    def sweeps(self) -> int:
        with self._eval_lock:
            return self._sweeps

    def thread_sweeps(self) -> int:
        """Sweeps the background THREAD ran (inline :meth:`evaluate`
        calls excluded) — the hollow-watchdog proof."""
        with self._eval_lock:
            return self._thread_sweeps

    def reset(self) -> None:
        """Forget window baselines/streaks/verdict (tests/bench)."""
        with self._eval_lock:
            self._prev.clear()
            self._streaks.clear()
            self._series.clear()
            self._active = set()
            self._sweeps = 0
            self._thread_sweeps = 0
            with self._lock:
                self._last = None


#: the process-wide evaluator (started by ``H2OServer.start``)
HEALTH = HealthEvaluator()


# -- the diagnostic bundle (`h2o logs download` analog) ----------------------

#: env names whose values never leave the process in a bundle
_SECRET_RE = re.compile(
    r"(SECRET|TOKEN|PASSWORD|PASSWD|CREDENTIAL|API_?KEY|ACCESS_?KEY"
    r"|PRIVATE|AUTH|COOKIE|CERT)", re.IGNORECASE)

#: env prefixes worth shipping — the runtime's own knobs plus the CUDA and
#: PyTorch settings that change what runs on the card
_CONFIG_PREFIXES = ("H2O3TPU_", "CUDA_", "PYTORCH_", "TORCH_", "NCCL_")


def redacted_config() -> dict:
    """The config/env knob dump: every tunable that shapes this process,
    with secret-looking names redacted BY NAME (a secret accidentally
    exported under a knob-looking name still ships — redaction is a
    name-pattern contract, documented in docs/OBSERVABILITY.md)."""
    out = {}
    for name in sorted(os.environ):
        if not name.startswith(_CONFIG_PREFIXES):
            continue
        out[name] = ("[redacted]" if _SECRET_RE.search(name)
                     else os.environ[name])
    return out


def hardware_fingerprint() -> dict:
    """Backend identity for the bundle — which hardware produced these
    numbers (the card's name and count, torch and CUDA versions)."""
    import platform
    out: dict = {"python": platform.python_version(),
                 "platform": platform.platform()}
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        out.update(backend="cuda" if n else "cpu",
                   device_kind=torch.cuda.get_device_name(0) if n else None,
                   devices=n, torch=torch.__version__,
                   cuda=torch.version.cuda)
    except Exception as e:   # noqa: BLE001 — a sick backend still bundles
        out["backend_error"] = f"{type(e).__name__}: {e}"
    return out


def _trace_export() -> dict:
    from h2o3_tpu_torch.utils.tracing import TRACER
    summaries = TRACER.list_traces()
    spans = {}
    for t in summaries[:8]:
        try:
            spans[t["trace_id"]] = TRACER.get_trace(t["trace_id"])
        except KeyError:     # evicted between list and get — ring churn
            continue
    return {"traces": summaries, "spans": spans}


def _jsonable(obj) -> bytes:
    return json.dumps(obj, indent=1, default=str).encode()


def diagnostic_bundle(evaluator: HealthEvaluator | None = None
                      ) -> "tuple[bytes, str]":
    """One call, everything an operator needs: a gzip tar of all four
    pillar snapshots (metrics, traces, memory, compute), the health
    verdict, the incident ring (contexts included), the ActionLog, the
    flight-recorder time series, the log ring, the hardware fingerprint,
    and the redacted config dump. Returns
    ``(bytes, filename)`` — the ``POST /3/Diagnostics/bundle`` payload
    and what both clients save to disk."""
    ev = evaluator if evaluator is not None else HEALTH
    members: list[tuple[str, bytes]] = []

    def add(name: str, build) -> None:
        try:
            members.append((name, build()))
        except Exception as e:   # noqa: BLE001 — a sick pillar must not
            # sink the whole bundle; its slot records the failure
            members.append((name + ".error",
                            f"{type(e).__name__}: {e}".encode()))

    add("metrics.json", lambda: _jsonable(_tm.METRICS.snapshot()))
    add("metrics.prom", lambda: _tm.METRICS.to_openmetrics().encode())
    add("traces.json", lambda: _jsonable(_trace_export()))
    add("memory.json", lambda: _memory_summary_bytes())
    add("compute.json", lambda: _compute_snapshot_bytes())
    add("health.json", lambda: _jsonable(ev.verdict()))
    add("incidents.json", lambda: _jsonable(ev.incidents.export()))
    add("actions.json", lambda: _jsonable(_actions_export()))
    add("timeseries.json", lambda: _jsonable(_fl.FLIGHT.export()))
    add("logs.txt",
        lambda: "\n".join(_tm.install_log_ring().lines()).encode())
    add("hardware.json", lambda: _jsonable(hardware_fingerprint()))
    add("config.json", lambda: _jsonable(redacted_config()))

    buf = io.BytesIO()
    now = int(time.time())
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name=f"h2o3_diagnostics/{name}")
            info.size = len(data)
            info.mtime = now
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue(), f"h2o3_diagnostics_{now}.tar.gz"


def _actions_export() -> list:
    """The ActionLog, newest first — only when the ops plane is loaded
    (the bundle must not be the thing that imports it)."""
    import sys
    acts = sys.modules.get("h2o3_tpu_torch.ops_plane.actions")
    return acts.ACTIONS.list() if acts is not None else []


def _memory_summary_bytes() -> bytes:
    from h2o3_tpu_torch.utils.memory import MEMORY
    return _jsonable(MEMORY.summary())


def _compute_snapshot_bytes() -> bytes:
    from h2o3_tpu_torch.utils.costs import COSTS
    return _jsonable(COSTS.snapshot())
