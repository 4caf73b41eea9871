"""Flight recorder — retained metric time series in fixed-memory rings.

The port of ``h2o3_tpu/utils/flight.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: an aircraft flight recorder answers the question the live
gauges cannot — *what happened before*. The four observability pillars
(metrics, traces, memory, compute) and the ops
plane are all instantaneous: a slow RSS leak, a p99 creeping
toward its SLO, an MFU slide across a training run, or a process that
wedges leaves no record to diagnose. This module retains one: a
background sampler snapshots every registered ``h2o3_*`` metric family
plus a handful of derived series (host RSS straight from ``/proc``, the
last health verdict, open-incident count, p99/SLO ratio, minimum rated
MFU, total sheds) into per-series ring buffers with two downsampling
tiers —

- **tier 0 (raw)**: the last ``H2O3TPU_FLIGHT_RAW_SAMPLES`` (default
  300) ``(t, value)`` samples at the sample interval
  (``H2O3TPU_FLIGHT_INTERVAL_SECS``, default 1s, resolved at
  :meth:`FlightRecorder.start`);
- **tier 1 (rollup)**: ``H2O3TPU_FLIGHT_ROLLUP_SAMPLES`` (default 480)
  windows of ``H2O3TPU_FLIGHT_ROLLUP_SECS`` (default 30s) each carrying
  ``min`` / ``max`` / ``mean`` / ``last`` / ``count`` — four hours of
  history at the defaults, in bounded memory.

Memory IS bounded: at most ``H2O3TPU_FLIGHT_MAX_SERIES`` (default 512)
distinct series are retained; overflow series are counted and dropped,
never grown. This bound is why metric label values must stay bounded
— an unbounded label (a DKV
key, a file path, a raw tenant string) would evict real series.

Consumers:

- ``GET /3/TimeSeries?name=&labels=&since=`` (+ Python
  ``client.timeseries()``, R ``h2o.timeseries``) serves the record live;
- trend rules (``utils/health.py``) compute sustained-slope detectors
  over :meth:`FlightRecorder.values`;
- incident context (``utils/incidents.py``) stamps the ±window of the
  tripping series via :meth:`FlightRecorder.window`;
- the black-box post-mortem (``utils/blackbox.py``) and the diagnostics
  bundle ship :meth:`FlightRecorder.export` as ``timeseries.json``.

``H2O3TPU_FLIGHT_OFF=1`` disables everything (sampler, passive ingest);
the bench's overhead comparator. The recorder never imports REST and the
sampler never raises out of its loop — a sick registry is a skipped
sample, not a dead recorder.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
import threading
import time

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

_LOG = logging.getLogger("h2o3_tpu_torch")

#: wall seconds per sampler tick — the observe-the-observers instrument
#: (a slow tick means a registry read is dragging; docs/OBSERVABILITY.md)
FLIGHT_SAMPLE_SECONDS = _tm.METRICS.histogram(
    "h2o3_flight_sample_seconds",
    "wall seconds per flight-recorder sampler tick")


def flight_off() -> bool:
    return os.environ.get("H2O3TPU_FLIGHT_OFF", "") == "1"


def interval_from_env(default: float = 1.0) -> float:
    """Sampler interval seconds (``H2O3TPU_FLIGHT_INTERVAL_SECS``) —
    bounded below so a typo can never busy-spin the sampler."""
    try:
        return max(float(os.environ.get("H2O3TPU_FLIGHT_INTERVAL_SECS", "")
                         or default), 0.05)
    except ValueError:
        return default


def _env_int(name: str, default: int, lo: int) -> int:
    try:
        return max(int(os.environ.get(name, "") or default), lo)
    except ValueError:
        return default


def _env_float(name: str, default: float, lo: float) -> float:
    try:
        return max(float(os.environ.get(name, "") or default), lo)
    except ValueError:
        return default


# -- derived samplers (module-level seams: tests monkeypatch these) ----------

def _derived_rss() -> float:
    """Host RSS straight from ``/proc`` — NOT the ``h2o3_host_rss_bytes``
    gauge, which only moves when the MemoryMeter samples; a leak between
    meter sweeps must still land in the record."""
    from h2o3_tpu_torch.utils.memory import host_stats
    return float(host_stats()["rss_bytes"])


def _derived_health_status() -> "float | None":
    """Rank of the LAST published verdict (0 healthy / 1 degraded /
    2 unhealthy) — never forces an inline evaluation; a recorder tick
    must not become a health sweep."""
    from h2o3_tpu_torch.utils.health import _RANK, HEALTH
    last = HEALTH.last_verdict()
    if last is None:
        return None
    return float(_RANK.get(last.get("status"), 0))


def _derived_open_incidents() -> float:
    from h2o3_tpu_torch.utils.incidents import INCIDENTS
    return float(len(INCIDENTS.open_rules()))


def _derived_p99_ratio() -> "float | None":
    """Worst resident p99/SLO ratio — only when serving is loaded (the
    sampler must not be the thing that imports the stack)."""
    svc = sys.modules.get("h2o3_tpu_torch.serving.service")
    if svc is None:
        return None
    ratios = []
    for row in svc.SCORING.stats().get("resident") or ():
        slo = row.get("slo") or {}
        target, p99 = slo.get("target_ms"), slo.get("p99_ms")
        if target and p99 is not None:
            ratios.append(p99 / target)
    return round(max(ratios), 6) if ratios else None


def _derived_mfu_min() -> "float | None":
    """Minimum utilization across rated loops (≥3 samples) — the MFU
    decline trend rule's input."""
    costs = sys.modules.get("h2o3_tpu_torch.utils.costs")
    if costs is None:
        return None
    utils = [st.get("utilization") for st in costs.COSTS.loops().values()
             if st.get("utilization") is not None
             and st.get("samples", 0) >= 3]
    return round(min(utils), 6) if utils else None


def _derived_shed_total() -> float:
    """All-label shed count — the shed-acceleration trend rule's input."""
    return float(sum(c.value for _, c in _tm.SCORE_SHED.children()))


#: name -> zero-arg sampler; each fault-isolated per tick, None = skip
DERIVED_SERIES = {
    "derived.host_rss_bytes": _derived_rss,
    "derived.health_status": _derived_health_status,
    "derived.open_incidents": _derived_open_incidents,
    "derived.p99_slo_ratio": _derived_p99_ratio,
    "derived.mfu_min": _derived_mfu_min,
    "derived.score_shed_total": _derived_shed_total,
}


class _Series:
    """One retained series: a raw ring of ``(t, value)`` plus the rollup
    ring and its pending accumulation window. Mutated only under the
    owning recorder's lock."""

    __slots__ = ("name", "labels", "raw", "rollup", "pend")

    def __init__(self, name: str, labels: dict, raw_len: int,
                 rollup_len: int):
        self.name = name
        self.labels = dict(labels)
        self.raw = collections.deque(maxlen=raw_len)
        self.rollup = collections.deque(maxlen=rollup_len)
        self.pend: "dict | None" = None

    def append(self, t: float, value: float, rollup_secs: float) -> None:
        self.raw.append((t, value))
        p = self.pend
        if p is not None and t - p["t"] >= rollup_secs:
            self.rollup.append({"t": p["t"], "min": p["min"],
                                "max": p["max"],
                                "mean": p["sum"] / p["count"],
                                "last": p["last"], "count": p["count"]})
            p = None
        if p is None:
            self.pend = {"t": t, "min": value, "max": value, "sum": value,
                         "count": 1, "last": value}
        else:
            p["min"] = min(p["min"], value)
            p["max"] = max(p["max"], value)
            p["sum"] += value
            p["count"] += 1
            p["last"] = value

    def view(self, since: "float | None" = None,
             last_n: "int | None" = None) -> dict:
        samples = [(t, v) for t, v in self.raw
                   if since is None or t >= since]
        if last_n is not None:
            samples = samples[-last_n:]
        rollup = [r for r in self.rollup
                  if since is None or r["t"] >= since]
        return {"name": self.name, "labels": dict(self.labels),
                "samples": [[round(t, 3), v] for t, v in samples],
                "rollup": rollup}


def _series_key(name: str, labels: "dict | None") -> str:
    if not labels:
        return name
    return name + "|" + ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class FlightRecorder:
    """The always-on recorder: a bounded-interval sampler thread feeding
    fixed-memory two-tier rings, plus a passive :meth:`ingest` seam for
    out-of-band series (the health evaluator pushes every rule's observed
    value each sweep). Query with :meth:`query` (REST), :meth:`values`
    (trend rules), :meth:`window` (incident context), :meth:`export`
    (bundle / post-mortem)."""

    def __init__(self, interval_s: "float | None" = None,
                 raw_len: "int | None" = None,
                 rollup_len: "int | None" = None,
                 rollup_secs: "float | None" = None,
                 max_series: "int | None" = None):
        self._interval_explicit = interval_s is not None
        self._lock = lockwitness.lock("utils.flight.FlightRecorder._lock")
        self.interval_s = (interval_s if interval_s is not None
                           else interval_from_env())
        self._raw_len = raw_len if raw_len is not None else \
            _env_int("H2O3TPU_FLIGHT_RAW_SAMPLES", 300, 16)
        self._rollup_len = rollup_len if rollup_len is not None else \
            _env_int("H2O3TPU_FLIGHT_ROLLUP_SAMPLES", 480, 16)
        self.rollup_secs = rollup_secs if rollup_secs is not None else \
            _env_float("H2O3TPU_FLIGHT_ROLLUP_SECS", 30.0, 0.05)
        self._max_series = max_series if max_series is not None else \
            _env_int("H2O3TPU_FLIGHT_MAX_SERIES", 512, 8)
        self._series: "dict[str, _Series]" = {}
        self._dropped_series = 0
        self._ticks = 0
        self._samples_total = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> bool:
        """Start the sampler thread (idempotent; False when already
        running or disabled via ``H2O3TPU_FLIGHT_OFF=1``). Env knobs are
        resolved HERE, not at import."""
        if flight_off():
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            if not self._interval_explicit:
                self.interval_s = interval_from_env()
            self.rollup_secs = _env_float(
                "H2O3TPU_FLIGHT_ROLLUP_SECS", self.rollup_secs, 0.05)
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="h2o3-flight-sample")
            self._thread.start()
            return True

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
            # set inside the lock: set-after-release races a concurrent
            # start() (the health evaluator's stop() lesson)
            self._stop.set()
        if thread is not None:
            thread.join(timeout=timeout)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        # bounded wait: stop() wakes it, the interval bounds it
        while not self._stop.wait(self.interval_s):
            with self._lock:
                if self._thread is not threading.current_thread():
                    return      # superseded by a stop()+start() cycle
            try:
                self.sample_once()
            except Exception:   # noqa: BLE001 — the recorder must outlive
                _LOG.exception("flight sample failed")  # what it records

    # -- sampling ------------------------------------------------------------

    def sample_once(self, now: "float | None" = None) -> int:
        """One sampler tick: snapshot every metric family (buckets
        excluded — the rollup tier IS the downsampling story) plus the
        derived series. Returns the number of samples recorded."""
        if flight_off():
            return 0
        t0 = time.perf_counter()
        t = time.time() if now is None else now
        wrote = 0
        try:
            rows = _tm.METRICS.snapshot(include_buckets=False)
        except Exception:   # noqa: BLE001 — a sick registry skips a tick
            rows = []
        with self._lock:
            for row in rows:
                if self._ingest_locked(row["name"], row["value"],
                                       row["labels"], t):
                    wrote += 1
            for name, fn in DERIVED_SERIES.items():
                try:
                    value = fn()
                except Exception:   # noqa: BLE001 — one sick source must
                    continue        # not starve the other series
                if value is None:
                    continue
                if self._ingest_locked(name, float(value), None, t):
                    wrote += 1
            self._ticks += 1
        FLIGHT_SAMPLE_SECONDS.observe(time.perf_counter() - t0)
        return wrote

    def ingest(self, name: str, value, labels: "dict | None" = None,
               now: "float | None" = None) -> bool:
        """Record one out-of-band sample (the health evaluator pushes
        every rule's observed value under ``health.rule.<name>`` each
        sweep). Passive — works whether or not the sampler thread runs;
        a no-op under ``H2O3TPU_FLIGHT_OFF=1`` or for non-numeric
        values."""
        if flight_off() or value is None:
            return False
        try:
            value = float(value)
        except (TypeError, ValueError):
            return False
        t = time.time() if now is None else now
        with self._lock:
            return self._ingest_locked(name, value, labels, t)

    def _ingest_locked(self, name: str, value: float,
                       labels: "dict | None", t: float) -> bool:
        key = _series_key(name, labels)
        ser = self._series.get(key)
        if ser is None:
            if len(self._series) >= self._max_series:
                # the fixed-memory contract: overflow series are counted
                # and DROPPED, never grown (unbounded label values are
                # what makes this branch fire)
                self._dropped_series += 1
                return False
            ser = _Series(name, labels or {}, self._raw_len,
                          self._rollup_len)
            self._series[key] = ser
        ser.append(t, value, self.rollup_secs)
        self._samples_total += 1
        return True

    # -- queries -------------------------------------------------------------

    def query(self, name: "str | None" = None,
              labels: "dict | None" = None,
              since: "float | None" = None) -> list[dict]:
        """Matching series views, sorted by (name, labels). ``name``
        matches exactly or as a prefix; ``labels`` must be a subset of a
        series' labels; ``since`` (epoch seconds) filters samples."""
        with self._lock:
            sers = list(self._series.values())
        out = []
        for ser in sers:
            if name is not None and ser.name != name \
                    and not ser.name.startswith(name):
                continue
            if labels and any(ser.labels.get(k) != v
                              for k, v in labels.items()):
                continue
            out.append(ser.view(since=since))
        out.sort(key=lambda s: (s["name"], sorted(s["labels"].items())))
        return out

    def values(self, name: str, labels: "dict | None" = None,
               last_n: "int | None" = None) -> list[float]:
        """The last-N raw values of ONE series (exact name + labels) —
        what trend probes consume. Empty when the series doesn't exist
        (recorder off / not started / never sampled): a trend probe must
        degrade to not-applicable, never crash."""
        with self._lock:
            ser = self._series.get(_series_key(name, labels))
            if ser is None:
                return []
            vals = [v for _, v in ser.raw]
        return vals[-last_n:] if last_n is not None else vals

    def window(self, name: str, labels: "dict | None" = None,
               last_n: "int | None" = None) -> "dict | None":
        """The ±window an incident context captures: the tripping
        series' raw tail plus its rollup history. None when the series
        holds no samples — callers keep their point-sample fallback."""
        with self._lock:
            ser = self._series.get(_series_key(name, labels))
            if ser is None or not ser.raw:
                return None
            view = ser.view(last_n=last_n)
        view["interval_s"] = self.interval_s
        view["rollup_secs"] = self.rollup_secs
        return view

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def stats(self) -> dict:
        with self._lock:
            return {"running": (self._thread is not None
                                and self._thread.is_alive()),
                    "off": flight_off(),
                    "interval_s": self.interval_s,
                    "rollup_secs": self.rollup_secs,
                    "raw_samples": self._raw_len,
                    "rollup_samples": self._rollup_len,
                    "max_series": self._max_series,
                    "series": len(self._series),
                    "samples_total": self._samples_total,
                    "dropped_series": self._dropped_series,
                    "ticks": self._ticks}

    def export(self) -> dict:
        """The full record — the bundle's ``timeseries.json`` and the
        black-box post-mortem's ``flight.json``. Bounded by the rings."""
        return {"stats": self.stats(), "series": self.query()}

    def ticks(self) -> int:
        """Sampler ticks taken (the bench's hollow-sampler proof)."""
        with self._lock:
            return self._ticks

    def reset(self) -> None:
        """Drop every series and counter (tests/bench isolation only)."""
        with self._lock:
            self._series.clear()
            self._dropped_series = 0
            self._ticks = 0
            self._samples_total = 0


#: the process-wide recorder (started by ``H2OServer.start``; trend rules
#: and incident context read it wherever it is in its lifecycle)
FLIGHT = FlightRecorder()
