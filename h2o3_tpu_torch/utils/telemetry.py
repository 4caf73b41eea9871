"""Runtime telemetry — metrics registry, OpenMetrics export, structured log
ring — the port of ``h2o3_tpu/utils/telemetry.py`` (the same families, with
the same names, labels and help, so a dashboard reads either package).

Reference: H2O-3's observability surface — ``water/util/Log.java`` (level-split
log files behind ``water/api/LogsHandler`` → ``/3/Logs``), the ``WaterMeter*``
meters, and the per-request timing Jetty keeps. Here the runtime equivalents
are a process-local :class:`MetricsRegistry` (counters / gauges / fixed-bucket
histograms with optional labels) exported as JSON (``/3/Metrics``) and
Prometheus/OpenMetrics text (``/metrics``), plus a :class:`LogRing` handler —
a fixed-size ring of formatted log lines in H2O's ``MM-dd HH:mm:ss.SSS`` line
format, installed on the ``h2o3_tpu_torch`` logger at session/server
startup.

Design constraints:

- **Always-on and off the device.** Every record site is host-side Python
  around a dispatch (a lock-protected float add, ~µs), and every observation
  is a host number the site already has: no counter reads a device value.
- **Thread-safe and exact.** One registry lock guards family creation AND all
  child mutations, so concurrent increments from REST handler threads and
  training jobs never lose counts.
- **Bounded cardinality.** Label values are route patterns / algo names /
  function names — never keys, paths, or user data.
"""

from __future__ import annotations

import bisect
import collections
import logging
import math
import threading

from h2o3_tpu_torch.utils import lockwitness

# Latency buckets (seconds) for request/dispatch histograms: µs-scale
# dispatches up through slow requests.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Build-latency buckets: model builds run seconds to an hour — resolution
# must extend past the minute mark or every real build lands in +Inf.
BUILD_BUCKETS = (0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                 600.0, 1800.0, 3600.0)


def _fmt(v: float) -> str:
    """OpenMetrics number rendering: integral floats print as integers."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Label-value escaping per the OpenMetrics exposition format: exactly
    backslash, double-quote, and line feed — in that order (escaping the
    escape character first, or a pre-escaped ``\\n`` would double)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: the format defines only ``\\\\`` and ``\\n``
    here — a ``\\"`` in HELP is an *invalid* escape sequence that makes
    strict OpenMetrics parsers reject the whole exposition, so quotes pass
    through verbatim (unlike label values, HELP is not quote-delimited)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class _Counter:
    """Monotone counter child (one label combination)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self.value += amount


class _Gauge:
    """Settable gauge child."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _Histogram:
    """Fixed-bucket histogram child; also tracks min/max so per-dispatch
    duration spreads (straggler visibility) survive aggregation.

    Observations are validated: every histogram here measures a duration,
    a size, or a count — all non-negative and finite by definition. A NaN
    poisons ``_sum`` (and every percentile read downstream) irreversibly,
    a negative or infinite value corrupts it silently; such observations
    are DROPPED and accounted in ``h2o3_telemetry_rejected_total{where}``
    instead (the instrument reports its own bad inputs rather than lying
    with them)."""

    __slots__ = ("_lock", "_reject", "buckets", "counts", "sum", "count",
                 "min", "max")

    def __init__(self, lock: threading.Lock, buckets: tuple, reject=None):
        self._lock = lock
        self._reject = reject               # callable: count a dropped obs
        self.buckets = buckets              # ascending upper bounds, no +Inf
        self.counts = [0] * (len(buckets) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v) or v < 0.0:
            if self._reject is not None:
                self._reject()
            return
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, v)] += 1
            self.sum += v
            self.count += 1
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One named metric family: type + help + label schema + children."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str, labelnames: tuple, buckets: tuple | None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._registry = registry
        self._lock = registry._lock
        self._children: dict[tuple, object] = {}

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name} wants labels {self.labelnames}, "
                             f"got {tuple(labels)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                cls = _KINDS[self.kind]
                child = (cls(self._lock, self.buckets,
                             reject=self._registry._rejecter(self.name))
                         if self.kind == "histogram" else cls(self._lock))
                self._children[key] = child
        return child

    # label-less convenience: the family IS its single child
    def _default(self):
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def children(self) -> list[tuple[dict, object]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]


class MetricsRegistry:
    """Thread-safe registry of counter/gauge/histogram families.

    Declaring an existing name returns the same family (idempotent — safe to
    declare at every call site); re-declaring with a different type raises.
    """

    def __init__(self):
        self._lock = lockwitness.rlock("utils.telemetry.MetricsRegistry._lock")
        self._families: dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str, labelnames,
                buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(f"metric {name!r} already registered as "
                                     f"{fam.kind}, not {kind}")
                return fam
            fam = _Family(self, name, kind, help, tuple(labelnames), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> _Family:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> _Family:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: tuple = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labelnames,
                            tuple(sorted(buckets)))

    def reject(self, where: str) -> None:
        """Account one invalid observation (NaN / negative / infinite)
        dropped at ``where`` instead of poisoning an instrument. The ONE
        home of the ``h2o3_telemetry_rejected`` registration — histogram
        children and the serving ``LatencyRing`` both route here, so the
        name/help/labels can never drift apart. ``where`` is a family
        name or a code-defined site, so cardinality stays bounded."""
        self.counter(
            "h2o3_telemetry_rejected",
            "invalid observations (NaN/negative/non-finite) dropped "
            "instead of poisoning a histogram or percentile ring",
            ("where",)).labels(where=where).inc()

    def _rejecter(self, where: str):
        """The per-family drop callback histogram children hold."""
        def count() -> None:
            self.reject(where)
        return count

    def reset(self) -> None:
        """Drop every family (tests only — production metrics are append-only)."""
        with self._lock:
            self._families.clear()

    # -- exporters -----------------------------------------------------------

    def snapshot(self, include_buckets: bool = True) -> list[dict]:
        """Flat sample rows — uniform {name, type, labels, value} dicts, so
        the REST layer can serve them TwoDimTable-style and ``bench.py`` can
        embed them in an artifact."""
        # the registry RLock also guards every child mutation, so holding it
        # across the read pass yields a consistent snapshot (no torn
        # bucket-vs-count reads mid-observe); exports are rare and fast
        with self._lock:
            return self._snapshot_locked(include_buckets)

    def _snapshot_locked(self, include_buckets: bool) -> list[dict]:
        out: list[dict] = []
        for fam in self._families.values():
            for labels, child in fam.children():
                if fam.kind == "histogram":
                    if include_buckets:
                        cum = 0
                        for ub, c in zip(fam.buckets, child.counts):
                            cum += c
                            out.append(dict(name=f"{fam.name}_bucket",
                                            type="histogram",
                                            labels={**labels, "le": _fmt(ub)},
                                            value=cum))
                        out.append(dict(name=f"{fam.name}_bucket",
                                        type="histogram",
                                        labels={**labels, "le": "+Inf"},
                                        value=child.count))
                    out.append(dict(name=f"{fam.name}_count",
                                    type="histogram", labels=labels,
                                    value=child.count))
                    out.append(dict(name=f"{fam.name}_sum",
                                    type="histogram", labels=labels,
                                    value=child.sum))
                    if child.count:
                        out.append(dict(name=f"{fam.name}_min",
                                        type="histogram", labels=labels,
                                        value=child.min))
                        out.append(dict(name=f"{fam.name}_max",
                                        type="histogram", labels=labels,
                                        value=child.max))
                elif fam.kind == "counter":
                    out.append(dict(name=f"{fam.name}_total", type="counter",
                                    labels=labels, value=child.value))
                else:
                    out.append(dict(name=fam.name, type="gauge",
                                    labels=labels, value=child.value))
        return out

    def to_openmetrics(self) -> str:
        """Prometheus/OpenMetrics exposition text (ends with ``# EOF``).
        Rendered under the registry lock for the same consistency guarantee
        as :meth:`snapshot` (monotone cumulative buckets vs ``_count``)."""
        with self._lock:
            return self._openmetrics_locked()

    def _openmetrics_locked(self) -> str:
        lines: list[str] = []
        for fam in self._families.values():
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            for labels, child in fam.children():
                ls = _label_str(labels)
                if fam.kind == "counter":
                    lines.append(f"{fam.name}_total{ls} {_fmt(child.value)}")
                elif fam.kind == "gauge":
                    lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
                else:
                    cum = 0
                    for ub, c in zip(fam.buckets, child.counts):
                        cum += c
                        bl = _label_str({**labels, "le": _fmt(ub)})
                        lines.append(f"{fam.name}_bucket{bl} {cum}")
                    bl = _label_str({**labels, "le": "+Inf"})
                    lines.append(f"{fam.name}_bucket{bl} {child.count}")
                    lines.append(f"{fam.name}_count{ls} {child.count}")
                    lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Log ring — the LogsHandler backing store.

#: H2O's log line format: ``MM-dd HH:mm:ss.SSS pid thread LEVEL logger: msg``
#: (reference: ``water/util/Log.java`` ``logHeader``).
LOG_FORMAT = ("%(asctime)s.%(msecs)03d %(process)d %(threadName)s "
              "%(levelname)-5s %(name)s: %(message)s")
LOG_DATEFMT = "%m-%d %H:%M:%S"

LOG_RING_SIZE = 2048


class LogRing(logging.Handler):
    """Fixed-size ring of formatted log records (reference: the in-memory
    tail ``LogsHandler`` serves per level-file). ``deque(maxlen=...)`` gives
    lock-free thread-safe appends under the GIL."""

    def __init__(self, capacity: int = LOG_RING_SIZE):
        super().__init__()
        self.capacity = capacity
        self.buffer: collections.deque = collections.deque(maxlen=capacity)
        self.setFormatter(logging.Formatter(LOG_FORMAT, LOG_DATEFMT))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            text = self.format(record)
            if "\n" in text:
                # one record = one ring line: multi-line payloads
                # (tracebacks, thread dumps) fold onto the header line so
                # every line /3/Logs serves keeps the H2O line format —
                # consumers (h2o-py get_log, the format-parity tests) parse
                # the ``MM-dd HH:mm:ss.SSS pid thread LEVEL`` header per line
                text = " | ".join(
                    ln.rstrip() for ln in text.splitlines() if ln.strip())
            self.buffer.append((record.levelno, text))
        except Exception:   # noqa: BLE001 — logging must never raise
            self.handleError(record)

    def lines(self, min_level: int = 0) -> list[str]:
        return [line for lv, line in list(self.buffer) if lv >= min_level]


LOG_RING: LogRing | None = None

#: reference log *files* → minimum level served (``water/util/Log.java``
#: writes one file per level; ``h2o-py``'s ``get_log`` names one of these)
LOG_FILES = {"trace": 0, "debug": logging.DEBUG, "default": logging.INFO,
             "info": logging.INFO, "httpd": logging.INFO,
             "stdout": logging.INFO, "stderr": logging.WARNING,
             "warn": logging.WARNING, "error": logging.ERROR,
             "fatal": logging.CRITICAL}


def install_log_ring(capacity: int = LOG_RING_SIZE) -> LogRing:
    """Idempotently attach the ring to the ``h2o3_tpu_torch`` logger (called at
    session/server startup; safe to call from any thread, any number of
    times)."""
    global LOG_RING
    logger = logging.getLogger("h2o3_tpu_torch")
    for h in logger.handlers:
        if isinstance(h, LogRing):
            LOG_RING = h
            return h
    ring = LogRing(capacity)
    logger.addHandler(ring)
    if logger.level == logging.NOTSET:
        # the root logger defaults to WARNING; INFO here keeps startup /
        # LogAndEcho lines flowing into the ring without touching root
        logger.setLevel(logging.INFO)
    LOG_RING = ring
    return ring


# ---------------------------------------------------------------------------
# Metric catalog — every always-on instrument in the runtime declares here,
# so the name inventory (docs/OBSERVABILITY.md) has one source of truth.

METRICS = MetricsRegistry()

# REST surface (recorded in api/server.py:_route)
REQUESTS = METRICS.counter(
    "h2o3_requests", "REST requests served, by route pattern/method/status",
    ("route", "method", "status"))
REQUEST_SECONDS = METRICS.histogram(
    "h2o3_request_duration_seconds", "REST request latency",
    ("route", "method"))
SCRAPE_SECONDS = METRICS.histogram(
    "h2o3_metrics_scrape_seconds",
    "wall seconds to render the /metrics OpenMetrics exposition — a "
    "scrape dragging means the registry itself is the bottleneck")

# map_reduce substrate (ops/map_reduce.py)
MR_DISPATCHES = METRICS.counter(
    "h2o3_mapreduce_dispatches", "map_reduce collective dispatches", ("fn",))
MR_PARTITIONS = METRICS.counter(
    "h2o3_mapreduce_partitions",
    "row shards (mesh devices) covered by dispatches")
MR_DISPATCH_SECONDS = METRICS.histogram(
    "h2o3_mapreduce_dispatch_seconds",
    "per-dispatch wall time; min/max spread flags stragglers", ("fn",))

# ingest (frame/parse.py)
PARSE_ROWS = METRICS.counter("h2o3_parse_rows", "rows parsed into frames")
PARSE_BYTES = METRICS.counter("h2o3_parse_bytes", "source bytes parsed")
PARSE_CHUNKS = METRICS.counter(
    "h2o3_parse_chunks", "column chunks (vecs) created by parses")

# streaming ingest pipeline (ingest/pipeline.py — docs/INGEST.md)
INGEST_CHUNKS = METRICS.counter(
    "h2o3_ingest_chunks", "fixed-row-count chunk batches through the "
    "streaming parse pipeline")
INGEST_ROWS = METRICS.counter(
    "h2o3_ingest_rows", "rows parsed by the streaming pipeline")
INGEST_BYTES = METRICS.counter(
    "h2o3_ingest_bytes", "decompressed source bytes consumed by the "
    "streaming pipeline")
INGEST_ENCODED_BYTES = METRICS.counter(
    "h2o3_ingest_encoded_bytes", "compressed host payload bytes produced "
    "by the chunk encoders (vs 4B/value eager columns)")
INGEST_RESTARTS = METRICS.counter(
    "h2o3_ingest_restarts", "promote-and-reparse restarts (a chunk past "
    "the type-inference sample broke a numeric guess)")

# compressed-chunk seam (frame/vec.py lazy decompress-on-access)
CHUNK_DECOMPRESS = METRICS.counter(
    "h2o3_chunk_decompress", "compressed columns materialized to device "
    "arrays on access (Chunk.atd decompress-on-access)")
CHUNK_DECOMPRESS_BYTES = METRICS.counter(
    "h2o3_chunk_decompress_bytes", "decoded bytes materialized on access")
CHUNK_VIEW_DROPS = METRICS.counter(
    "h2o3_chunk_view_drops", "derived device views of compressed columns "
    "dropped by the Cleaner (tier-1 eviction)")
CHUNK_VIEW_DROP_BYTES = METRICS.counter(
    "h2o3_chunk_view_drop_bytes", "device bytes freed by view drops")

# Cleaner spill/fault-in (utils/cleaner.py — docs/INGEST.md "Spill")
SPILLS = METRICS.counter(
    "h2o3_spill", "DKV values spilled to the ice_root", ("kind",))
SPILL_BYTES = METRICS.counter(
    "h2o3_spill_bytes", "resident bytes released by spills", ("kind",))
SPILL_RESTORES = METRICS.counter(
    "h2o3_spill_restore", "spilled values faulted back in on access",
    ("kind",))
SPILL_RESTORE_BYTES = METRICS.counter(
    "h2o3_spill_restore_bytes", "bytes faulted back in on access", ("kind",))

# DKV (utils/registry.py)
DKV_PUTS = METRICS.counter("h2o3_dkv_puts", "DKV puts")
DKV_GETS = METRICS.counter("h2o3_dkv_gets", "DKV gets")
DKV_REMOVES = METRICS.counter("h2o3_dkv_removes", "DKV removes")
DKV_KEYS = METRICS.gauge("h2o3_dkv_keys", "resident DKV keys")

# memory accounting (utils/memory.py MemoryMeter)
DKV_BYTES = METRICS.gauge(
    "h2o3_dkv_bytes", "resident DKV bytes by value kind "
    "(frame/model/raw/job/other; `spilled` carries ON-DISK bytes so the "
    "view reconciles across a Cleaner sweep)", ("kind",))
HOST_RSS_BYTES = METRICS.gauge(
    "h2o3_host_rss_bytes", "process resident set size (/proc/self/status)")
HOST_RSS_PEAK_BYTES = METRICS.gauge(
    "h2o3_host_rss_peak_bytes", "monotonic high-water mark of host RSS")
DEVICE_BYTES = METRICS.gauge(
    "h2o3_device_bytes_in_use",
    "device (HBM) bytes in use, summed over devices; from "
    "device.memory_stats() or live-array accounting on backends without it")
DEVICE_PEAK_BYTES = METRICS.gauge(
    "h2o3_device_peak_bytes",
    "monotonic high-water mark of device bytes in use")

# persist layer (persist/frame_io.py, persist/model_io.py)
PERSIST_READ_BYTES = METRICS.counter(
    "h2o3_persist_read_bytes", "bytes read by the persist layer", ("what",))
PERSIST_WRITE_BYTES = METRICS.counter(
    "h2o3_persist_write_bytes", "bytes written by the persist layer", ("what",))

# model builds (models/model_base.py)
MODEL_BUILDS = METRICS.counter(
    "h2o3_model_builds", "completed model builds", ("algo",))
MODEL_BUILD_SECONDS = METRICS.histogram(
    "h2o3_model_build_seconds", "model build wall time", ("algo",),
    buckets=BUILD_BUCKETS)

# host-driven convergence loops (models/*.py drivers): per-iteration wall
# time — IRLS steps, boosting chunks, DL epochs. The before/after evidence
# for host-sync batching fixes lives here: fewer
# device→host round-trips per iteration shifts this histogram left.
ITER_SECONDS = METRICS.histogram(
    "h2o3_iteration_seconds",
    "per-iteration wall time of host-driven convergence loops", ("loop",))

# dispatch economy of the same loops: blocking host fetches per logical
# iteration (1.0 = the classic sync-per-step driver; 1/K under K-step
# megasteps). Set by models/model_base.publish_dispatch_audit at the end of
# every fit; bench gates on it so a per-iteration fetch cannot silently
# return to a hot path.
DISPATCHES_PER_ITER = METRICS.gauge(
    "h2o3_dispatches_per_iteration",
    "blocking host syncs per logical iteration of a convergence loop "
    "(1/K under K-step megasteps)", ("loop",))

# mesh-slice scheduler (orchestration/scheduler.py): utilization of the
# disjoint device slices concurrent builds run on (docs/ORCHESTRATION.md).
# Slice labels are indices ("0".."k-1") or "full" for whole-mesh leases.
SLICE_COUNT = METRICS.gauge(
    "h2o3_slice_count",
    "device slices the mesh scheduler currently carves the global mesh into")
SLICE_BUSY = METRICS.counter(
    "h2o3_slice_busy_seconds",
    "cumulative seconds a slice spent running leased builds", ("slice",))
SLICE_BUILDS = METRICS.counter(
    "h2o3_slice_builds", "model builds leased onto a slice", ("slice",))
SLICE_QUEUE_WAIT = METRICS.histogram(
    "h2o3_slice_queue_wait_seconds",
    "time a build waited for a free slice (or for the whole mesh)")

# compute observatory (utils/costs.py CostMeter — docs/OBSERVABILITY.md
# "Compute"). Site labels are code-defined logical compile sites
# (glm:irls_megastep, gbm:grow_batched, map_reduce:<fn>, score:<algo>);
# loop labels match the h2o3_iteration_seconds loops plus "scoring".
COMPILES = METRICS.counter(
    "h2o3_compiles", "XLA compiles observed by the cost observatory",
    ("site",))
COMPILE_SECONDS = METRICS.counter(
    "h2o3_compile_seconds", "compile wall seconds per logical site",
    ("site",))
RECOMPILES = METRICS.counter(
    "h2o3_recompiles",
    "signature changes (a site compiling a 2nd+ distinct signature)",
    ("site",))
ACHIEVED_FLOPS = METRICS.gauge(
    "h2o3_achieved_flops_per_sec",
    "achieved FLOP/s of a loop's compiled program (cost_analysis FLOPs / "
    "sampled synced wall time)", ("loop",))
ACHIEVED_BYTES = METRICS.gauge(
    "h2o3_achieved_bytes_per_sec",
    "achieved bytes/s of a loop's compiled program", ("loop",))
ARITH_INTENSITY = METRICS.gauge(
    "h2o3_arithmetic_intensity",
    "FLOPs per byte accessed of a loop's compiled program", ("loop",))
COMPUTE_UTILIZATION = METRICS.gauge(
    "h2o3_compute_utilization",
    "achieved FLOP/s over the backend's peak (MFU); only published on "
    "backends in the peak table — unknown backends report null via "
    "/3/Compute instead of a bogus 0", ("loop",))

# fault injection (utils/timeline.py FaultInjector)
FAULTS_INJECTED = METRICS.counter(
    "h2o3_faults_injected", "faults injected into dispatches", ("kind",))

# elastic local-SGD membership (parallel/elastic.py — docs/RELIABILITY.md
# "Elastic training"): averaging rounds completed, workers ejected by cause,
# and the live-worker gauge the /3/Cloud workers view mirrors
ELASTIC_ROUNDS = METRICS.counter(
    "h2o3_elastic_rounds", "elastic local-SGD averaging rounds completed")
ELASTIC_EJECTIONS = METRICS.counter(
    "h2o3_elastic_ejections",
    "elastic workers ejected, by cause "
    "(heartbeat/deadline/retry_exhausted/fault)", ("reason",))
ELASTIC_WORKERS = METRICS.gauge(
    "h2o3_elastic_workers",
    "live (ACTIVE) workers in the most recent elastic group")

# dispatch reliability (ops/map_reduce.py retrying): one "retried" per
# backoff-and-reattempt, one "exhausted" when the budget runs out and the
# dispatch surfaces as DispatchFailed (docs/RELIABILITY.md)
DISPATCH_RETRIES = METRICS.counter(
    "h2o3_dispatch_retries",
    "dispatch retry events by call site and outcome (retried/exhausted)",
    ("fn", "outcome"))

# job deadlines (models/job.py): builds that hit max_runtime_secs and were
# cooperatively cancelled between megasteps/tree chunks
JOB_DEADLINE_EXCEEDED = METRICS.counter(
    "h2o3_job_deadline_exceeded",
    "jobs terminated by their max_runtime_secs deadline")

# scoring tier (serving/ — docs/SERVING.md). Batch-size buckets are row
# counts (the micro-batcher's power-of-two buckets), not seconds.
SCORE_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                       256.0, 512.0, 1024.0, 2048.0, 4096.0)
SCORE_REQUESTS = METRICS.counter(
    "h2o3_score_requests", "scoring requests served by /3/Score",
    ("algo", "status"))
SCORE_SECONDS = METRICS.histogram(
    "h2o3_score_seconds",
    "end-to-end /3/Score request latency (enqueue -> slice handed back)",
    ("algo",))
SCORE_BATCH_SIZE = METRICS.histogram(
    "h2o3_score_batch_size",
    "rows fused into one scoring dispatch by the micro-batcher",
    buckets=SCORE_BATCH_BUCKETS)
SCORE_BATCH_REQUESTS = METRICS.histogram(
    "h2o3_score_batch_requests",
    "concurrent requests coalesced per scoring dispatch",
    buckets=SCORE_BATCH_BUCKETS)
SCORER_CACHE = METRICS.counter(
    "h2o3_scorer_cache",
    "compiled-scorer signature cache events (hit/miss/evict)", ("event",))
SCORE_RESIDENT_BYTES = METRICS.gauge(
    "h2o3_score_resident_bytes",
    "artifact bytes of models resident in the scoring tier")
SCORE_RESIDENT_MODELS = METRICS.gauge(
    "h2o3_score_resident_models", "models resident in the scoring tier")

# SLO-adaptive serving (serving/slo.py + serving/replicas.py —
# docs/SERVING.md "SLO & replicas"). Shed reasons: overload (admission
# estimator), timeout (in-queue wait ceiling), evicted (persistent
# residency loss); priority is the request's 0-9 class.
SCORE_SHED = METRICS.counter(
    "h2o3_score_shed",
    "scoring requests shed with 503+Retry-After instead of served",
    ("reason", "priority"))
SCORE_QUEUE_WAIT = METRICS.histogram(
    "h2o3_score_queue_wait_seconds",
    "scoring request wait from enqueue to dispatch start (the SLO "
    "controller's scale signal)")
SCORE_WINDOW_MS = METRICS.gauge(
    "h2o3_score_window_ms",
    "current adaptive collect window per model (fixed window when no SLO); "
    "cardinality is bounded by residency, like the per-model /3/Score rows",
    ("model",))
SCORE_REPLICAS = METRICS.gauge(
    "h2o3_score_replicas", "live scoring replicas holding slice leases")
SCORE_SCALE_EVENTS = METRICS.counter(
    "h2o3_score_scale_events",
    "replica pool scale decisions by direction (up/down)", ("direction",))
SCORE_PRECOMPILE = METRICS.counter(
    "h2o3_score_precompile",
    "speculative bucket pre-compiles on replica admission "
    "(scheduled/compiled/failed)", ("event",))
