"""Thin REST client — the h2o-py connection surface over stdlib urllib;
the port of ``h2o3_tpu/api/client.py``, which it copies (standard library
only, so the port keeps its own copy and imports nothing of the JAX
package).

Reference: ``h2o-py/h2o/backend/connection.py:249`` (``H2OConnection.request``
``:431-455``) — every client verb is one HTTP call to the V3 routes; training
polls ``/3/Jobs/{id}`` until DONE (``estimator_base.py:186``).
"""

from __future__ import annotations

import json
import time
import urllib.parse
import uuid
import urllib.request


class H2OClient:
    """``H2OClient(url)`` speaks to a running :class:`H2OServer`."""

    def __init__(self, url: str, tenant: str | None = None):
        self.url = url.rstrip("/")
        #: tenant id sent as ``X-H2O3-Tenant`` on every request (None =
        #: the server's default tenant) — the multi-tenant admission
        #: identity (docs/OPERATIONS.md "Tenancy")
        self.tenant = tenant
        # trace id of the most recent request (from the server's W3C
        # ``traceparent`` response header) — feed it to :meth:`trace`
        self.last_trace_id: str | None = None

    # -- transport -----------------------------------------------------------

    def request(self, method: str, path: str, data: dict | None = None) -> dict:
        url = self.url + path
        body = None
        headers = {}
        if self.tenant is not None:
            headers["X-H2O3-Tenant"] = str(self.tenant)
        if data is not None:
            body = urllib.parse.urlencode(
                {k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
                 for k, v in data.items()}).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req) as resp:
                tp = resp.headers.get("traceparent", "")
                if tp.count("-") >= 2:
                    self.last_trace_id = tp.split("-")[1]
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            payload = e.read().decode()
            try:
                msg = json.loads(payload).get("msg", payload)
            except json.JSONDecodeError:
                msg = payload
            raise RuntimeError(f"{method} {path} → {e.code}: {msg}") from None

    # -- verbs (h2o-py equivalents) ------------------------------------------

    def cloud_status(self) -> dict:
        return self.request("GET", "/3/Cloud")

    def cloud(self) -> dict:
        """Alias of :meth:`cloud_status` (h2o-py ``h2o.cluster()`` shape);
        includes the ``mesh_slices`` utilization view."""
        return self.cloud_status()

    def mesh_slices(self) -> dict:
        """Mesh-slice scheduler utilization: slice layout + per-slice busy
        seconds / builds / queue wait (docs/ORCHESTRATION.md)."""
        return self.cloud_status().get("mesh_slices", {})

    def workers(self) -> list:
        """Elastic local-SGD membership: per-worker state / round /
        last-heartbeat rows of recent elastic groups, served inside
        ``GET /3/Cloud`` (docs/RELIABILITY.md "Elastic training")."""
        return self.cloud_status().get("workers", [])

    def import_file(self, path: str, destination_frame: str | None = None) -> str:
        """Server-side import+parse. A nonexistent/unreadable SERVER path
        surfaces as :class:`FileNotFoundError` carrying the structured 400
        the server replies (never a 500 traceback)."""
        d = {"path": path}
        if destination_frame:
            d["destination_frame"] = destination_frame
        try:
            out = self.request("POST", "/3/ImportFiles", d)
        except RuntimeError as e:
            # only PATH errors map to FileNotFoundError — a 400 can also be
            # a parse failure on a file that exists (ValueError server-side).
            # Anchor on the server's _check_readable message shape so a
            # parse error merely MENTIONING a path phrase never matches.
            msg = str(e)
            if "→ 400:" in msg and "import_file:" in msg \
                    and ("no such file" in msg or "not readable" in msg
                         or "is a directory" in msg):
                raise FileNotFoundError(msg) from None
            raise
        return out["destination_frames"][0]

    def upload_file(self, path: str, destination_frame: str | None = None) -> str:
        """Ship a CLIENT-LOCAL file to the server and parse it (h2o-py
        ``h2o.upload_file``: multipart POST /3/PostFile + POST /3/Parse)."""
        import os
        with open(path, "rb") as f:
            data = f.read()
        boundary = uuid.uuid4().hex
        fname = os.path.basename(path)
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="file"; filename="{fname}"\r\n\r\n').encode() + data \
            + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            self.url + "/3/PostFile", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req) as resp:
            raw_key = json.loads(resp.read())["destination_frame"]
        dest = destination_frame or raw_key
        self.request("POST", "/3/Parse",
                     {"source_frames": [raw_key], "destination_frame": dest})
        return dest

    def frame(self, key: str) -> dict:
        return self.request("GET", f"/3/Frames/{key}")["frames"][0]

    def frames(self) -> list[dict]:
        return self.request("GET", "/3/Frames")["frames"]

    def rm(self, key: str) -> None:
        try:
            self.request("DELETE", f"/3/Frames/{key}")
        except RuntimeError:
            self.request("DELETE", f"/3/Models/{key}")

    def train(self, algo: str, training_frame: str, y: str | None = None,
              poll_secs: float = 0.2, **params) -> dict:
        """POST /3/ModelBuilders/{algo}, poll the job, return the model JSON."""
        d = {"training_frame": training_frame, **params}
        if y is not None:
            d["response_column"] = y
        out = self.request("POST", f"/3/ModelBuilders/{algo}", d)
        job = self._poll(out["job"]["key"]["name"], poll_secs)
        return self.model(job["dest"]["name"])

    def _poll(self, job_key: str, poll_secs: float = 0.2) -> dict:
        while True:
            job = self.request("GET", f"/3/Jobs/{job_key}")["jobs"][0]
            if job["status"] in ("DONE", "FAILED", "CANCELLED"):
                if job["status"] == "FAILED":
                    raise RuntimeError(f"job failed: {job.get('exception')}")
                return job
            time.sleep(poll_secs)

    def model(self, key: str) -> dict:
        return self.request("GET", f"/3/Models/{key}")["models"][0]

    def models(self) -> list[dict]:
        return self.request("GET", "/3/Models")["models"]

    def predict(self, model_key: str, frame_key: str) -> str:
        out = self.request("POST",
                           f"/3/Predictions/models/{model_key}/frames/{frame_key}")
        return out["predictions_frame"]["name"]

    def score(self, model_key: str, rows: list, columns: list | None = None,
              priority: int | None = None,
              slo_ms: float | None = None) -> dict:
        """Request-sized scoring through the batched serving tier
        (``POST /3/Score/{model}``): ``rows`` is a list of dicts (column-
        keyed) or a list of lists ordered by ``columns``. ``priority``
        (0-9, default 5) orders shedding under overload — low priority is
        turned away first with 503+Retry-After; ``slo_ms`` overrides the
        model's latency target at admit. Returns the ScoreV3 payload —
        ``predictions`` column lists plus the batch shape this request
        rode in (docs/SERVING.md)."""
        d: dict = {"rows": rows}
        if columns:
            d["columns"] = list(columns)
        if priority is not None:
            d["priority"] = int(priority)
        if slo_ms is not None:
            d["slo_ms"] = float(slo_ms)
        return self.request("POST", f"/3/Score/{model_key}", d)

    def serving(self) -> dict:
        """Scoring-tier state (``GET /3/Score``): residency +
        compiled-scorer cache counters, per-model SLO controller state,
        shed accounting by reason/priority, and the replica-pool view."""
        return self.request("GET", "/3/Score")

    def serving_evict(self, model_key: str) -> bool:
        """Drop a model's scoring residency (``DELETE /3/Score/{model}``);
        its DKV copy stays — the next score re-admits it."""
        return bool(self.request("DELETE",
                                 f"/3/Score/{model_key}").get("evicted"))

    def rapids(self, ast: str, id: str | None = None) -> dict:
        d = {"ast": ast}
        if id:
            d["id"] = id
        return self.request("POST", "/99/Rapids", d)

    def grid(self, algo: str, training_frame: str, y: str,
             hyper_parameters: dict, search_criteria: dict | None = None,
             **params) -> dict:
        d = {"training_frame": training_frame, "response_column": y,
             "hyper_parameters": hyper_parameters, **params}
        if search_criteria:
            d["search_criteria"] = search_criteria
        out = self.request("POST", f"/99/Grid/{algo}", d)
        job = self._poll(out["job"]["key"]["name"])
        return self.request("GET", f"/99/Grids/{job['dest']['name']}")

    # -- the parity surface ----------------------------------------------------

    def parse_setup(self, source_frames: list[str]) -> dict:
        return self.request("POST", "/3/ParseSetup",
                            {"source_frames": source_frames})

    def split_frame(self, frame_key: str, ratios: list[float],
                    destination_frames: list[str] | None = None) -> list[str]:
        d = {"dataset": frame_key, "ratios": ratios}
        if destination_frames:
            d["destination_frames"] = destination_frames
        out = self.request("POST", "/3/SplitFrame", d)
        self._poll(out["key"]["name"])
        return [f["name"] for f in out["destination_frames"]]

    def model_metrics(self, model_key: str, frame_key: str) -> dict:
        out = self.request(
            "POST", f"/3/ModelMetrics/models/{model_key}/frames/{frame_key}")
        return out["model_metrics"][0]

    def partial_dependence(self, model_key: str, frame_key: str,
                           cols: list[str], nbins: int = 20) -> list[dict]:
        out = self.request("POST", "/3/PartialDependence/",
                           {"model_id": model_key, "frame_id": frame_key,
                            "cols": cols, "nbins": nbins})
        self._poll(out["key"]["name"])
        got = self.request("GET",
                           f"/3/PartialDependence/{out['destination_key']}")
        return got["partial_dependence_data"]

    def quantiles(self, frame_key: str, column: str,
                  probs: list[float] = (0.25, 0.5, 0.75)) -> list[float]:
        res = self.rapids(
            f"(quantile (cols {frame_key} \"{column}\") [{' '.join(map(str, probs))}])")
        fr = self.frame(res["key"]["name"])
        qcol = [c for c in fr["columns"] if c["label"] == column][0]
        return qcol["data"]

    def typeahead(self, src: str, limit: int = 100) -> list[str]:
        q = urllib.parse.urlencode({"src": src, "limit": limit})
        return self.request("GET", f"/3/Typeahead/files?{q}")["matches"]

    def save_model(self, model_key: str, directory: str) -> str:
        q = urllib.parse.urlencode({"dir": directory})
        return self.request("GET", f"/99/Models.bin/{model_key}?{q}")["dir"]

    def load_model(self, path: str) -> str:
        out = self.request("POST", "/99/Models.bin/", {"dir": path})
        return out["models"][0]["model_id"]["name"]

    def remove_all(self) -> None:
        self.request("DELETE", "/3/DKV")

    def jobs(self) -> list[dict]:
        return self.request("GET", "/3/Jobs")["jobs"]

    def job(self, job_key: str) -> dict:
        """One job's JobV3 — status/progress plus the reliability surface:
        ``retries`` (dispatch retries the build absorbed),
        ``max_runtime_secs``/``deadline_exceeded`` (deadline budget), and
        ``auto_recoverable``/``auto_recovery_dir`` (crash-resume snapshot
        state; docs/RELIABILITY.md)."""
        return self.request("GET", f"/3/Jobs/{job_key}")["jobs"][0]

    # -- observability (h2o-py: cluster().timeline / get_log; plus metrics) --

    def timeline(self) -> list[dict]:
        """Runtime event ring: dispatches, model fits, faults
        (``GET /3/Timeline``)."""
        return self.request("GET", "/3/Timeline")["events"]

    def logs(self, node: int = 0, name: str = "info") -> str:
        """Formatted server log lines from the LogRing
        (``GET /3/Logs/nodes/{n}/files/{name}``)."""
        return self.request("GET", f"/3/Logs/nodes/{node}/files/{name}")["log"]

    def metrics(self) -> list[dict]:
        """JSON metrics snapshot: flat {name, type, labels, value} rows
        (``GET /3/Metrics``)."""
        return self.request("GET", "/3/Metrics")["metrics"]

    def memory(self, top: int = 10) -> dict:
        """Device/host byte accounting: host RSS, per-device HBM stats,
        DKV bytes by kind + top-N keys (spilled stubs report their on-disk
        bytes under the ``spilled`` kind), watermarks, the leak report,
        and the Cleaner spill view — spill/fault-in/view-drop counters +
        ice_root contents (``GET /3/Memory``; docs/INGEST.md)."""
        return self.request("GET", f"/3/Memory?top={int(top)}")

    def jstack(self) -> list[dict]:
        """All server thread stacks (``GET /3/JStack``; h2o-py:
        ``h2o.cluster().get_status`` → JStack)."""
        return self.request("GET", "/3/JStack")["traces"]

    def profiler(self, depth: int = 5) -> dict:
        """Sampled stack profile: ``{"stacktraces": [...], "counts": [...]}``
        ordered hottest-first (``GET /3/Profiler?depth=N``)."""
        return self.request("GET", f"/3/Profiler?depth={int(depth)}")

    def compute(self) -> dict:
        """The compute observatory (``GET /3/Compute``): per-site compiled
        signatures, compile seconds, cost_analysis FLOPs/bytes, recompile
        events with signature diffs, and per-loop achieved FLOP/s +
        utilization-or-null (docs/OBSERVABILITY.md "Compute")."""
        return self.request("GET", "/3/Compute")

    def profiler_capture(self, duration_ms: int = 500) -> dict:
        """Open a bounded device-profiler window
        (``POST /3/Profiler/capture``) and return the capture record;
        fetch the Perfetto artifact with :meth:`profiler_download`. A
        concurrent capture raises (the server replies a structured 409)."""
        return self.request("POST",
                            f"/3/Profiler/capture?duration_ms="
                            f"{int(duration_ms)}")

    def profiler_captures(self) -> list[dict]:
        """Capture registry (``GET /3/Profiler/captures``)."""
        return self.request("GET", "/3/Profiler/captures")["captures"]

    def profiler_download(self, capture_id: str, path: str) -> str:
        """Save a capture's gzip Chrome-trace artifact to ``path`` and
        return it — gunzip and load at https://ui.perfetto.dev."""
        url = f"{self.url}/3/Profiler/captures/{capture_id}/download"
        with urllib.request.urlopen(url) as resp:
            data = resp.read()
        with open(path, "wb") as f:
            f.write(data)
        return path

    def timeseries(self, name: str | None = None,
                   labels: dict | None = None,
                   since: float | None = None) -> dict:
        """The flight recorder's retained series
        (``GET /3/TimeSeries``): per series the raw ``[t, value]`` tail
        and the min/max/mean/last rollup windows, plus recorder stats.
        ``name`` matches exactly or as a prefix; ``labels`` is a subset
        match; ``since`` is epoch seconds
        (docs/OBSERVABILITY.md "Flight recorder & post-mortems")."""
        q = []
        if name:
            q.append("name=" + urllib.parse.quote(str(name)))
        if labels:
            pairs = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            q.append("labels=" + urllib.parse.quote(pairs))
        if since is not None:
            q.append(f"since={float(since)}")
        path = "/3/TimeSeries" + (("?" + "&".join(q)) if q else "")
        return self.request("GET", path)

    def health(self) -> dict:
        """The ops-plane verdict (``GET /3/Health``): overall +
        per-subsystem healthy/degraded/unhealthy, each finding naming the
        tripping rule, observed value, and threshold
        (docs/OBSERVABILITY.md "Health & incidents")."""
        return self.request("GET", "/3/Health")

    def incidents(self, state: str | None = None) -> list[dict]:
        """Incident-ring summaries, newest first (``GET /3/Incidents``),
        optionally filtered to ``state="open"`` or ``"resolved"``; fetch
        one with :meth:`incident` for its trip-time context."""
        path = "/3/Incidents"
        if state is not None:
            path += f"?state={urllib.parse.quote(str(state))}"
        return self.request("GET", path)["incidents"]

    def ops(self) -> dict:
        """The ops plane in one view (``GET /3/Ops``): remediation policy
        (mode, rule→action map, bounds), the audited action log,
        per-tenant usage, and configured quotas (docs/OPERATIONS.md)."""
        return self.request("GET", "/3/Ops")

    def set_quota(self, tenant: str, qps=None, device_seconds=None,
                  bytes=None) -> dict:   # noqa: A002 — the REST param name
        """Install per-tenant budgets (``POST /3/Ops``): requests/second,
        device-seconds per rolling window, and DKV bytes. Omitted
        dimensions are unlimited; over-quota requests are shed with
        ``429 + Retry-After``."""
        data = {"tenant": tenant}
        if qps is not None:
            data["qps"] = qps
        if device_seconds is not None:
            data["device_seconds"] = device_seconds
        if bytes is not None:
            data["bytes"] = bytes
        return self.request("POST", "/3/Ops", data)["quota"]

    def remove_quota(self, tenant: str) -> bool:
        """Drop a tenant's budgets (``POST /3/Ops`` remove_quota)."""
        return bool(self.request("POST", "/3/Ops",
                                 {"remove_quota": tenant})["removed"])

    def rollback_action(self, action_id: str) -> bool:
        """Undo a recorded remediation action by its id
        (``POST /3/Ops`` rollback); the rollback is itself audited."""
        return bool(self.request("POST", "/3/Ops",
                                 {"rollback": action_id})["rolled_back"])

    def incident(self, incident_id: str) -> dict:
        """One incident with its correlated context — trace ids, log
        tail, memory top-keys, compute rows, observed-value series
        (``GET /3/Incidents/{id}``)."""
        return self.request("GET", f"/3/Incidents/{incident_id}")

    def diagnostics_bundle(self, path: str) -> str:
        """Download the one-call diagnostic bundle — a gzip tar of all
        four pillar snapshots + health verdict + incident ring + logs +
        hardware fingerprint + redacted config (``POST
        /3/Diagnostics/bundle``; the ``h2o logs download`` analog) — to
        ``path`` and return it."""
        req = urllib.request.Request(self.url + "/3/Diagnostics/bundle",
                                     method="POST")
        with urllib.request.urlopen(req) as resp:
            data = resp.read()
        with open(path, "wb") as f:
            f.write(data)
        return path

    def metrics_text(self) -> str:
        """Raw Prometheus/OpenMetrics exposition (``GET /metrics``)."""
        with urllib.request.urlopen(self.url + "/metrics") as resp:
            return resp.read().decode()

    def traces(self) -> list[dict]:
        """Completed-trace summaries, newest first (``GET /3/Traces``)."""
        return self.request("GET", "/3/Traces")["traces"]

    def trace(self, trace_id: str) -> dict:
        """Full span tree + critical path for one trace
        (``GET /3/Traces/{id}``)."""
        return self.request("GET", f"/3/Traces/{trace_id}")

    def trace_export(self, trace_id: str) -> dict:
        """Chrome trace-event JSON for Perfetto / chrome://tracing
        (``GET /3/Traces/{id}/export``); ``json.dump`` it to a file and
        load at https://ui.perfetto.dev."""
        return self.request("GET", f"/3/Traces/{trace_id}/export")

    def ping(self) -> bool:
        return bool(self.request("GET", "/3/Ping").get("healthy"))

    def shutdown(self) -> None:
        self.request("POST", "/3/Shutdown")
