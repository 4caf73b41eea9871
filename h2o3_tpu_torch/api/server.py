"""REST server — the V3 route surface — the port of
``h2o3_tpu/api/server.py``.

Reference: ``water/api/RequestServer.java:24-80`` (route tree; core routes in
``RegisterV3Api.java``, algo routes via ``AlgoAbstractRegister``). Routes
implemented are the ones h2o-py traffics: Cloud, ImportFiles, Parse, Frames,
Models, ModelBuilders, Predictions, Jobs, Rapids, Grid, AutoML, Shutdown.

Training runs on a background thread through the same :class:`Job` the library
path uses (reference: ``Job.start`` → F/J pool), so clients poll ``/3/Jobs``
exactly like against the reference server. The route table is the JAX
package's, path for path; the handlers call the port's modules.

Every request runs under a root span (an incoming W3C ``traceparent``
joins the caller's trace, and the response carries the root's
``traceparent`` back) and is counted per route pattern
(``h2o3_requests_total``, ``h2o3_request_duration_seconds``). With
``ops_plane/`` loaded, a POST to a metered route is admitted against the
``X-H2O3-Tenant``'s quota (429 + ``Retry-After`` over it).
:meth:`H2OServer.start` installs the log ring behind ``/3/Logs``
(``utils/telemetry.py``) and starts the health sweep, the flight recorder,
the black-box watchdog and the remediation engine, as the reference's does.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from h2o3_tpu_torch import __version__
from h2o3_tpu_torch.api import schemas
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.job import Job, JobCancelled
from h2o3_tpu_torch.models.model_base import Model
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils import tracing as _tr
from h2o3_tpu_torch.utils.registry import DKV, LOCKS

_LOG = logging.getLogger("h2o3_tpu_torch")


def _route_label_of(pat: str) -> str:
    """Metric label for a route regex: regex classes become placeholders and
    escaped literals unescape, so ``/3/WaterMeterCpuTicks/\\d+`` labels as
    ``/3/WaterMeterCpuTicks/{n}`` (not the mangled ``.../d+``)."""
    return pat.replace(r"\d+", "{n}").replace("\\", "")


_ALGOS = None


def _algo_registry():
    """algo name → the port's builder class (the reference's table)."""
    global _ALGOS
    if _ALGOS is None:
        from h2o3_tpu_torch.models.aggregator import Aggregator
        from h2o3_tpu_torch.models.coxph import CoxPH
        from h2o3_tpu_torch.models.decision_tree import DecisionTree
        from h2o3_tpu_torch.models.decomposition import GLRM, PCA, SVD
        from h2o3_tpu_torch.models.deeplearning import DeepLearning
        from h2o3_tpu_torch.models.gam import GAM
        from h2o3_tpu_torch.models.gbm import DRF, GBM
        from h2o3_tpu_torch.models.glm import GLM
        from h2o3_tpu_torch.models.grep_algo import Grep
        from h2o3_tpu_torch.models.hglm import HGLM
        from h2o3_tpu_torch.models.infogram import Infogram
        from h2o3_tpu_torch.models.isofor import (ExtendedIsolationForest,
                                                  IsolationForest)
        from h2o3_tpu_torch.models.isotonic import IsotonicRegression
        from h2o3_tpu_torch.models.kmeans import KMeans
        from h2o3_tpu_torch.models.model_selection import (ANOVAGLM,
                                                           ModelSelection)
        from h2o3_tpu_torch.models.naive_bayes import NaiveBayes
        from h2o3_tpu_torch.models.psvm import PSVM
        from h2o3_tpu_torch.models.rulefit import RuleFit
        from h2o3_tpu_torch.models.target_encoder import TargetEncoder
        from h2o3_tpu_torch.models.uplift import UpliftDRF
        from h2o3_tpu_torch.models.word2vec import Word2Vec
        from h2o3_tpu_torch.models.xgboost import XGBoost
        from h2o3_tpu_torch.orchestration.stacked_ensemble import \
            StackedEnsemble
        _ALGOS = {"stackedensemble": StackedEnsemble,
                  "gbm": GBM, "drf": DRF, "glm": GLM, "deeplearning": DeepLearning,
                  "xgboost": XGBoost, "kmeans": KMeans, "pca": PCA, "svd": SVD,
                  "glrm": GLRM, "naivebayes": NaiveBayes, "coxph": CoxPH,
                  "isolationforest": IsolationForest,
                  "extendedisolationforest": ExtendedIsolationForest,
                  "isotonicregression": IsotonicRegression,
                  "word2vec": Word2Vec, "targetencoder": TargetEncoder,
                  "rulefit": RuleFit, "decisiontree": DecisionTree,
                  "aggregator": Aggregator, "grep": Grep, "gam": GAM,
                  "modelselection": ModelSelection, "anovaglm": ANOVAGLM,
                  "upliftdrf": UpliftDRF, "psvm": PSVM, "infogram": Infogram,
                  "hglm": HGLM}
    return _ALGOS


def _name(x):
    """Unwrap h2o-py's KeyV3 payloads: {"name": k} → k."""
    return x.get("name") if isinstance(x, dict) else x


def _parse_list(v: str) -> list:
    """Bracketed list payload: JSON first, else h2o-py's unquoted
    ``stringify_list`` format ``[a,b,c]``."""
    try:
        out = json.loads(v)
        return out if isinstance(out, list) else [out]
    except (json.JSONDecodeError, ValueError):
        return [s.strip().strip('"') for s in v.strip("[]").split(",")
                if s.strip()]


class PayloadTooLarge(ValueError):
    """Raised for oversized request bodies; routed to HTTP 413."""


def _job(description: str) -> Job:
    """A Job registered in the DKV under its key, so ``/3/Jobs`` serves it
    (the reference's Job registers itself; the port's library Job does
    not, so the REST layer does it for the jobs it hands out)."""
    job = Job(description, key=f"job_{uuid.uuid4().hex[:12]}")
    DKV.put(job.key, job)
    return job


def _done_job(description: str, dest_key: str | None = None) -> dict:
    """A completed, DKV-registered job serialized as JobV3 — synchronous
    routes still hand h2o-py's H2OJob wrapper a pollable job payload."""
    job = _job(description)
    if dest_key:
        job.dest_key = dest_key
    job.run(lambda j: dest_key, background=False)
    return schemas.job_v3(job.key, job)


class _Handler(BaseHTTPRequestHandler):
    server_version = f"h2o3_tpu_torch/{__version__}"

    # -- plumbing ------------------------------------------------------------

    def log_message(self, *a):   # route logs to our logger, not stderr
        pass

    def send_response(self, code, message=None):
        self._last_status = code
        super().send_response(code, message)
        span = getattr(self, "_trace_span", None)
        if span is not None:
            self.send_header("traceparent",
                             _tr.format_traceparent(span.context))

    def _reply(self, obj, code: int = 200):
        meta = obj.get("__meta") if isinstance(obj, dict) else None
        if isinstance(meta, dict) and "schema_name" not in meta:
            # h2o-py's response hook requires __meta.schema_name on every
            # payload (h2o-py/h2o/backend/connection.py H2OResponse)
            meta.setdefault("schema_name", meta.get("schema_type", "IcedV3"))
            meta.setdefault("schema_version", 3)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (getattr(self, "_extra_headers", None) or {}).items():
            self.send_header(k, v)     # e.g. Retry-After on a 503
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str, headers: dict | None = None):
        import time as _t
        if code >= 500:   # server faults land in the log ring (/3/Logs)
            _LOG.warning("HTTP %d on %s: %s", code, self.path, msg)
        self._extra_headers = headers
        try:
            self._reply({"__meta": {"schema_type": "H2OErrorV3"},
                         "http_status": code, "msg": msg,
                         "exception_msg": msg,
                         "timestamp": int(_t.time() * 1000),
                         "error_url": self.path, "dev_msg": msg,
                         "exception_type": "java.lang.RuntimeException",
                         "values": {}, "stacktrace": []}, code)
        finally:
            self._extra_headers = None

    #: non-upload request bodies are parameter payloads; cap them (the
    #: reference relies on Jetty's request limits). File content goes
    #: through /3/PostFile, which has its own 1GiB cap.
    MAX_PARAM_BODY = 64 << 20

    def _drain_body(self, length: int) -> None:
        """Read and discard an oversized body: replying mid-upload breaks
        the pipe on the client side instead of delivering the error."""
        left = length
        while left > 0:
            chunk = self.rfile.read(min(left, 1 << 20))
            if not chunk:
                break
            left -= len(chunk)

    def _params(self) -> dict:
        q = urllib.parse.urlparse(self.path).query
        out = {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.MAX_PARAM_BODY:
            self._drain_body(length)
            raise PayloadTooLarge(
                f"request body of {length} bytes exceeds the "
                f"{self.MAX_PARAM_BODY >> 20}MiB parameter cap "
                "(use /3/PostFile for data uploads)")
        if length:
            body = self.rfile.read(length).decode()
            ctype = self.headers.get("Content-Type", "")
            if "json" in ctype:
                out.update(json.loads(body))
            else:
                out.update({k: v[0] for k, v in urllib.parse.parse_qs(body).items()})
        return out

    # -- dispatch ------------------------------------------------------------

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def do_HEAD(self):
        # same auth gate as every other method (HEAD must not leak liveness
        # past the login check)
        if not self._check_auth():
            return
        self.send_response(200)
        self.end_headers()

    def _session_token(self) -> str | None:
        cookie = self.headers.get("Cookie") or ""
        for part in cookie.split(";"):
            k, _, v = part.strip().partition("=")
            if k == "h2o3_session":
                return v
        return None

    def _check_auth(self) -> bool:
        """Credential gate (reference: ``water/H2O.java:242-266`` hash/LDAP
        login + ``water/webserver`` form auth): a valid form-login session
        cookie OR Basic credentials accepted by the server's pluggable
        authenticator. Replies 401 and returns False on failure."""
        authfn = getattr(self.server, "_authenticate", None)
        if authfn is None:
            return True
        tok = self._session_token()
        sessions = getattr(self.server, "_login_sessions", {})
        exp = sessions.get(tok) if tok else None
        if exp is not None:
            import time as _t
            if _t.time() < exp:
                return True
            sessions.pop(tok, None)    # expired (tolerant: handler threads race)
        hdr = self.headers.get("Authorization") or ""
        if hdr.startswith("Basic "):
            import base64
            try:
                user, _, pw = base64.b64decode(
                    hdr[6:]).decode("utf-8", "replace").partition(":")
            except Exception:
                user = pw = None
            if user is not None and authfn(user, pw):
                return True
        self.send_response(401)
        self.send_header("WWW-Authenticate", "Basic realm=h2o3_tpu_torch")
        self.send_header("Content-Length", "0")
        self.end_headers()
        return False

    def r_login_page(self):
        """Minimal form-login page (reference: ``login.html`` served by the
        reference's Jetty when form auth is on)."""
        body = (b"<html><body><form method='POST' action='/login'>"
                b"<input name='username' placeholder='username'/>"
                b"<input name='password' type='password'/>"
                b"<button type='submit'>Log in</button></form></body></html>")
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_login(self):
        """Form login → session cookie (reference: j_security_check)."""
        p = self._params()
        authfn = getattr(self.server, "_authenticate", None)
        if authfn is not None and not authfn(str(p.get("username") or ""),
                                             str(p.get("password") or "")):
            self._error(401, "invalid credentials")
            return
        import time as _t
        sessions = self.server._login_sessions
        now = _t.time()
        # snapshot before sweeping: handler threads mutate concurrently
        for k in [k for k, exp in list(sessions.items()) if exp < now]:
            sessions.pop(k, None)
        if len(sessions) >= 10_000:    # cap: a login-per-request client
            sessions.clear()           # must fall back to re-auth, not OOM us
        tok = uuid.uuid4().hex
        sessions[tok] = now + self.server._session_ttl
        body = b'{"status": "ok"}'
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Set-Cookie",
                         f"h2o3_session={tok}; HttpOnly; Path=/")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_logout(self):
        tok = self._session_token()
        self.server._login_sessions.pop(tok, None)
        self._reply({"__meta": {"schema_type": "LogoutV3"}, "status": "ok"})

    #: paths reachable without credentials (the login flow itself)
    _AUTH_EXEMPT = {"/login", "/logout"}

    #: high-frequency read endpoints whose solo traces would churn the
    #: completed-trace ring (h2o-py polls /3/Jobs ~2×/s during builds,
    #: Prometheus scrapes /metrics, Flow refreshes /): their root spans
    #: still propagate context and return a traceparent, but the finished
    #: trace is discarded — unless the caller sent a traceparent, which is
    #: an explicit request to record the call in the caller's trace
    _TRACE_NOISE = re.compile(
        r"/(?:flow/.*|metrics|3/(?:Jobs(?:/[^/]+)?|Ping|Cloud|About|"
        r"Logs(?:/.*)?|Memory|Metrics|TimeSeries|Compute|Score|Timeline|"
        r"JStack|"
        r"WaterMeter[^/]*(?:/\d+)?|Health|Incidents(?:/[^/]+)?|Ops|"
        r"Traces(?:/.*)?)|99/(?:AutoML|Leaderboards)/[^/]+)?")

    #: endpoints that do real work — the ones tenant quotas meter
    #: (monitoring GETs and session plumbing are never shed: an operator
    #: must be able to LOOK at an over-quota tenant's usage)
    _METERED = re.compile(
        r"/3/(?:Score/[^/]+|Parse|PostFile(?:\.bin)?|"
        r"Predictions/models/[^/]+/frames/[^/]+)|"
        r"/4/Predictions/models/[^/]+/frames/[^/]+|"
        r"/(?:3|99)/ModelBuilders/[^/]+")

    def _route(self, method: str):
        path = urllib.parse.urlparse(self.path).path
        t0 = time.perf_counter()
        self._last_status = 0
        self._route_label = None
        # root span per request; an incoming W3C traceparent joins the
        # caller's trace (and its span becomes our root's parent)
        parent = _tr.parse_traceparent(self.headers.get("traceparent"))
        ephemeral = (parent is None and method == "GET"
                     and re.fullmatch(self._TRACE_NOISE, path) is not None)
        with _tr.TRACER.span(f"{method} {path}", kind="server", root=True,
                             parent=parent, ephemeral=ephemeral,
                             attrs={"method": method}) as span:
            self._trace_span = span
            try:
                self._dispatch(method, path)
            finally:
                # per-route request count/status/latency — labelled by ROUTE
                # PATTERN (bounded cardinality), never by the raw path
                route = self._route_label or "(unmatched)"
                if span is not None:
                    # rename to the matched pattern so trace listings stay
                    # readable; raw path survives as an attr for debugging
                    if self._route_label:
                        span.set_attrs(path=path)
                        span.name = f"{method} {self._route_label}"
                    span.set_attrs(http_status=self._last_status)
                    if self._last_status >= 500:
                        span.set_status("error")
                    if parent is None and route in ("(unmatched)",
                                                    "(unauthorized)"):
                        # only known-after-routing noise: a scanner hitting
                        # unknown paths (or failing auth) must not churn
                        # the completed-trace ring either
                        _tr.TRACER.make_ephemeral(span.trace_id)
                _tm.REQUESTS.labels(route=route, method=method,
                                    status=str(self._last_status)).inc()
                _tm.REQUEST_SECONDS.labels(
                    route=route, method=method).observe(
                    time.perf_counter() - t0)

    def _dispatch(self, method: str, path: str):
        if path not in self._AUTH_EXEMPT and not self._check_auth():
            self._route_label = "(unauthorized)"
            return
        try:
            import sys as _sys
            ten = _sys.modules.get("h2o3_tpu_torch.ops_plane.tenancy")
            if ten is None:
                # multi-tenancy not loaded (embedded/library use): zero
                # overhead, exactly the pre-ops-plane dispatch
                self._run_routes(method, path)
                return
            raw = self.headers.get("X-H2O3-Tenant")
            if raw is None:
                q = urllib.parse.urlparse(self.path).query
                raw = {k: v[0] for k, v in
                       urllib.parse.parse_qs(q).items()}.get("tenant")
            try:
                tenant = ten.sanitize_tenant(raw)
            except ValueError as e:
                self._error(400, str(e))
                return
            with ten.tenant_scope(tenant):
                if method == "POST" \
                        and re.fullmatch(self._METERED, path) is not None:
                    try:
                        ten.QUOTAS.admit(tenant)
                    except ten.QuotaExceeded as e:
                        # over-quota is 429 + Retry-After — shed loudly,
                        # never dropped (reference: the 503 shed contract
                        # of r_score, but quota is the CALLER'S budget,
                        # not the server's capacity)
                        retry_s = max(int(e.retry_after_s + 0.999), 1)
                        self._error(429, str(e), headers={
                            "Retry-After": str(retry_s),
                            "X-Retry-After-Ms":
                                str(int(e.retry_after_s * 1000))})
                        return
                self._run_routes(method, path)
        except PayloadTooLarge as e:
            self._error(413, str(e))
        except KeyError as e:
            self._error(404, str(e))
        except Exception as e:   # one bad request must not kill the server
            self._error(500, f"{type(e).__name__}: {e}")

    def _run_routes(self, method: str, path: str):
        for pat, m, fn in _ROUTES:
            match = re.fullmatch(pat, path)
            if match and m == method:
                self._route_label = _route_label_of(pat)
                fn(self, *match.groups())
                return
        # extension-contributed routes (reference RestApiExtension SPI)
        from h2o3_tpu_torch.utils import extensions as _ext
        for pat, m, fn in _ext.rest_routes():
            match = re.fullmatch(pat, path)
            if match and m == method:
                self._route_label = _route_label_of(pat)
                fn(self, *match.groups())
                return
        self._error(404, f"no route for {method} {path}")

    # -- routes (reference: RequestServer route registrations) ---------------

    def r_cloud(self):
        self._reply(schemas.cloud_v3(__version__))

    def r_about(self):
        self._reply({"__meta": {"schema_type": "AboutV3"},
                     "entries": [{"name": "Build version", "value": __version__}]})

    def r_import(self):
        p = self._params()
        from h2o3_tpu_torch.frame.parse import import_file
        try:
            fr = import_file(p["path"], key=p.get("destination_frame"))
        except (FileNotFoundError, PermissionError, IsADirectoryError,
                ValueError) as e:
            # a bad path is CLIENT error, not a server fault: a structured
            # 400 whose msg carries the reason (the reference reports these
            # as ImportFiles `fails`, never a 500 traceback)
            self._error(400, str(e))
            return
        self._reply({"__meta": {"schema_type": "ImportFilesV3"},
                     "destination_frames": [fr.key], "fails": []})

    def r_import_multi(self):
        """Reference ImportFilesMulti: h2o-py sends paths as "[p1,p2]"."""
        p = self._params()
        paths = p.get("paths", "")
        if isinstance(paths, str):
            paths = _parse_list(paths)
        from h2o3_tpu_torch.frame.parse import import_file
        keys, fails = [], []
        for path in paths:
            try:
                keys.append(import_file(path).key)
            except Exception as e:     # noqa: BLE001 — report per-file fails
                fails.append(f"{path}: {e}")
        self._reply({"__meta": {"schema_type": "ImportFilesV3"},
                     "destination_frames": keys, "fails": fails})

    def _read_upload(self) -> "tuple[bytes, str] | None":
        """Read a (possibly multipart) uploaded body; None = too large
        (the 413 is already sent). Returns (file bytes, filename)."""
        import os
        length = int(self.headers.get("Content-Length") or 0)
        if length > 1 << 30:
            self._drain_body(length)
            self._error(413, f"upload of {length} bytes exceeds the 1GiB cap")
            return None
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        data, fname = body, "upload.csv"
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if m:
            for part in body.split(b"--" + m.group(1).encode()):
                if b"\r\n\r\n" not in part:
                    continue
                hdrs, content = part.split(b"\r\n\r\n", 1)
                if b"filename=" not in hdrs:
                    continue
                fm = re.search(rb'filename="?([^";\r\n]+)"?', hdrs)
                if fm:
                    fname = os.path.basename(fm.group(1).decode("utf-8",
                                                                "replace"))
                data = content[:-2] if content.endswith(b"\r\n") else content
                break
        return data, fname

    def r_putkey(self):
        """Reference PutKeyHandler: store raw uploaded bytes under a DKV key
        (h2o-py ``_put_key`` — the transport for custom metric/distribution
        UDF zips, ``h2o.py:2073``)."""
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        dest = (q.get("destination_key") or [None])[0]
        overwrite = (q.get("overwrite") or ["True"])[0].lower() != "false"
        up = self._read_upload()
        if up is None:
            return
        data, fname = up
        key = dest or f"{fname.replace('.', '_')}_{uuid.uuid4().hex[:8]}"
        if not overwrite and DKV.get(key) is not None:
            self._error(400, f"key {key!r} already exists and overwrite=False")
            return
        from h2o3_tpu_torch.frame.parse import RawFile
        DKV.put(key, RawFile(data, name=fname))
        self._reply({"__meta": {"schema_type": "PutKeyV3"},
                     "destination_key": key})

    def r_postfile(self):
        """Reference PostFileHandler (``water/api/PostFileHandler.java``,
        used by ``h2o.upload_file``): store the multipart body's file part as
        a raw key for ParseSetup/Parse. Uploads are size-capped (the
        reference relies on Jetty limits)."""
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        dest = (q.get("destination_frame") or [None])[0]
        up = self._read_upload()
        if up is None:
            return
        data, fname = up
        from h2o3_tpu_torch.frame.parse import RawFile
        key = dest or f"{fname.replace('.', '_')}_{uuid.uuid4().hex[:8]}"
        DKV.put(key, RawFile(data, name=fname))
        self._reply({"__meta": {"schema_type": "PostFileV3"},
                     "destination_frame": key, "total_bytes": len(data)})

    def r_parse(self):
        # the reference splits guess (ParseSetup) and parse; import_file did
        # both, so Parse re-keys the already-parsed frame and hands back an
        # immediately-DONE job for the client's poll loop
        p = self._params()
        src = json.loads(p["source_frames"]) if isinstance(
            p.get("source_frames"), str) else p.get("source_frames", [])
        src_key = (src[0] if src else p.get("source_key", ""))
        src_key = _name(src_key)
        from h2o3_tpu_torch.frame.parse import RawFile
        fr = DKV[src_key]
        if isinstance(fr, RawFile):
            fr = fr.frame()
        dest = _name(p.get("destination_frame")) or src_key
        if dest != src_key:
            DKV.remove(src_key)
        fr.key = dest
        DKV.put(dest, fr)
        job = _job("Parse")
        job.run(lambda j: setattr(j, "dest_key", dest) or dest,
                background=False)
        self._reply({"__meta": {"schema_type": "ParseV3"},
                     "destination_frame": {"name": dest},
                     "job": schemas.job_v3(job.key, job),
                     "rows": fr.nrows})

    def r_frames(self):
        self._reply(schemas.frames_list_v3(DKV))

    def r_frame(self, key):
        fr = DKV[key]
        from h2o3_tpu_torch.frame.parse import RawFile
        if isinstance(fr, RawFile):
            # a /3/PostFile upload fetched as a frame (h2o.upload_mojo does
            # get_frame on the raw key before handing it to generic)
            self._reply(schemas.raw_frame_v3(key, len(fr.data)))
            return
        if not isinstance(fr, Frame):
            raise KeyError(f"{key} is not a frame")
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "frames": [schemas.frame_v3(key, fr)]})

    def r_frame_delete(self, key):
        with LOCKS.write(key):
            DKV.remove(key)
        self._reply({"__meta": {"schema_type": "FramesV3"}})

    def r_models(self):
        self._reply(schemas.models_list_v3(DKV))

    def r_model(self, key):
        m = DKV[key]
        if not isinstance(m, Model):
            raise KeyError(f"{key} is not a model")
        self._reply({"__meta": {"schema_type": "ModelsV3"},
                     "models": [schemas.model_v3(m)]})

    def r_model_delete(self, key):
        with LOCKS.write(key):
            DKV.remove(key)
        self._reply({"__meta": {"schema_type": "ModelsV3"}})

    def r_train(self, algo):
        p = self._params()
        if algo.lower() == "generic":
            # h2o.import_mojo / upload_mojo: no training_frame; the artifact
            # arrives as a server path or an uploaded RawFile key
            # (H2OGenericEstimator.from_file / h2o.upload_mojo)
            return self._train_generic(p)
        cls = _algo_registry().get(algo.lower())
        if cls is None:
            raise KeyError(f"unknown algorithm {algo!r}")
        train_key = p.pop("training_frame")
        frame = DKV[train_key]
        y = p.pop("response_column", None)
        x = p.pop("x", None)
        if isinstance(x, str):
            x = json.loads(x)
        valid = p.pop("validation_frame", None)
        vframe = DKV[valid] if valid else None
        kwargs = {}
        defaults = cls.defaults()
        for k, v in p.items():
            if k not in defaults:
                continue
            d = defaults[k]
            if isinstance(v, str):
                if isinstance(d, bool):
                    v = v.lower() in ("1", "true", "yes")
                elif isinstance(d, int) and not isinstance(d, bool):
                    v = int(float(v))
                elif isinstance(d, float):
                    v = float(v)
                elif isinstance(d, (list, tuple)) or v.startswith("["):
                    v = _parse_list(v)
                elif k == "metalearner_params" and v.startswith("{"):
                    v = json.loads(v)
            kwargs[k] = v
        if algo.lower() == "stackedensemble":
            # base_models arrive as ids (h2o-py _keyify; possibly _quoted or
            # KeyV3 dicts) — resolve to the DKV-registered Model objects
            kwargs["base_models"] = [
                DKV[str(_name(b)).strip('"')]
                for b in (kwargs.get("base_models") or [])]
        try:
            builder = cls(**kwargs)
            builder.validate_request()
        except ValueError as e:
            # a request the build could NEVER satisfy (unknown params, an
            # unsupported checkpoint combination) is a client error — a
            # structured 400 now, not a FAILED job the poller unwraps later
            return self._error(400, str(e))
        self._run_build_job(
            algo.lower(), builder, p.get("model_id"),
            lambda: builder.train(x=x, y=y, training_frame=frame,
                                  validation_frame=vframe),
            frame_keys=(train_key, valid))

    def _run_build_job(self, algo: str, builder, model_id, train_fn,
                       cleanup=None, frame_keys=()) -> None:
        """The shared train-job protocol every builder endpoint speaks:
        pre-assigned model key (h2o-py's H2OJob reads dest.name from the
        INITIAL response, before the background train finishes), background
        Job, ModelBuildersV3 reply.  Lockable protocol (water/Lockable.java):
        the build write-locks its destination model key and read-locks its
        input frames, so a concurrent DELETE waits instead of racing."""
        builder.model_id = model_id or f"{algo}_{uuid.uuid4().hex[:10]}"
        job = _job(f"{algo} via REST")
        job.dest_key = builder.model_id
        # mirror the builder's reliability contract onto the REST job so
        # /3/Jobs pollers see the deadline/recovery surface from the first
        # poll (the inner library Job enforces; this one reports)
        params = getattr(builder, "params", {})
        job.max_runtime_secs = float(params.get("max_runtime_secs") or 0.0)
        # only advertised when the builder actually writes snapshots
        # (supports_auto_recovery) — the inner job applies the same gate
        job.auto_recovery_dir = (
            params.get("auto_recovery_dir")
            if getattr(builder, "supports_auto_recovery", lambda: False)()
            else None)

        # forward /3/Jobs/{id}/cancel into the INNER library job the build
        # loops actually poll — without this a REST cancel only flips the
        # outer job's flag and the build runs to completion anyway
        _outer_cancel = job.cancel

        def _cancel_both():
            _outer_cancel()
            # flag FIRST, then try the inner job: train() re-checks the flag
            # right after creating its Job, so a cancel landing in the
            # window before builder.job exists is still honored (the
            # orderings make losing both impossible)
            builder._cancel_requested_early = True
            inner = getattr(builder, "job", None)
            if inner is not None:
                inner.cancel()
        job.cancel = _cancel_both

        def run_job(j: Job):
            def mirror_inner_cancel():
                # the build terminated on its deadline/cancel — the REST
                # job must read CANCELLED (not DONE) and carry the deadline
                # evidence, whether train() returned a partial model or
                # raised JobCancelled (builders that keep no partial model)
                inner = getattr(builder, "job", None)
                if inner is None or inner.status != Job.CANCELLED:
                    return
                j.keep_partial()
                if inner.deadline_exceeded:
                    # one locked transition: a poller must never observe
                    # the flag without its progress_msg
                    with j._lock:
                        j.deadline_exceeded = True
                        j.progress_msg = inner.progress_msg
                j.cancel()

            # one combined acquisition — two separate with-statements would
            # reintroduce the ABBA deadlock the global sort order prevents
            with LOCKS.locked(write=(builder.model_id,), read=frame_keys):
                # re-check under the lock: a delete may have won the race
                # between the handler's fetch and this acquisition
                for fk in frame_keys:
                    if fk and fk not in DKV:
                        raise KeyError(f"{fk} not found")
                try:
                    m = train_fn()
                except BaseException:
                    mirror_inner_cancel()
                    raise
                finally:
                    if cleanup is not None:
                        cleanup()
            mirror_inner_cancel()
            if m is None:
                # a cancelled build that keeps no partial model
                raise JobCancelled(j.key)
            j.dest_key = m.key
            return m

        job.run(run_job, background=True)
        self._reply({"__meta": {"schema_type": "ModelBuildersV3"},
                     "job": schemas.job_v3(job.key, job),
                     "messages": [], "error_count": 0,
                     "parameters": [], "algo": algo})

    def _train_generic(self, p: dict):
        """POST /3/ModelBuilders/generic (reference hex/generic/Generic.java):
        wrap a MOJO artifact — ``path`` on the server filesystem, or
        ``model_key`` naming a /3/PostFile RawFile upload — as a model."""
        import os
        import tempfile

        from h2o3_tpu_torch.genmodel.generic import Generic

        path = p.get("path")
        model_key = _name(p.get("model_key"))
        tmp = None
        if not path and model_key:
            raw = DKV[str(model_key).strip('"')]
            data = getattr(raw, "data", raw)
            if not isinstance(data, (bytes, bytearray)):
                raise TypeError(f"model_key {model_key!r} does not hold an "
                                "uploaded artifact")
            fd, tmp = tempfile.mkstemp(suffix=".zip")
            with os.fdopen(fd, "wb") as f:
                f.write(bytes(data))
            path = tmp
        if not path:
            raise ValueError("generic needs 'path' or 'model_key'")
        builder = Generic(path=path)
        self._run_build_job(
            "generic", builder, p.get("model_id"), builder.train,
            cleanup=(lambda: os.unlink(tmp)) if tmp is not None else None)

    def r_job(self, key):
        job = DKV[key]
        self._reply({"__meta": {"schema_type": "JobsV3"},
                     "jobs": [schemas.job_v3(key, job)]})

    def r_job_cancel(self, key):
        DKV[key].cancel()
        self._reply({"__meta": {"schema_type": "JobsV3"}})

    def r_predict(self, model_key, frame_key):
        # fetch under the read lock (a delete that already won must 404),
        # but SCORE outside it: scoring is read-only over refs this thread
        # now holds, and keeping the lock would serialize concurrent
        # predictions against the same model for no protection in return
        with LOCKS.read(model_key, frame_key):
            m, fr = DKV[model_key], DKV[frame_key]
        pred = m.predict(fr)
        dest = f"prediction_{uuid.uuid4().hex[:8]}"
        pred.key = dest
        DKV.put(dest, pred)
        self._reply({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
                     "predictions_frame": {"name": dest},
                     "model_metrics": []})

    def r_predict_v4(self, model_key, frame_key):
        """V4 surface: h2o-py model.predict POSTs here and polls the job."""
        if model_key not in DKV or frame_key not in DKV:
            raise KeyError(f"{model_key if model_key not in DKV else frame_key}"
                           " not found")
        dest = f"prediction_{uuid.uuid4().hex[:8]}"
        job = _job("Predict")
        job.dest_key = dest

        def run_job(j: Job):
            # fetch INSIDE the lock: a delete that wins the race must 404
            # this job, not be resurrected by a stale reference. The predict
            # itself runs OUTSIDE — it is read-only over refs held here, and
            # concurrent predictions must not serialize on the key lock
            with LOCKS.read(model_key, frame_key):
                m, fr = DKV[model_key], DKV[frame_key]
            pred = m.predict(fr)
            pred.key = dest
            DKV.put(dest, pred)
            return pred

        job.run(run_job, background=False)
        self._reply({"__meta": {"schema_type": "JobV4"},
                     "job": schemas.job_v3(job.key, job)})

    # -- scoring tier (serving/) ----------------------------------------------

    def r_score(self, model_key):
        """``POST /3/Score/{model}`` — request-sized scoring: JSON rows in,
        predictions out, no DKV frame round-trip. Concurrent requests for
        one model are fused into one device dispatch by the micro-batcher;
        CUDA graphs are cached per (model, shape, batch-bucket). Over the
        residency budget the reply is 503 + Retry-After, never an OOM."""
        from h2o3_tpu_torch.serving import (SCORING, NotServable,
                                            ServiceUnavailable)
        p = self._params()
        try:
            rows = p.get("rows")
            if isinstance(rows, str):
                rows = json.loads(rows)
            columns = p.get("columns")
            if isinstance(columns, str):
                columns = _parse_list(columns)
        except (json.JSONDecodeError, ValueError) as e:
            self._error(400, f"rows is not valid JSON: {e}")
            return
        try:
            # SLO layer: priority
            # orders shedding under overload; slo_ms overrides the
            # model's latency target at admit — their coercion errors
            # must name the FIELD, not blame the rows payload
            priority = p.get("priority")
            if priority is not None:
                priority = int(priority)
            slo_ms = p.get("slo_ms")
            if slo_ms is not None:
                slo_ms = float(slo_ms)
        except (ValueError, TypeError) as e:
            self._error(400, f"priority/slo_ms is not numeric: {e}")
            return
        try:
            out = SCORING.score(model_key, rows, columns,
                                priority=priority, slo_ms=slo_ms)
        except ServiceUnavailable as e:
            retry_s = max(1, int(round(e.retry_after_ms / 1000.0)))
            self._error(503, str(e), headers={
                "Retry-After": str(retry_s),
                "X-Retry-After-Ms": str(e.retry_after_ms)})
            return
        except (NotServable, ValueError) as e:
            self._error(400, str(e))
            return
        self._reply(schemas.score_v3(out))

    def r_score_stats(self):
        """``GET /3/Score`` — scoring-tier residency and cache counters:
        resident models (bytes/requests/idle + per-model SLO controller
        state), budget, evictions, captured-graph hit/miss counts and
        modes, shed accounting by reason/priority, the replica-pool view
        (stream leases, per-replica busy/queue-wait, scale events), and
        memory watermarks."""
        from h2o3_tpu_torch.serving import SCORING
        self._reply(schemas.serving_v3(SCORING.stats()))

    def r_score_evict(self, model_key):
        """``DELETE /3/Score/{model}`` — drop a model's scoring residency
        (captured graphs + batcher); its DKV copy is untouched."""
        from h2o3_tpu_torch.serving import SCORING, ServiceUnavailable
        try:
            evicted = SCORING.evict(model_key)
        except ServiceUnavailable as e:
            self._error(503, str(e), headers={"Retry-After": "1"})
            return
        self._reply({"__meta": {"schema_type": "ScoreV3"},
                     "evicted": bool(evicted), "model": model_key})

    def r_rapids(self):
        p = self._params()
        from h2o3_tpu_torch.rapids import rapids
        from h2o3_tpu_torch.rapids.exec import Session
        # temp-frame scope persists across calls within one client session
        # (reference: water/rapids/Session.java keyed by session_id)
        sid = p.get("session_id") or self.server._session_id
        sess = self.server._rapids_sessions.setdefault(sid, Session())
        res = rapids(p["ast"], session=sess)
        if isinstance(res, Frame):
            key = p.get("id") or res.key or f"rapids_{uuid.uuid4().hex[:8]}"
            res.key = key
            DKV.put(key, res)
            self._reply({"__meta": {"schema_type": "RapidsFrameV3"},
                         "key": {"name": key},
                         "num_rows": res.nrows, "num_cols": res.ncols})
        elif isinstance(res, (int, float)):
            self._reply({"__meta": {"schema_type": "RapidsNumberV3"},
                         "scalar": schemas._clean(res)})
        else:
            self._reply({"__meta": {"schema_type": "RapidsStringV3"},
                         "string": str(res)})

    def r_grid(self, algo):
        p = self._params()
        cls = _algo_registry().get(algo.lower())
        if cls is None:
            raise KeyError(f"unknown algorithm {algo!r}")
        from h2o3_tpu_torch.orchestration import GridSearch
        hyper = p.pop("hyper_parameters")
        if isinstance(hyper, str):
            hyper = json.loads(hyper)
        criteria = p.pop("search_criteria", None)
        if isinstance(criteria, str):
            criteria = json.loads(criteria)
        grid_frame_key = p.pop("training_frame")
        frame = DKV[grid_frame_key]
        y = p.pop("response_column", None)
        gs = GridSearch(cls, hyper, grid_id=p.pop("grid_id", None),
                        search_criteria=criteria)
        job = _job(f"grid {algo} via REST")

        def run_job(j: Job):
            with LOCKS.read(grid_frame_key):
                g = gs.train(y=y, training_frame=frame)
            j.dest_key = g.grid_id
            return g

        job.run(run_job, background=True)
        self._reply({"__meta": {"schema_type": "GridSearchV99"},
                     "job": schemas.job_v3(job.key, job)})

    def r_grid_get(self, key):
        g = DKV[key]
        self._reply({"__meta": {"schema_type": "GridSchemaV99"},
                     "grid_id": {"name": g.grid_id},
                     "model_ids": [{"name": k} for k in g.model_ids],
                     "failure_details": [d for _, d in g.failures]})

    def r_automl(self):
        """Reference AutoMLBuilderHandler (``water/automl/api/
        AutoMLBuilderHandler.java``): h2o-py POSTs a JSON body of
        build_control / build_models / input_spec; our own client may send
        the flat form. The run object registers in DKV under the job's
        dest key so ``GET /99/AutoML/{key}`` can serve state mid-run."""
        p = self._params()
        from h2o3_tpu_torch.orchestration import AutoML
        for k in ("build_control", "build_models", "input_spec"):
            if isinstance(p.get(k), str):
                p[k] = json.loads(p[k])
        bc = dict(p.get("build_control") or {})
        bm = dict(p.get("build_models") or {})
        ispec = dict(p.get("input_spec") or {})
        # flat budget fields win when both are present
        crit = dict(bc.get("stopping_criteria") or {})
        crit.update({k: p[k] for k in ("max_models", "max_runtime_secs",
                                       "seed") if k in p})
        frame_key = _name(ispec.get("training_frame") or p["training_frame"])
        frame = DKV[frame_key]
        y = _name(ispec.get("response_column") or p.get("response_column"))
        drop = set(ispec.get("ignored_columns") or [])
        for c in (ispec.get("fold_column"), ispec.get("weights_column")):
            if _name(c):
                drop.add(_name(c))
        x = ([c for c in frame.names if c != y and c not in drop]
             if drop else None)
        sort_metric = ispec.get("sort_metric") or p.get("sort_metric")
        if sort_metric:
            # wire names are uppercase/alias forms; Leaderboard rows key on
            # the lowercase metric attrs (aucpr is stored as pr_auc)
            sort_metric = {"aucpr": "pr_auc", "auto": None}.get(
                sort_metric.lower(), sort_metric.lower())
        project = (bc.get("project_name") or p.get("project_name")
                   or f"AutoML_{uuid.uuid4().hex[:10]}")
        nf = p.get("nfolds", bc.get("nfolds"))
        nfolds = -1 if nf is None else int(nf)
        if nfolds < 0:          # reference AUTO: -1 → 5-fold CV; 0 disables
            nfolds = 5
        seed = crit.get("seed")
        aml = AutoML(max_models=int(crit.get("max_models", 0) or 0),
                     max_runtime_secs=float(crit.get("max_runtime_secs", 0) or 0),
                     nfolds=nfolds,
                     seed=-1 if seed is None else int(seed),
                     sort_metric=sort_metric,
                     exclude_algos=bm.get("exclude_algos") or (),
                     include_algos=bm.get("include_algos"),
                     project_name=project)
        DKV.put(project, aml)
        lb_key = _name(ispec.get("leaderboard_frame"))
        job = _job("AutoML via REST")
        job.dest_key = project

        def run_job(j: Job):
            with LOCKS.read(frame_key, lb_key):
                aml.train(x=x, y=y, training_frame=frame,
                          leaderboard_frame=DKV[lb_key] if lb_key else None)
            j.dest_key = project
            return aml

        job.run(run_job, background=True)
        self._reply({"__meta": {"schema_type": "AutoMLBuilderV99"},
                     "job": schemas.job_v3(job.key, job),
                     "build_control": {"project_name": project},
                     "build_models": bm, "input_spec": ispec})

    def r_automl_get(self, key):
        """Reference AutoMLHandler.fetch (``water/automl/api/
        AutoMLHandler.java``) — the state h2o-py's ``_fetch_state`` reads."""
        from h2o3_tpu_torch.orchestration import AutoML
        aml = DKV[key]
        if not isinstance(aml, AutoML):
            raise KeyError(f"{key} is not an AutoML run")
        self._reply(schemas.automl_v99(aml, job_key=key))

    def r_leaderboards(self, project):
        """Reference LeaderboardsHandler.fetch (``water/automl/api/
        LeaderboardsHandler.java``)."""
        from h2o3_tpu_torch.orchestration import AutoML
        p = self._params()
        aml = DKV[project]
        if not isinstance(aml, AutoML):
            raise KeyError(f"{project} is not an AutoML run")
        ext = p.get("extensions") or []
        if isinstance(ext, str):
            ext = _parse_list(ext)
        self._reply(schemas.leaderboard_v99(aml, ext))

    def r_shutdown(self):
        self._reply({"__meta": {"schema_type": "ShutdownV3"}})
        threading.Thread(target=self.server.shutdown, daemon=True).start()

    def r_gc(self):
        import gc
        gc.collect()
        self._reply({"__meta": {"schema_type": "GarbageCollectV3"}})

    # -- NodePersistentStorage (reference: water/api/NodePersistentStorage
    #    Handler — Flow saves notebooks under category "notebook") ----------

    @staticmethod
    def _nps_name(x: str) -> str:
        """Path-component sanitizer: besides the charset filter, all-dot
        names ('.', '..') must not survive — they'd traverse out of the
        storage root."""
        safe = re.sub(r"[^\w.-]", "_", x).strip(".")
        return safe or "_"

    @classmethod
    def _nps_dir(cls, category: str) -> str:
        import os
        base = os.environ.get(
            "H2O3TPU_NPS_DIR",
            os.path.join(os.path.expanduser("~"), ".h2o3tpu", "nps"))
        d = os.path.join(base, cls._nps_name(category))
        os.makedirs(d, exist_ok=True)
        return d

    def r_nps_list(self, category):
        import os
        d = self._nps_dir(category)
        entries = []
        for name in sorted(os.listdir(d)):
            st = os.stat(os.path.join(d, name))
            entries.append({"name": name, "size": st.st_size,
                            "timestamp_millis": int(st.st_mtime * 1000)})
        self._reply({"__meta": {"schema_type": "NodePersistentStorageV3"},
                     "category": category, "entries": entries})

    def r_nps_get(self, category, name):
        import os
        path = os.path.join(self._nps_dir(category), self._nps_name(name))
        if not os.path.exists(path):
            raise KeyError(f"no {category}/{name} in persistent storage")
        with open(path, "rb") as f:
            body = f.read()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_nps_put(self, category, name):
        import os
        length = int(self.headers.get("Content-Length") or 0)
        if length > 16 << 20:
            self._drain_body(length)
            self._error(413, "notebook exceeds the 16MiB cap")
            return
        data = self.rfile.read(length)
        # h2o-py/Flow POST the value as a multipart or urlencoded field
        ctype = self.headers.get("Content-Type", "")
        if "urlencoded" in ctype:
            vals = urllib.parse.parse_qs(data.decode("utf-8", "replace"))
            data = (vals.get("value") or [""])[0].encode()
        path = os.path.join(self._nps_dir(category), self._nps_name(name))
        with open(path, "wb") as f:
            f.write(data)
        self._reply({"__meta": {"schema_type": "NodePersistentStorageV3"},
                     "category": category, "name": name,
                     "total_bytes": len(data)})

    def r_nps_delete(self, category, name):
        import os
        path = os.path.join(self._nps_dir(category), self._nps_name(name))
        if os.path.exists(path):
            os.unlink(path)
        self._reply({"__meta": {"schema_type": "NodePersistentStorageV3"}})

    def r_flow(self):
        # reference: h2o-web Flow notebook served from the node at /
        from h2o3_tpu_torch.api.flow import FLOW_HTML
        body = FLOW_HTML.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_timeline(self):
        from h2o3_tpu_torch.utils.timeline import TIMELINE
        self._reply({"__meta": {"schema_type": "TimelineV3"},
                     "events": TIMELINE.snapshot()})

    def r_jstack(self):
        from h2o3_tpu_torch.utils.timeline import jstack
        self._reply({"__meta": {"schema_type": "JStackV3"},
                     "traces": jstack()})

    def r_profiler(self):
        # reference: ProfileCollectorTask samples stacks `depth` times,
        # excluding the collector thread itself — a profile dominated by the
        # sampling loop would show no real work
        import time as _t
        from h2o3_tpu_torch.utils.timeline import jstack
        p = self._params()
        samples = max(1, min(int(p.get("depth", 5)), 50))
        me = {threading.get_ident()}
        counts: dict[str, int] = {}
        for _ in range(samples):
            for tr in jstack(exclude=me):
                counts[tr["stack"]] = counts.get(tr["stack"], 0) + 1
            _t.sleep(0.01)
        entries = sorted(counts.items(), key=lambda kv: -kv[1])
        self._reply({"__meta": {"schema_type": "ProfilerV3"},
                     "stacktraces": [s for s, _ in entries],
                     "counts": [c for _, c in entries]})

    def r_cpu_ticks(self):
        from h2o3_tpu_torch.utils.timeline import cpu_ticks
        self._reply({"__meta": {"schema_type": "WaterMeterCpuTicksV3"},
                     "cpu_ticks": cpu_ticks()})

    def r_io_meter(self):
        from h2o3_tpu_torch.utils.timeline import io_stats
        self._reply({"__meta": {"schema_type": "WaterMeterIoV3"},
                     "persist_stats": io_stats()})


    def r_logs(self):
        """``GET /3/Logs[?level=...]`` — the whole LogRing, optionally
        filtered by minimum severity. ``level`` accepts the reference's
        per-level file names (``water/util/Log.java`` writes one file per
        level: trace/debug/info/warn/error/fatal) or a numeric logging
        level; absent = unfiltered (every ring line)."""
        p = self._params()
        level = p.get("level")
        ring = _tm.install_log_ring()
        if level is None:
            self._reply({"__meta": {"schema_type": "LogsV3"},
                         "nodeidx": 0, "name": "unfiltered",
                         "log": "\n".join(ring.lines())})
            return
        min_level = _tm.LOG_FILES.get(str(level).lower())
        if min_level is None:
            try:
                min_level = int(level)
            except ValueError:
                raise KeyError(f"unknown log level {level!r}; one of "
                               f"{sorted(_tm.LOG_FILES)} or a numeric "
                               "logging level") from None
        self._reply({"__meta": {"schema_type": "LogsV3"},
                     "nodeidx": 0, "name": str(level),
                     "log": "\n".join(ring.lines(min_level))})

    def r_logs_file(self, node: str, name: str):
        """Reference: LogsHandler ``/3/Logs/nodes/{n}/files/{name}`` (the
        route h2o-py's ``h2o.cluster().get_log`` requests). Backed by the
        LogRing on the ``h2o3_tpu_torch`` logger; the reference's per-level
        log *files* map to a minimum-level filter over the ring."""
        ring = _tm.install_log_ring()     # idempotent; survives cold fetches
        min_level = _tm.LOG_FILES.get(name.lower())
        if min_level is None:
            raise KeyError(f"unknown log file {name!r}; one of "
                           f"{sorted(_tm.LOG_FILES)}")
        self._reply({"__meta": {"schema_type": "LogsV3"},
                     "nodeidx": int(node),
                     "name": name,
                     "log": "\n".join(ring.lines(min_level))})

    def r_memory(self):
        """``GET /3/Memory[?top=N]`` — device/host byte accounting: host
        RSS + machine totals, per-device HBM stats, DKV bytes by kind with
        the top-N keys, monotonic watermarks, and the leak-detector report
        (:mod:`h2o3_tpu_torch.utils.memory`)."""
        from h2o3_tpu_torch.utils.memory import MEMORY
        p = self._params()
        try:
            top = max(1, min(int(p.get("top", 10)), 1000))
        except ValueError:
            raise KeyError(f"top must be an integer, got "
                           f"{p.get('top')!r}") from None
        self._reply(schemas.memory_v3(MEMORY.summary(top_n=top)))

    # -- the parity sweep: the routes the real h2o-py client traffics
    #    (reference registrations: water/api/RegisterV3Api.java) -------------

    def r_compute(self):
        """``GET /3/Compute`` — the compute observatory: per-site
        signatures / capture seconds / the cost functions' FLOPs + bytes,
        recompile events with signature diffs, and per-loop achieved
        throughput + utilization against the card's peak row (null off
        the card)."""
        from h2o3_tpu_torch.utils.costs import COSTS
        self._reply(schemas.compute_v3(COSTS.snapshot()))

    def r_profiler_capture(self):
        """``POST /3/Profiler/capture[?duration_ms=N]`` — a bounded
        ``torch.profiler`` window (CPU and, on a card, CUDA activity) with
        span-derived ``record_function`` names; returns the capture record
        (download the Chrome trace via
        ``/3/Profiler/captures/{id}/download``). A concurrent capture gets
        a structured 409 — the profiler is process-global."""
        from h2o3_tpu_torch.utils.profiling import PROFILER, CaptureBusy
        p = self._params()
        try:
            duration_ms = int(p.get("duration_ms", 500))
        except ValueError:
            raise KeyError(f"duration_ms must be an integer, got "
                           f"{p.get('duration_ms')!r}") from None
        try:
            rec = PROFILER.capture(duration_ms=duration_ms)
        except CaptureBusy as e:
            self._error(409, str(e), headers={"Retry-After": "1"})
            return
        self._reply({"__meta": {"schema_type": "ProfilerCaptureV3"}, **rec})

    def r_profiler_captures(self):
        """Capture registry: the last few capture records, oldest first."""
        from h2o3_tpu_torch.utils.profiling import PROFILER
        self._reply({"__meta": {"schema_type": "ProfilerCapturesV3"},
                     "captures": PROFILER.list_captures()})

    def r_profiler_capture_download(self, capture_id):
        """The capture's artifact (gzip Chrome trace JSON) — save and open
        in Perfetto or chrome://tracing."""
        from h2o3_tpu_torch.utils.profiling import PROFILER
        body, fname = PROFILER.artifact_bytes(capture_id)
        self.send_response(200)
        self.send_header("Content-Type", "application/gzip")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{fname}"')
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- ops plane (utils/health.py + utils/incidents.py — the reference's
    #    cloud_healthy consensus + `h2o logs download` analog) --------------

    def r_health(self):
        """``GET /3/Health`` — the health evaluator's subsystem-scored
        verdict: healthy/degraded/unhealthy per subsystem (elastic,
        serving, memory, compute, dispatch) with the tripping rule,
        observed value, and threshold in every finding. Served from the
        background sweep when it runs, evaluated inline otherwise
        (docs/OBSERVABILITY.md "Health & incidents")."""
        from h2o3_tpu_torch.utils.health import HEALTH
        self._reply(schemas.health_v3(HEALTH.verdict()))

    def r_incidents(self):
        """``GET /3/Incidents[?state=open|resolved]`` — the bounded
        incident ring, newest first (one open incident per rule; repeats
        fold in). Records carry ``resolved_at`` and, when the remediation
        engine acted, the ``action_id``. Contexts are served per-incident
        by ``GET /3/Incidents/{id}``."""
        from h2o3_tpu_torch.utils.incidents import INCIDENTS
        state = self._params().get("state") or None
        try:
            rows = INCIDENTS.list(state=state)
        except ValueError as e:
            self._error(400, str(e))
            return
        self._reply(schemas.incidents_v3(rows))

    def r_ops(self):
        """``GET /3/Ops`` — the self-driving ops plane in one view: the
        remediation policy (mode, rule→action map, bounds, cooldown), the
        append-only action log, and per-tenant usage + configured quotas
        (docs/OPERATIONS.md is the operator catalog)."""
        from h2o3_tpu_torch.ops_plane import ACTIONS, ENGINE, QUOTAS
        self._reply(schemas.ops_v3({
            "remediation": ENGINE.policy_view(),
            "actions": ACTIONS.list(),
            "tenants": QUOTAS.usage_all(),
            "quotas": QUOTAS.quotas()}))

    def r_ops_post(self):
        """``POST /3/Ops`` — quota CRUD + action rollback:

        - ``tenant`` (+ optional ``qps``/``device_seconds``/``bytes``)
          installs that tenant's budgets (omitted dimension = unlimited);
        - ``remove_quota=<tenant>`` drops a tenant's budgets;
        - ``rollback=<action_id>`` undoes a recorded action by token.
        """
        from h2o3_tpu_torch.ops_plane import ACTIONS, QUOTAS
        p = self._params()
        if p.get("rollback"):
            ok = ACTIONS.rollback(str(p["rollback"]))
            self._reply(schemas.ops_v3(
                {"rolled_back": ok, "action_id": p["rollback"],
                 "actions": ACTIONS.list()}))
            return
        if p.get("remove_quota"):
            try:
                removed = QUOTAS.remove_quota(str(p["remove_quota"]))
            except ValueError as e:
                self._error(400, str(e))
                return
            self._reply(schemas.ops_v3({"removed": removed,
                                        "quotas": QUOTAS.quotas()}))
            return
        if not p.get("tenant"):
            self._error(400, "POST /3/Ops needs tenant (quota CRUD), "
                             "remove_quota, or rollback")
            return
        try:
            rec = QUOTAS.set_quota(
                p["tenant"],
                qps=float(p["qps"]) if p.get("qps") is not None else None,
                device_seconds=(float(p["device_seconds"])
                                if p.get("device_seconds") is not None
                                else None),
                bytes=(int(float(p["bytes"]))
                       if p.get("bytes") is not None else None))
        except ValueError as e:
            self._error(400, str(e))
            return
        self._reply(schemas.ops_v3({"quota": rec,
                                    "quotas": QUOTAS.quotas()}))

    def r_incident(self, incident_id):
        """``GET /3/Incidents/{id}`` — one incident with the correlated
        context captured at trip time: trace ids, log tail, memory
        top-keys, compute loop rows, and the rule's observed series."""
        from h2o3_tpu_torch.utils.incidents import INCIDENTS
        self._reply(schemas.incident_v3(INCIDENTS.get(incident_id)))

    def r_diagnostics_bundle(self):
        """``POST /3/Diagnostics/bundle`` (GET also served for plain
        browser/curl downloads) — the ``h2o logs download`` analog: one
        gzip tar with all four pillar snapshots (metrics, traces, memory,
        compute), the health verdict, the incident ring, the log ring,
        the hardware fingerprint, and the secrets-redacted config dump."""
        from h2o3_tpu_torch.utils.health import diagnostic_bundle
        body, fname = diagnostic_bundle()
        self.send_response(200)
        self.send_header("Content-Type", "application/gzip")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{fname}"')
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_metrics_json(self):
        """JSON metrics snapshot — flat {name, type, labels, value} rows
        (TwoDimTable-friendly; the Python client's ``client.metrics()``)."""
        self._reply({"__meta": {"schema_type": "MetricsV3"},
                     "metrics": _tm.METRICS.snapshot()})

    def r_timeseries(self):
        """``GET /3/TimeSeries?name=&labels=&since=`` — the flight
        recorder's retained series (utils/flight.py): per series the raw
        ``(t, value)`` tail and the min/max/mean/last rollup windows.
        ``name`` matches exactly or as a prefix, ``labels`` is
        ``k=v,k2=v2`` (subset match), ``since`` is epoch seconds
        (docs/OBSERVABILITY.md "Flight recorder & post-mortems")."""
        from h2o3_tpu_torch.utils.flight import FLIGHT
        p = self._params()
        labels = None
        if p.get("labels"):
            labels = {}
            for part in str(p["labels"]).split(","):
                if "=" not in part:
                    self._error(400, f"labels must be k=v,k2=v2 pairs, "
                                     f"got {part!r}")
                    return
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip()
        since = None
        if p.get("since") is not None:
            try:
                since = float(p["since"])
            except ValueError:
                self._error(400, f"since must be epoch seconds, "
                                 f"got {p['since']!r}")
                return
        series = FLIGHT.query(name=p.get("name") or None, labels=labels,
                              since=since)
        stats = FLIGHT.stats()
        # stats counts retained series under "series"; the payload key
        # of that name is the series list itself
        stats["series_retained"] = stats.pop("series")
        self._reply(schemas.timeseries_v3({"series": series, **stats}))

    def r_metrics_text(self):
        """Prometheus/OpenMetrics exposition at ``/metrics`` — point a
        Prometheus scrape job at this path (docs/OBSERVABILITY.md). The
        render itself is timed (``h2o3_metrics_scrape_seconds``) — the
        observers are observed too."""
        t0 = time.perf_counter()
        body = _tm.METRICS.to_openmetrics().encode()
        _tm.SCRAPE_SECONDS.observe(time.perf_counter() - t0)
        self.send_response(200)
        self.send_header("Content-Type",
                         "application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- distributed tracing (reference analog: water/api/TimelineHandler —
    #    the cluster-wide causally-ordered event snapshot; here per-request
    #    span trees, see docs/OBSERVABILITY.md "Tracing") --------------------

    def r_traces(self):
        """Completed traces, newest first (summaries; span lists via
        ``/3/Traces/{trace_id}``)."""
        self._reply({"__meta": {"schema_type": "TracesV3"},
                     "traces": _tr.TRACER.list_traces()})

    def r_trace(self, trace_id):
        """One trace: flat spans + nested tree + computed critical path."""
        try:
            trace = _tr.TRACER.get_trace(trace_id)
        except KeyError:
            raise KeyError(f"no trace {trace_id!r} (completed-trace ring "
                           f"holds the last {_tr.TRACE_RING_SIZE})")
        self._reply(schemas.trace_v3(trace))

    def r_trace_export(self, trace_id):
        """Chrome trace-event JSON — save and open in Perfetto
        (https://ui.perfetto.dev) or chrome://tracing."""
        trace = _tr.TRACER.get_trace(trace_id)
        self._reply(_tr.to_chrome_trace(trace))

    # -- round-2 parity sweep: the routes the real h2o-py client traffics
    #    (reference registrations: water/api/RegisterV3Api.java) -------------

    def r_ping(self):
        self._reply({"__meta": {"schema_type": "PingV3"}, "healthy": True})

    def r_jobs(self):
        jobs = [schemas.job_v3(k, DKV[k]) for k in DKV.keys()
                if isinstance(DKV.get(k), Job)]
        self._reply({"__meta": {"schema_type": "JobsV3"}, "jobs": jobs})

    def r_parse_setup(self):
        """Reference ParseSetupHandler: guess header/types from the source.
        Sources that are already parsed frames report their schema; raw
        paths get imported (our import does guess+parse in one pass)."""
        p = self._params()
        src = p.get("source_frames", [])
        if isinstance(src, str):
            src = json.loads(src)
        keys = [s.get("name") if isinstance(s, dict) else s for s in src]
        if not keys:
            raise KeyError("source_frames is required")
        from h2o3_tpu_torch.frame.parse import RawFile, import_file
        frames = []
        for k in keys:
            obj = DKV.get(k)
            if isinstance(obj, RawFile):
                frames.append(obj.frame())
            elif isinstance(obj, Frame):
                frames.append(obj)
            else:
                frames.append(import_file(k))
        fr = frames[0]
        type_names = {"real": "Numeric", "int": "Numeric", "enum": "Enum",
                      "string": "String", "time": "Time", "uuid": "UUID"}
        self._reply({"__meta": {"schema_type": "ParseSetupV3"},
                     "source_frames": [{"name": k} for k in keys],
                     "destination_frame": (keys[0].rsplit("/", 1)[-1]
                                           .replace(".", "_") + ".hex"),
                     "number_columns": fr.ncols,
                     "column_names": list(fr.names),
                     "column_types": [type_names.get(v.type.value, "Numeric")
                                      for v in fr.vecs],
                     "separator": 44, "check_header": 1,
                     "parse_type": "CSV", "chunk_size": 4194304,
                     "na_strings": None, "single_quotes": False,
                     "escapechar": None, "skipped_columns": None,
                     "custom_non_data_line_markers": None,
                     "partition_by": None})

    def r_split_frame(self):
        """Reference SplitFrameHandler (hex/splitframe/SplitFrame.java):
        EXACT contiguous row split by ratios (unlike the client-side
        probabilistic H2OFrame.split_frame)."""
        p = self._params()
        fr = DKV[_name(p["dataset"])]
        ratios = p["ratios"]
        if isinstance(ratios, str):
            ratios = json.loads(ratios)
        dests = p.get("destination_frames")
        if isinstance(dests, str):
            dests = json.loads(dests)
        dests = [_name(d) for d in dests] if dests else [
            f"split_{uuid.uuid4().hex[:6]}_{i}" for i in range(len(ratios) + 1)]
        import numpy as np
        from h2o3_tpu_torch.rapids.munge import gather_rows
        n = fr.nrows
        counts = [int(round(r * n)) for r in ratios]
        counts.append(n - sum(counts))
        job = _job("SplitFrame")

        def run_job(j: Job):
            start = 0
            for dest, c in zip(dests, counts):
                part = gather_rows(fr, np.arange(start, start + c))
                part.key = dest
                DKV.put(dest, part)
                start += c
            j.dest_key = dests[0]
            return dests

        job.run(run_job, background=True)
        self._reply({"__meta": {"schema_type": "SplitFrameV3"},
                     "key": {"name": job.key},
                     "destination_frames": [{"name": d} for d in dests]})

    def r_create_frame(self):
        p = self._params()
        from h2o3_tpu_torch.frame.utils import create_frame
        kw = {k: (json.loads(v) if isinstance(v, str) and v[:1] in "[{tf"
                  else v) for k, v in p.items()}
        key = kw.pop("dest", None) or kw.pop("destination_frame",
                                             f"frame_{uuid.uuid4().hex[:8]}")
        numkw = {}
        import inspect
        sig = inspect.signature(create_frame)
        for k, v in kw.items():
            if k in sig.parameters:
                d = sig.parameters[k].default
                if isinstance(v, str) and isinstance(d, bool):
                    v = v.lower() in ("1", "true", "yes")
                elif isinstance(v, str):
                    try:             # None-defaulted params still need typing
                        v = int(v) if isinstance(d, int) or d is None else float(v)
                    except ValueError:
                        try:
                            v = float(v)
                        except ValueError:
                            pass
                numkw[k] = v
        fr = create_frame(**numkw)
        fr.key = key
        DKV.put(key, fr)
        self._reply({**_done_job("CreateFrame", key),
                     "key": {"name": key}, "rows": fr.nrows})

    def r_interaction(self):
        p = self._params()
        from h2o3_tpu_torch.frame.utils import interaction
        factors = p.get("factor_columns") or p.get("factors") or []
        if isinstance(factors, str):
            factors = json.loads(factors)
        fr = interaction(DKV[_name(p["source_frame"])], factors,
                         pairwise=str(p.get("pairwise", "")).lower() == "true",
                         max_factors=int(p.get("max_factors", 100)),
                         min_occurrence=int(p.get("min_occurrence", 1)))
        key = _name(p.get("dest")) or f"interaction_{uuid.uuid4().hex[:6]}"
        fr.key = key
        DKV.put(key, fr)
        self._reply({**_done_job("Interaction", key), "key": {"name": key}})

    def r_missing_inserter(self):
        """Reference MissingInserterHandler: corrupt a fraction of cells to
        NA (pyunit fixture machinery)."""
        p = self._params()
        import numpy as np
        fr = DKV[_name(p["dataset"])]
        frac = float(p.get("fraction", 0.1))
        seed = int(p.get("seed", -1) or -1)
        rng = np.random.default_rng(None if seed < 0 else seed)
        from h2o3_tpu_torch.frame.frame import Frame as _F
        from h2o3_tpu_torch.frame.types import VecType
        from h2o3_tpu_torch.frame.vec import Vec
        out = []
        for v in fr.vecs:
            if not v.type.on_device:
                out.append(v)
                continue
            vals = v.to_numpy().copy()
            hit = rng.random(len(vals)) < frac
            if v.is_categorical:
                vals = np.where(hit, -1, vals).astype(np.int32)
                out.append(Vec.from_numpy(vals, type=VecType.CAT,
                                          domain=v.domain, device=v.device))
            else:
                vals = vals.astype(np.float64)
                vals[hit] = np.nan
                out.append(Vec.from_numpy(vals.astype(np.float32),
                                          type=v.type, device=v.device))
        fr2 = _F(fr.names, out, key=fr.key)
        DKV.put(fr.key, fr2)
        self._reply({**_done_job("MissingInserter", fr.key),
                     "key": {"name": fr.key}})

    def r_typeahead(self):
        import glob
        import os
        p = self._params()
        src = p.get("src", "")
        limit = int(p.get("limit", 100))
        matches = sorted(glob.glob(src + "*"))[:limit] if src else []
        matches = [m + "/" if os.path.isdir(m) else m for m in matches]
        self._reply({"__meta": {"schema_type": "TypeaheadV3"},
                     "matches": matches})

    def r_find(self):
        """Reference FindHandler: first row index >= `row` whose `column`
        equals `match`."""
        p = self._params()
        import numpy as np
        fr = DKV[_name(p["key"])]
        col = p["column"]
        start = int(p.get("row", 0))
        target = p.get("match")
        v = fr.vec(col)
        vals = v.labels() if v.is_categorical else v.to_numpy()
        idx = -1
        for i in range(start, len(vals)):
            val = vals[i]
            if val is None or (isinstance(val, float) and np.isnan(val)):
                hit = target in (None, "", "NA")
            elif v.is_categorical:
                hit = str(val) == str(target)
            else:
                try:
                    hit = float(val) == float(target)
                except (TypeError, ValueError):
                    hit = False
            if hit:
                idx = i
                break
        self._reply({"__meta": {"schema_type": "FindV3"}, "prev": -1,
                     "next": idx})

    def r_frame_summary(self, key):
        # serves both /summary and /light: full column metadata, no data
        # page (h2o-py's H2OFrame._frame(light=True) builds its cache here)
        fr = DKV[key]
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "frames": [schemas.frame_v3(key, fr, rows=0)]})

    def r_frame_columns(self, key):
        fr = DKV[key]
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "columns": [{"label": n, "type": str(v.type).lower()}
                                 for n, v in zip(fr.names, fr.vecs)]})

    def r_frame_column(self, key, col):
        fr = DKV[key]
        sub = fr[[col]]
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "frames": [schemas.frame_v3(key, sub)]})

    def r_frame_col_summary(self, key, col):
        fr = DKV[key]
        v = fr.vec(col)
        r = v.rollups()
        out = {"label": col, "missing_count": int(r.na_cnt)}
        if v.is_numeric:
            out.update(mins=[schemas._clean(r.min)],
                       maxs=[schemas._clean(r.max)],
                       mean=schemas._clean(r.mean),
                       sigma=schemas._clean(r.sigma),
                       **schemas._histogram_cached(v, r),
                       percentiles=schemas._clean(
                           fr[[col]].quantile().vec(col).to_numpy()))
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "frames": [{"frame_id": {"name": key},
                                 "columns": [out]}]})

    def r_frame_col_domain(self, key, col):
        v = DKV[key].vec(col)
        self._reply({"__meta": {"schema_type": "FrameV3"},
                     "domain": [list(v.domain) if v.domain else None]})

    def r_frame_export(self, key):
        p = self._params()
        from h2o3_tpu_torch.persist.frame_io import export_file
        path = export_file(DKV[key], p["path"])
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "job": _done_job("Export File", key), "path": path})

    def r_frame_save(self, key):
        import os
        p = self._params()
        from h2o3_tpu_torch.persist.frame_io import save_frame
        dest = p["dir"]
        if os.path.isdir(dest):
            dest = os.path.join(dest, key)
        path = save_frame(DKV[key], dest)
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "job": _done_job("Save Frame", key), "path": path})

    def r_frame_load(self):
        p = self._params()
        from h2o3_tpu_torch.persist.frame_io import load_frame
        fr = load_frame(p["dir"], key=p.get("frame_id"))
        DKV.put(fr.key, fr)
        self._reply({"__meta": {"schema_type": "FramesV3"},
                     "job": _done_job("Load Frame", fr.key),
                     "frame_id": {"name": fr.key}})

    def r_frames_delete_all(self):
        for k, v in DKV.raw_items():
            if isinstance(v, Frame) or type(v).__name__ == "SwappedFrame":
                DKV.remove(k)      # stub-aware: deletes spill files too
        self._reply({"__meta": {"schema_type": "FramesV3"}})

    def r_dkv_delete(self, key):
        DKV.remove(key)
        self._reply({"__meta": {"schema_type": "RemoveV3"}})

    def r_dkv_delete_all(self):
        DKV.clear()
        self._reply({"__meta": {"schema_type": "RemoveAllV3"}})

    def r_download_dataset(self):
        p = self._params()
        fr = DKV[_name(p["frame_id"])]
        csv = fr.to_pandas().to_csv(index=False)
        body = csv.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/csv")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{fr.key or "frame"}.csv"')
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_import_sql(self):
        p = self._params()
        from h2o3_tpu_torch.frame.sql import import_sql_table
        fr = import_sql_table(p["connection_url"], p["table"],
                              fetch_mode=p.get("fetch_mode", "SINGLE"))
        self._reply(_done_job("ImportSQLTable", fr.key))

    def r_model_builders(self):
        self._reply({"__meta": {"schema_type": "ModelBuildersV3"},
                     "model_builders": {
                         a: {"algo": a, "visibility": "Stable"}
                         for a in sorted(_algo_registry())}})

    def r_model_builder(self, algo):
        cls = _algo_registry().get(algo.lower())
        if cls is None:
            raise KeyError(f"unknown algorithm {algo!r}")
        params = [{"name": k,
                   "default_value": schemas._clean(v),
                   "type": type(v).__name__}
                  for k, v in cls.defaults().items()]
        self._reply({"__meta": {"schema_type": "ModelBuildersV3"},
                     "model_builders": {algo.lower(): {
                         "algo": algo.lower(),
                         "supervised": not getattr(cls, "unsupervised",
                                                   False),
                         "parameters": params}}})

    def r_model_metrics_compute(self, model_key, frame_key):
        m, fr = DKV[model_key], DKV[frame_key]
        mm = m.model_performance(fr)
        item = schemas.metrics_v3(mm, getattr(m, "response_domain", None))
        item["frame"] = {"name": frame_key}     # h2o-py filters on these
        item["model"] = {"name": model_key}
        self._reply({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
                     "model_metrics": [item]})

    def r_model_metrics_get(self, model_key):
        m = DKV[model_key]
        mms = [schemas.metrics_v3(mm, getattr(m, "response_domain", None))
               for mm in (m.training_metrics, m.validation_metrics,
                          m.cross_validation_metrics) if mm is not None]
        self._reply({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
                     "model_metrics": mms})

    def r_make_metrics(self, pred_key, actual_key):
        """Reference: h2o.make_metrics — metrics from a predictions frame
        vs an actuals column (no model needed)."""
        p = self._params()
        pred, act = DKV[pred_key], DKV[actual_key]
        from h2o3_tpu_torch.models.data_info import response_as_float
        from h2o3_tpu_torch.models.model_base import compute_metrics
        yvec = act.vec(p.get("response_column") or act.names[-1])
        y, valid = response_as_float(yvec)
        mask = act.row_mask() & valid
        prob_cols = [n for n in pred.names if n != "predict"]
        if yvec.is_categorical and prob_cols:
            raw = pred.matrix(prob_cols)
            ncl = len(prob_cols)
        else:
            raw = pred.vec("predict").data
            ncl = 0
        mm = compute_metrics(raw, y, mask, ncl)
        self._reply({"__meta": {"schema_type": "ModelMetricsListSchemaV3"},
                     "model_metrics": [schemas.metrics_v3(mm)]})

    def r_partial_dependence(self):
        p = self._params()
        from h2o3_tpu_torch.explanation import partial_dependence
        m = DKV[_name(p["model_id"])]
        fr = DKV[_name(p["frame_id"])]
        cols = p.get("cols") or p.get("col_pairs_2dpdp") or []
        if isinstance(cols, str):
            cols = json.loads(cols)
        nbins = int(p.get("nbins", 20))
        name = p.get("destination_key") or f"pdp_{uuid.uuid4().hex[:8]}"
        job = _job("PartialDependence")

        def run_job(j: Job):
            tables = partial_dependence(m, fr, cols, nbins=nbins)
            DKV.put(name, tables)
            j.dest_key = name
            return tables

        job.run(run_job, background=True)
        job.dest_key = name
        self._reply({**schemas.job_v3(job.key, job),
                     "destination_key": name})

    def r_partial_dependence_get(self, name):
        tables = DKV[name]
        data = [{"columns": list(t.names),
                 "data": {n: schemas._clean(t.vec(n).to_numpy())
                          for n in t.names}} for t in tables]
        self._reply({"__meta": {"schema_type": "PartialDependenceV3"},
                     "partial_dependence_data": data})

    def r_pojo(self, model_key):
        import os
        import tempfile
        m = DKV[model_key.removesuffix(".java")]
        with tempfile.TemporaryDirectory() as d:
            path = m.download_pojo(os.path.join(d, f"{m.key}_pojo.py"))
            with open(path, "rb") as f:
                body = f.read()
            fname = os.path.basename(path)
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{fname}"')
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_mojo(self, model_key):
        import os
        import tempfile
        m = DKV[model_key]
        with tempfile.TemporaryDirectory() as d:
            path = m.download_mojo(os.path.join(d, f"{m.key}.zip"))
            with open(path, "rb") as f:
                body = f.read()
            fname = os.path.basename(path)
        self.send_response(200)
        self.send_header("Content-Type", "application/zip")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{fname}"')
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def r_model_save(self, model_key):
        import os
        p = self._params()
        from h2o3_tpu_torch.persist.model_io import save_model
        dest = p["dir"]
        if os.path.isdir(dest):      # h2o-py passes a directory
            dest = os.path.join(dest, model_key)
        path = save_model(DKV[model_key], dest)
        self._reply({"__meta": {"schema_type": "ModelsV3"},
                     "dir": path, "models": [{"model_id": {"name": model_key}}]})

    def r_model_load(self, model_key):
        p = self._params()
        from h2o3_tpu_torch.persist.model_io import load_model
        m = load_model(p["dir"])
        DKV.put(m.key, m)
        self._reply({"__meta": {"schema_type": "ModelsV3"},
                     "models": [{"model_id": {"name": m.key}}]})

    def r_model_json(self, model_key):
        self._reply({"__meta": {"schema_type": "ModelsV3"},
                     "models": [schemas.model_v3(DKV[model_key])]})

    def r_grids(self):
        from h2o3_tpu_torch.orchestration.grid import Grid
        grids = [{"grid_id": {"name": k}} for k in DKV.keys()
                 if isinstance(DKV.get(k), Grid)]
        self._reply({"__meta": {"schema_type": "GridsV99"}, "grids": grids})

    def r_capabilities(self):
        from h2o3_tpu_torch.utils import extensions as _ext
        self._reply({"__meta": {"schema_type": "CapabilitiesV3"},
                     "capabilities": [
                         {"name": a, "module": "core"}
                         for a in sorted(_algo_registry())] + [
                         {"name": e.name, "module": "extension"}
                         for e in _ext.extensions()]})

    def r_init_id(self):
        self._reply({"__meta": {"schema_type": "InitIDV3"},
                     "session_key": self.server._session_id})

    def r_sessions_v4(self):
        # h2o-py >=3.22 opens its Rapids session via the V4 endpoint; each
        # client gets a FRESH id so concurrent clients cannot collide on
        # temp-frame names (py_N_<sid>)
        from h2o3_tpu_torch.rapids.exec import Session
        sid = f"_sid_{uuid.uuid4().hex[:10]}"
        self.server._rapids_sessions[sid] = Session()
        self._reply({"__meta": {"schema_type": "SessionIdV4"},
                     "session_key": sid})

    def r_init_id_delete(self, sid=None):
        # end the client's Rapids session: drop its temp frames (reference:
        # Session.end + temp-key cleanup)
        sess = self.server._rapids_sessions.pop(
            sid or self.server._session_id, None)
        if sess is not None:
            for name in list(sess._tmp):
                sess.remove(name)
            sess.end()
        self._reply({"__meta": {"schema_type": "InitIDV3"}})

    def r_session_properties(self):
        props = self.server._session_props
        p = self._params()
        if self.command == "POST":
            props[p["key"]] = p.get("value")
        self._reply({"__meta": {"schema_type": "SessionPropertyV3"},
                     "key": p.get("key"), "value": props.get(p.get("key"))})

    def r_log_and_echo(self):
        p = self._params()
        _LOG.info(p.get("message", ""))
        self._reply({"__meta": {"schema_type": "LogAndEchoV3"},
                     "message": p.get("message", "")})

    def r_rapids_help(self):
        from h2o3_tpu_torch.rapids.exec import known_prims
        self._reply({"__meta": {"schema_type": "RapidsHelpV3"},
                     "syntax": sorted(known_prims())})

    def r_metadata_endpoints(self):
        self._reply({"__meta": {"schema_type": "MetadataV3"},
                     "routes": [{"http_method": m, "url_pattern": pat}
                                for pat, m, _ in _ROUTES]})

    def r_metadata_endpoint(self, path):
        """Reference MetadataHandler.fetchRoute: one route's metadata, with
        its handler docstring as the help text."""
        import urllib.parse as _up
        want = _up.unquote(path)
        if want.isascii() and want.isdecimal() \
                and int(want) < len(_ROUTES):   # fetch by index
            pat, m, fn = _ROUTES[int(want)]
            self._reply({"__meta": {"schema_type": "MetadataV3"},
                         "routes": [{"http_method": m, "url_pattern": pat,
                                     "summary": (fn.__doc__ or "").strip()
                                     .split("\n")[0]}]})
            return
        for pat, m, fn in _ROUTES:
            if pat.replace("\\", "") == want or pat == want:
                self._reply({"__meta": {"schema_type": "MetadataV3"},
                             "routes": [{"http_method": m, "url_pattern": pat,
                                         "summary": (fn.__doc__ or "").strip()
                                         .split("\n")[0]}]})
                return
        raise KeyError(f"no route matching {want!r}")

    def r_kill3(self):
        """Reference KillMinus3Handler (kill -3 = SIGQUIT thread dump): log
        every thread's stack, but keep serving (the JVM analog dumps and
        continues too)."""
        import sys
        import traceback
        dump = []
        for tid, frame in sys._current_frames().items():
            dump.append(f"Thread {tid}:\n"
                        + "".join(traceback.format_stack(frame)))
        _LOG.info("KillMinus3 thread dump:\n%s", "\n".join(dump))
        self._reply({"__meta": {"schema_type": "KillMinus3V3"}})

    # field inventories h2o-py's schema bootstrap fetches at connect time
    # (reference: water/api/schemas3/H2OErrorV3.java et al.)
    _SCHEMA_FIELDS = {
        "H2OErrorV3": ["timestamp", "error_url", "msg", "dev_msg",
                       "http_status", "values", "exception_type",
                       "exception_msg", "stacktrace"],
        "H2OModelBuilderErrorV3": [
            "timestamp", "error_url", "msg", "dev_msg", "http_status",
            "values", "exception_type", "exception_msg", "stacktrace",
            "parameters", "messages", "error_count"],
        "CloudV3": ["version", "cloud_name", "cloud_size", "cloud_healthy",
                    "nodes", "bad_nodes", "consensus", "locked", "is_client",
                    "cloud_uptime_millis", "internal_security_enabled",
                    "branch_name", "build_number", "build_age",
                    "build_too_old", "node_idx", "cloud_internal_timezone",
                    "datafile_parser_timezone", "mesh_slices", "workers"],
    }

    def r_metadata_schemas(self):
        """Reference MetadataHandler.listSchemas."""
        self._reply({"__meta": {"schema_type": "MetadataV3"},
                     "schemas": [{"name": n,
                                  "fields": [{"name": f, "is_schema": False,
                                              "help": f}
                                             for f in self._SCHEMA_FIELDS[n]]}
                                 for n in sorted(self._SCHEMA_FIELDS)]})

    def r_metadata_schema(self, name):
        fields = self._SCHEMA_FIELDS.get(name, [])
        self._reply({"__meta": {"schema_type": "MetadataV3"},
                     "schemas": [{"name": name,
                                  "fields": [{"name": f, "is_schema": False,
                                              "help": f} for f in fields]}]})

    def r_network_test(self):
        """Reference NetworkTestHandler: measure collective latency. Here:
        time one small reduction on the device and synchronise (one card
        has no collective; the sync IS the measurement)."""
        import time as _t

        import torch

        from h2o3_tpu_torch.device import resolve_device
        dev = resolve_device()
        t0 = _t.time()
        float(torch.ones(1024, device=dev).sum())
        dt = (_t.time() - t0) * 1e3
        self._reply({"__meta": {"schema_type": "NetworkTestV3"},
                     "microseconds_collective": dt * 1000,
                     "table": [{"collective_ms": dt}]})


_ROUTES = [
    (r"/3/Cloud", "GET", _Handler.r_cloud),
    (r"/3/About", "GET", _Handler.r_about),
    (r"/3/ImportFiles", "GET", _Handler.r_import),
    (r"/3/ImportFiles", "POST", _Handler.r_import),
    (r"/3/ImportFilesMulti", "POST", _Handler.r_import_multi),
    (r"/3/Parse", "POST", _Handler.r_parse),
    (r"/3/Frames", "GET", _Handler.r_frames),
    (r"/3/Frames/([^/]+)", "GET", _Handler.r_frame),
    (r"/3/Frames/([^/]+)", "DELETE", _Handler.r_frame_delete),
    (r"/3/Models", "GET", _Handler.r_models),
    (r"/3/Models/([^/]+)", "GET", _Handler.r_model),
    (r"/3/Models/([^/]+)", "DELETE", _Handler.r_model_delete),
    (r"/3/ModelBuilders/([^/]+)", "POST", _Handler.r_train),
    (r"/3/Jobs/([^/]+)", "GET", _Handler.r_job),
    (r"/3/Jobs/([^/]+)/cancel", "POST", _Handler.r_job_cancel),
    (r"/3/Predictions/models/([^/]+)/frames/([^/]+)", "POST", _Handler.r_predict),
    (r"/4/Predictions/models/([^/]+)/frames/([^/]+)", "POST", _Handler.r_predict_v4),
    (r"/3/Score/([^/]+)", "POST", _Handler.r_score),
    (r"/3/Score", "GET", _Handler.r_score_stats),
    (r"/3/Score/([^/]+)", "DELETE", _Handler.r_score_evict),
    (r"/99/Rapids", "POST", _Handler.r_rapids),
    (r"/99/Grid/([^/]+)", "POST", _Handler.r_grid),
    (r"/99/Grids/([^/]+)", "GET", _Handler.r_grid_get),
    (r"/99/AutoMLBuilder", "POST", _Handler.r_automl),
    (r"/99/AutoML/([^/]+)", "GET", _Handler.r_automl_get),
    (r"/99/Leaderboards/([^/]+)", "GET", _Handler.r_leaderboards),
    (r"/99/ModelBuilders/([^/]+)", "POST", _Handler.r_train),
    (r"/99/Models/([^/]+)", "GET", _Handler.r_model),
    (r"/3/PostFile", "POST", _Handler.r_postfile),
    (r"/3/PostFile\.bin", "POST", _Handler.r_postfile),
    (r"/3/PutKey", "POST", _Handler.r_putkey),
    (r"/3/Shutdown", "POST", _Handler.r_shutdown),
    (r"/3/GarbageCollect", "POST", _Handler.r_gc),
    (r"/3/Timeline", "GET", _Handler.r_timeline),
    (r"/3/JStack", "GET", _Handler.r_jstack),
    (r"/3/Profiler", "GET", _Handler.r_profiler),
    (r"/3/WaterMeterCpuTicks/\d+", "GET", _Handler.r_cpu_ticks),
    (r"/3/WaterMeterIo", "GET", _Handler.r_io_meter),
    (r"/3/Logs", "GET", _Handler.r_logs),
    (r"/3/Logs/nodes/(-?\d+)/files/([^/]+)", "GET", _Handler.r_logs_file),
    (r"/3/Memory", "GET", _Handler.r_memory),
    (r"/3/Compute", "GET", _Handler.r_compute),
    (r"/3/Health", "GET", _Handler.r_health),
    (r"/3/Incidents", "GET", _Handler.r_incidents),
    (r"/3/Incidents/([^/]+)", "GET", _Handler.r_incident),
    (r"/3/Ops", "GET", _Handler.r_ops),
    (r"/3/Ops", "POST", _Handler.r_ops_post),
    (r"/3/Diagnostics/bundle", "POST", _Handler.r_diagnostics_bundle),
    (r"/3/Diagnostics/bundle", "GET", _Handler.r_diagnostics_bundle),
    (r"/3/Profiler/capture", "POST", _Handler.r_profiler_capture),
    (r"/3/Profiler/captures", "GET", _Handler.r_profiler_captures),
    (r"/3/Profiler/captures/([^/]+)/download", "GET",
     _Handler.r_profiler_capture_download),
    (r"/3/Metrics", "GET", _Handler.r_metrics_json),
    (r"/3/TimeSeries", "GET", _Handler.r_timeseries),
    (r"/metrics", "GET", _Handler.r_metrics_text),
    (r"/3/Traces", "GET", _Handler.r_traces),
    (r"/3/Traces/([^/]+)", "GET", _Handler.r_trace),
    (r"/3/Traces/([^/]+)/export", "GET", _Handler.r_trace_export),
    (r"/", "GET", _Handler.r_flow),
    (r"/flow/index\.html", "GET", _Handler.r_flow),
    # the parity sweep (reference: RegisterV3Api.java)
    (r"/3/Ping", "GET", _Handler.r_ping),
    (r"/3/Jobs", "GET", _Handler.r_jobs),
    (r"/3/ParseSetup", "POST", _Handler.r_parse_setup),
    (r"/3/SplitFrame", "POST", _Handler.r_split_frame),
    (r"/3/CreateFrame", "POST", _Handler.r_create_frame),
    (r"/3/Interaction", "POST", _Handler.r_interaction),
    (r"/3/MissingInserter", "POST", _Handler.r_missing_inserter),
    (r"/3/Typeahead/files", "GET", _Handler.r_typeahead),
    (r"/3/Find", "GET", _Handler.r_find),
    (r"/3/Frames/([^/]+)/summary", "GET", _Handler.r_frame_summary),
    (r"/3/Frames/([^/]+)/light", "GET", _Handler.r_frame_summary),
    (r"/3/Frames/([^/]+)/columns", "GET", _Handler.r_frame_columns),
    (r"/3/Frames/([^/]+)/columns/([^/]+)", "GET", _Handler.r_frame_column),
    (r"/3/Frames/([^/]+)/columns/([^/]+)/summary", "GET",
     _Handler.r_frame_col_summary),
    (r"/3/Frames/([^/]+)/columns/([^/]+)/domain", "GET",
     _Handler.r_frame_col_domain),
    (r"/3/Frames/([^/]+)/export", "POST", _Handler.r_frame_export),
    (r"/3/Frames/([^/]+)/save", "POST", _Handler.r_frame_save),
    (r"/3/Frames/load", "POST", _Handler.r_frame_load),
    (r"/3/Frames", "DELETE", _Handler.r_frames_delete_all),
    (r"/3/DKV/([^/]+)", "DELETE", _Handler.r_dkv_delete),
    (r"/3/DKV", "DELETE", _Handler.r_dkv_delete_all),
    (r"/3/DownloadDataset", "GET", _Handler.r_download_dataset),
    (r"/3/DownloadDataset\.bin", "GET", _Handler.r_download_dataset),
    (r"/99/ImportSQLTable", "POST", _Handler.r_import_sql),
    (r"/3/ModelBuilders", "GET", _Handler.r_model_builders),
    (r"/3/ModelBuilders/([^/]+)", "GET", _Handler.r_model_builder),
    (r"/3/ModelMetrics/models/([^/]+)/frames/([^/]+)", "POST",
     _Handler.r_model_metrics_compute),
    (r"/3/ModelMetrics/models/([^/]+)/frames/([^/]+)", "GET",
     _Handler.r_model_metrics_compute),
    (r"/3/ModelMetrics/models/([^/]+)", "GET", _Handler.r_model_metrics_get),
    (r"/3/ModelMetrics/predictions_frame/([^/]+)/actuals_frame/([^/]+)",
     "POST", _Handler.r_make_metrics),
    (r"/3/PartialDependence/", "POST", _Handler.r_partial_dependence),
    (r"/3/PartialDependence/([^/]+)", "GET",
     _Handler.r_partial_dependence_get),
    (r"/3/Models\.java/([^/]+)", "GET", _Handler.r_pojo),
    (r"/3/Models/([^/]+)/mojo", "GET", _Handler.r_mojo),
    (r"/99/Models\.mojo/([^/]+)", "GET", _Handler.r_mojo),
    (r"/99/Models\.bin/([^/]*)", "GET", _Handler.r_model_save),
    (r"/99/Models\.bin/([^/]*)", "POST", _Handler.r_model_load),
    (r"/99/Models/([^/]+)/json", "GET", _Handler.r_model_json),
    (r"/99/Grids", "GET", _Handler.r_grids),
    (r"/3/Capabilities", "GET", _Handler.r_capabilities),
    (r"/3/Capabilities/Core", "GET", _Handler.r_capabilities),
    (r"/3/Capabilities/API", "GET", _Handler.r_capabilities),
    (r"/3/InitID", "GET", _Handler.r_init_id),
    (r"/3/InitID", "DELETE", _Handler.r_init_id_delete),
    (r"/4/sessions", "POST", _Handler.r_sessions_v4),
    (r"/4/sessions/([^/]+)", "DELETE", _Handler.r_init_id_delete),
    (r"/3/SessionProperties", "GET", _Handler.r_session_properties),
    (r"/3/SessionProperties", "POST", _Handler.r_session_properties),
    (r"/3/LogAndEcho", "POST", _Handler.r_log_and_echo),
    (r"/99/Rapids/help", "GET", _Handler.r_rapids_help),
    (r"/3/Metadata/endpoints", "GET", _Handler.r_metadata_endpoints),
    (r"/3/Metadata/endpoints/(.+)", "GET", _Handler.r_metadata_endpoint),
    (r"/3/Metadata/schemaclasses/([^/]+)", "GET", _Handler.r_metadata_schema),
    (r"/3/Metadata/schemas", "GET", _Handler.r_metadata_schemas),
    (r"/3/KillMinus3", "GET", _Handler.r_kill3),
    (r"/3/Metadata/schemas/([^/]+)", "GET", _Handler.r_metadata_schema),
    (r"/3/NetworkTest", "GET", _Handler.r_network_test),
    (r"/3/NodePersistentStorage/([^/]+)", "GET", _Handler.r_nps_list),
    (r"/3/NodePersistentStorage/([^/]+)/([^/]+)", "GET", _Handler.r_nps_get),
    (r"/3/NodePersistentStorage/([^/]+)/([^/]+)", "POST", _Handler.r_nps_put),
    (r"/3/NodePersistentStorage/([^/]+)/([^/]+)", "DELETE",
     _Handler.r_nps_delete),
    (r"/login", "GET", _Handler.r_login_page),
    (r"/login", "POST", _Handler.r_login),
    (r"/logout", "POST", _Handler.r_logout),
]


class _H2OHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that proves its accept loop is alive:
    ``service_actions`` runs once per ``serve_forever`` poll (~0.5s), so
    it is exactly the seam where an accept-loop wedge shows as heartbeat
    silence — the black-box watchdog pages on it, and the chaos harness
    can stall it (``rest.accept``) to rehearse the wedge. Its listen
    backlog takes bursts of concurrent scoring clients: socketserver's
    default of 5 pending connections resets the sixth connection of a
    burst before a handler thread can accept it."""

    request_queue_size = 128

    def service_actions(self):
        from h2o3_tpu_torch.utils import blackbox as _bb
        from h2o3_tpu_torch.utils import timeline as _tl
        if _tl.FAULTS is not None:
            _tl.FAULTS.maybe_fault("rest.accept")
        _bb.BLACKBOX.beat("rest_accept")


class H2OServer:
    """Embeddable REST server (reference: ``water.H2OApp`` + Jetty).

    Auth (reference ``water/H2O.java:242-266``): ``username``/``password``
    is the built-in hash login; ``authenticator`` is the pluggable hook —
    any ``(user, password) -> bool`` (an LDAP bind, a PAM check, a htpasswd
    file) slots in where the reference accepts a JAAS login module. Form
    login (POST /login → session cookie) works with either.

    TLS (reference ``h2o-internal-security``): pass ``ssl_certfile`` (+
    optional ``ssl_keyfile``) to serve https.
    """

    def __init__(self, port: int = 54321, host: str = "127.0.0.1",
                 username: str | None = None, password: str | None = None,
                 authenticator=None, ssl_certfile: str | None = None,
                 ssl_keyfile: str | None = None):
        self.httpd = _H2OHTTPServer((host, port), _Handler)
        self.httpd._session_id = f"_sid_{uuid.uuid4().hex[:10]}"
        self.httpd._session_props = {}
        self.httpd._rapids_sessions = {}
        self.httpd._login_sessions = {}    # token → expiry epoch
        self.httpd._session_ttl = 8 * 3600.0   # Jetty-like session TTL
        if authenticator is not None:
            self.httpd._authenticate = authenticator
        elif username is not None:
            import hmac
            stored = f"{username}:{password or ''}".encode()
            self.httpd._authenticate = (
                lambda u, p: hmac.compare_digest(f"{u}:{p}".encode(), stored))
        else:
            self.httpd._authenticate = None
        self.scheme = "http"
        if ssl_certfile:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_certfile, ssl_keyfile)
            # handshake on first read in the per-connection worker thread —
            # with do_handshake_on_connect=True a single idle client would
            # stall the accept loop mid-handshake and freeze the server
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True,
                                                do_handshake_on_connect=False)
            self.scheme = "https"
        self.host, self.port = host, self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def start(self) -> "H2OServer":
        # log ring first (reference: Log.init runs before the API is up), so
        # startup lines are the first thing /3/Logs serves
        _tm.install_log_ring()
        # extension lifecycle (reference: ExtensionManager hooks run during
        # H2O.main before the REST API is declared up)
        from h2o3_tpu_torch.utils import extensions as _ext
        _ext.load_env_extensions()
        _ext.init_all()
        # ops plane: the health evaluator sweeps the live registries on a
        # bounded interval (reference: the heartbeat-driven cloud_healthy
        # consensus). H2O3TPU_HEALTH_OFF=1 disables; /3/Health then
        # evaluates inline per request or reports "disabled".
        from h2o3_tpu_torch.utils.health import HEALTH
        self._started_health = HEALTH.start()
        # flight recorder: retained metric time series in fixed-memory
        # rings (GET /3/TimeSeries; H2O3TPU_FLIGHT_OFF=1 disables) — the
        # history the trend rules and post-mortems read
        from h2o3_tpu_torch.utils.flight import FLIGHT
        self._started_flight = FLIGHT.start()
        # black-box watchdog: wedge/crash post-mortems straight to
        # ice_root without REST. Watch the two loops that can wedge —
        # the accept loop (service_actions beats ~2×/s) and the health
        # sweep (beats once per interval). An orderly stop() disarms
        # BEFORE shutdown, so clean exits never dump.
        from h2o3_tpu_torch.utils.blackbox import BLACKBOX
        self._armed_blackbox = BLACKBOX.arm()
        if self._armed_blackbox:
            BLACKBOX.watch("rest_accept", period_s=1.0)
            if self._started_health:
                BLACKBOX.watch("health_sweep", period_s=HEALTH.interval_s)
        # remediation engine: subscribe to incident rising edges (the
        # kill switch H2O3TPU_REMEDIATE — default `observe` — is resolved
        # per incident, so installing here commits to nothing). Importing
        # ops_plane also arms the tenancy hooks in dispatch/DKV/serving.
        from h2o3_tpu_torch import ops_plane as _ops
        _ops.install()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        import os
        _LOG.info("REST server up at %s (pid %d)", self.url, os.getpid())
        _ext.report("cloud_up", url=self.url)
        return self

    def stop(self) -> None:
        if getattr(self, "_armed_blackbox", False):
            # disarm FIRST: this is the orderly-shutdown signal — once
            # disarmed, neither the watchdog nor the exit hooks dump
            from h2o3_tpu_torch.utils.blackbox import BLACKBOX
            BLACKBOX.disarm()
            BLACKBOX.unwatch("rest_accept")
            BLACKBOX.unwatch("health_sweep")
            self._armed_blackbox = False
        if getattr(self, "_started_health", False):
            # only the server that actually started the sweep stops it —
            # a second embedded server must not kill the first one's
            from h2o3_tpu_torch.utils.health import HEALTH
            HEALTH.stop()
            self._started_health = False
        if getattr(self, "_started_flight", False):
            from h2o3_tpu_torch.utils.flight import FLIGHT
            FLIGHT.stop()
            self._started_flight = False
        self.httpd.shutdown()
        self.httpd.server_close()


def start_server(port: int = 54321, host: str = "127.0.0.1") -> H2OServer:
    """h2o-py surface: ``h2o.init()`` boots a node and its REST server."""
    return H2OServer(port=port, host=host).start()
