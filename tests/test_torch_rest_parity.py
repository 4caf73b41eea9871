"""The port's REST server against the JAX package's, both running in this
process on ports of their own, each with its own DKV holding the same
seeded frame: the same route table (every path and method), and for each
ported route the same top-level JSON keys and ``__meta.schema_name`` from
both. A GBM trained through the JAX server's ``/3/ModelBuilders`` is
carried into the port under the same key; its ``/3/Score`` predictions
from both servers agree at rtol 1e-5 / atol 1e-6 with the same labels.

The routes of the observability and ops slice (metrics, traces, the
timeline, the profiler, compute, health, incidents, the bundle, time
series, the ops plane) are compared by what both must agree on: a JSON
payload's keys and schema name, a tarball's members, an exposition's
family types, and the status and content type of every answer.

The port's ``GET /3/Score`` adds each scorer's ``modes`` (``"graph"`` or
``"eager"``); its keys are otherwise the reference's. The reference's server is fed JAX frames and models
only; both servers are stopped at the end of the module.
"""

import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_carry import carry

from h2o3_tpu.api import server as jserver
from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.serving import SCORING as JSCORING
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.api import server as pserver
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.serving import SCORING
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 256


@pytest.fixture(scope="module")
def _servers():
    """(reference url, port url, the carried GBM's key, rows to score, the
    DKV values of each package)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    cols = {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
            "g": np.where(X[:, 2] > 0, "u", "v").astype(object),
            "y": np.where(X[:, 0] - X[:, 1] > 0, "yes", "no").astype(object)}
    jvals = {"pf": JFrame.from_arrays(cols, key="pf")}
    pvals = {"pf": Frame.from_arrays(cols, key="pf")}
    JDKV.put("pf", jvals["pf"])
    js = jserver.H2OServer(port=0).start()
    ps = pserver.H2OServer(port=0).start()
    try:
        out = _call(js.url, "POST", "/3/ModelBuilders/gbm",
                    {"training_frame": "pf", "response_column": "y",
                     "ntrees": 3, "max_depth": 3, "seed": 1,
                     "model_id": "pgbm"})
        job = out["job"]["key"]["name"]
        for _ in range(600):
            st = _call(js.url, "GET", f"/3/Jobs/{job}")["jobs"][0]["status"]
            if st != "RUNNING" and st != "CREATED":
                break
            import time
            time.sleep(0.02)
        assert st == "DONE", st
        jvals["pgbm"] = JDKV["pgbm"]
        pvals["pgbm"] = carry(jvals["pgbm"], N)
        rows = [{"a": float(X[i, 0]), "b": float(X[i, 1]),
                 "c": float(X[i, 2]), "g": str(cols["g"][i])}
                for i in range(30)]
        yield js.url, ps.url, "pgbm", rows, jvals, pvals
    finally:
        js.stop()
        ps.stop()
        JSCORING.reset()
        SCORING.reset()
        JDKV.clear()
        DKV.clear()
        set_device(None)
        torch.set_num_threads(prev)


@pytest.fixture
def servers(_servers):
    """The module's servers, with both DKVs holding the frame and the GBM
    again (the suite's fixtures empty the DKVs after every test)."""
    *urls, jvals, pvals = _servers
    for k, v in jvals.items():
        JDKV.put(k, v)
    for k, v in pvals.items():
        DKV.put(k, v)
    yield tuple(urls)
    JSCORING.reset()
    SCORING.reset()
    JDKV.clear()
    DKV.clear()


def _call(url, method, path, data=None):
    body = None
    headers = {}
    if data is not None:
        body = urllib.parse.urlencode(
            {k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
             for k, v in data.items()}).encode()
        headers["Content-Type"] = "application/x-www-form-urlencoded"
    req = urllib.request.Request(url + path, data=body, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return {"http_status": e.code, **json.loads(e.read())}


def test_the_route_tables_are_the_same():
    ref = [(pat, m) for pat, m, _ in jserver._ROUTES]
    port = [(pat, m) for pat, m, _ in pserver._ROUTES]
    assert port == ref


#: (method, path, params) of routes served by both, with the same payload
#: shapes
ROUTES = [
    ("GET", "/3/Cloud", None),
    ("GET", "/3/About", None),
    ("GET", "/3/Ping", None),
    ("GET", "/3/Frames", None),
    ("GET", "/3/Frames/pf", None),
    ("GET", "/3/Frames/pf/summary", None),
    ("GET", "/3/Frames/pf/light", None),
    ("GET", "/3/Frames/pf/columns", None),
    ("GET", "/3/Frames/pf/columns/a", None),
    ("GET", "/3/Frames/pf/columns/a/summary", None),
    ("GET", "/3/Frames/pf/columns/g/domain", None),
    ("GET", "/3/Models", None),
    ("GET", "/3/Models/pgbm", None),
    ("GET", "/99/Models/pgbm", None),
    ("GET", "/99/Models/pgbm/json", None),
    ("GET", "/3/ModelBuilders", None),
    ("GET", "/3/ModelBuilders/gbm", None),
    ("GET", "/3/ModelMetrics/models/pgbm/frames/pf", None),
    ("POST", "/3/ModelMetrics/models/pgbm/frames/pf", {}),
    ("GET", "/3/ModelMetrics/models/pgbm", None),
    ("POST", "/3/Predictions/models/pgbm/frames/pf", {}),
    ("POST", "/4/Predictions/models/pgbm/frames/pf", {}),
    ("GET", "/3/Capabilities", None),
    ("GET", "/3/Capabilities/Core", None),
    ("GET", "/3/InitID", None),
    ("POST", "/3/SessionProperties", {"key": "k", "value": "v"}),
    ("GET", "/3/SessionProperties?key=k", None),
    ("POST", "/3/LogAndEcho", {"message": "parity"}),
    ("GET", "/99/Rapids/help", None),
    ("POST", "/99/Rapids", {"ast": "(sum (cols pf 'a'))"}),
    ("POST", "/99/Rapids", {"ast": "(+ (cols pf 'a') 1)", "id": "pf_a1"}),
    ("GET", "/3/Metadata/endpoints", None),
    ("GET", "/3/Metadata/endpoints/0", None),
    ("GET", "/3/Metadata/schemas", None),
    ("GET", "/3/Metadata/schemaclasses/CloudV3", None),
    ("GET", "/3/Find?key=pf&column=g&match=v", None),
    ("POST", "/3/ParseSetup", {"source_frames": ["pf"]}),
    ("GET", "/3/Typeahead/files?src=/nonexistent_dir_x", None),
    ("GET", "/3/NetworkTest", None),
    ("GET", "/3/KillMinus3", None),
    ("GET", "/3/Logs", None),
    ("GET", "/3/Logs/nodes/0/files/info", None),
    ("GET", "/3/Frames/nope", None),
    ("GET", "/3/NoSuchRoute", None),
    ("POST", "/3/ModelBuilders/levenshtein", {"training_frame": "pf"}),
    ("POST", "/3/Score/pgbm", {"rows": []}),
    ("POST", "/3/Score/nope", {"rows": [{"a": 1.0}]}),
    ("DELETE", "/3/Score/pgbm", None),
]


@pytest.mark.parametrize("method,path,params", ROUTES,
                         ids=[f"{m} {p}" for m, p, _ in ROUTES])
def test_both_servers_answer_with_the_same_schema(servers, method, path,
                                                  params):
    jurl, purl, _, _ = servers
    want = _call(jurl, method, path, params)
    got = _call(purl, method, path, params)
    assert got.get("http_status") == want.get("http_status")
    assert sorted(got) == sorted(want)
    assert got["__meta"]["schema_name"] == want["__meta"]["schema_name"]


def test_scoring_through_both_servers_agrees(servers):
    jurl, purl, key, rows = servers
    want = _call(jurl, "POST", f"/3/Score/{key}", {"rows": rows})
    got = _call(purl, "POST", f"/3/Score/{key}", {"rows": rows})
    assert sorted(got) == sorted(want)
    assert got["__meta"]["schema_name"] == "ScoreV3"
    assert got["predictions"]["predict"] == want["predictions"]["predict"]
    for col in ("pno", "pyes"):
        np.testing.assert_allclose(got["predictions"][col],
                                   want["predictions"][col],
                                   rtol=1e-5, atol=1e-6)
    wst = _call(jurl, "GET", "/3/Score")
    pst = _call(purl, "GET", "/3/Score")
    assert set(pst) - set(wst) == {"modes"} and set(wst) <= set(pst)
    assert set(wst["cache"]) <= set(pst["cache"])
    assert pst["__meta"]["schema_name"] == wst["__meta"]["schema_name"]
    assert [r["model"] for r in pst["resident"]] == [key]
    assert pst["modes"][key][0]["mode"] == "eager"


#: the routes of the observability and ops slice: (method, path, params).
#: ``{trace}`` is a trace both servers recorded under one caller's
#: ``traceparent``.
OPS_ROUTES = [
    ("GET", "/3/Timeline", None),
    ("GET", "/3/JStack", None),
    ("GET", "/3/Profiler?depth=1", None),
    ("GET", "/3/WaterMeterCpuTicks/0", None),
    ("GET", "/3/WaterMeterIo", None),
    ("GET", "/3/Compute", None),
    ("GET", "/3/Health", None),
    ("GET", "/3/Incidents", None),
    ("GET", "/3/Incidents?state=resolved", None),
    ("GET", "/3/Incidents?state=bogus", None),
    ("GET", "/3/Incidents/nope", None),
    ("GET", "/3/Ops", None),
    ("POST", "/3/Ops", {"tenant": "team-p", "qps": 5}),
    ("POST", "/3/Ops", {"remove_quota": "team-p"}),
    ("POST", "/3/Ops", {"rollback": "act_nope"}),
    ("POST", "/3/Ops", {}),
    ("POST", "/3/Diagnostics/bundle", {}),
    ("GET", "/3/Diagnostics/bundle", None),
    ("POST", "/3/Profiler/capture?duration_ms=10", {}),
    ("POST", "/3/Profiler/capture?duration_ms=soon", {}),
    ("GET", "/3/Profiler/captures", None),
    ("GET", "/3/Profiler/captures/cap_nope/download", None),
    ("GET", "/3/Metrics", None),
    ("GET", "/metrics", None),
    ("GET", "/3/TimeSeries", None),
    ("GET", "/3/TimeSeries?labels=bad", None),
    ("GET", "/3/TimeSeries?since=later", None),
    ("GET", "/3/Traces", None),
    ("GET", "/3/Traces/{trace}", None),
    ("GET", "/3/Traces/{trace}/export", None),
    ("GET", "/3/Traces/nope", None),
]

_TRACEPARENT = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


def _raw(url, method, path, data=None, headers=None):
    """(status, content type, body bytes) of one request."""
    body = None
    hdrs = dict(headers or {})
    if data is not None:
        body = urllib.parse.urlencode(data).encode()
        hdrs["Content-Type"] = "application/x-www-form-urlencoded"
    req = urllib.request.Request(url + path, data=body, method=method,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _shape(ctype: str, body: bytes):
    """What both servers must agree on: a JSON payload's top-level keys and
    schema name; a tarball's member names; an exposition's family types."""
    if "json" in ctype:
        obj = json.loads(body)
        return sorted(obj), (obj.get("__meta") or {}).get("schema_name")
    if "gzip" in ctype:
        import io
        import tarfile
        with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
            return sorted(m.name for m in tar.getmembers())
    text = body.decode()
    return (text.endswith("# EOF\n"),
            {ln for ln in text.splitlines() if ln.startswith("# TYPE")
             and not ln.startswith(("# TYPE h2o3_incidents ",
                                    "# TYPE h2o3_ops_"))})


@pytest.mark.parametrize("method,path,params", OPS_ROUTES,
                         ids=[f"{m} {p}" for m, p, _ in OPS_ROUTES])
def test_both_servers_answer_the_observability_routes(servers, method, path,
                                                      params):
    jurl, purl, _, _ = servers
    if "{trace}" in path:
        # one caller's trace, recorded by each server under its id
        for url in (jurl, purl):
            _raw(url, "POST", "/3/LogAndEcho", {"message": "traced"},
                 headers={"traceparent": _TRACEPARENT})
        path = path.replace("{trace}", _TRACEPARENT.split("-")[1])
    want = _raw(jurl, method, path, params)
    got = _raw(purl, method, path, params)
    assert got[0] == want[0], (got[0], want[0], got[2][:300])
    assert got[1].split(";")[0] == want[1].split(";")[0]
    assert _shape(got[1], got[2]) == _shape(want[1], want[2])
