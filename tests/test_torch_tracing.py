"""The port's tracer (``h2o3_tpu_torch/utils/tracing.py``) against the JAX
package's: with span ids and clocks injected (one counter each, reset per
package), the same sequence of span operations gives the same completed
traces, span trees, critical paths and Chrome exports, field for field;
W3C ``traceparent`` parsing and formatting agree on valid and invalid
headers. Then the port's REST server: a ``traceparent`` joins the caller's
trace, and a GBM built through ``/3/ModelBuilders`` hangs
request → job → ``gbm:fit`` → ``gbm:chunk`` under it.
"""

import itertools
import time
import uuid

import numpy as np
import pytest
import torch

from h2o3_tpu.utils import tracing as jtr
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import tracing as ptr
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture
def injected(monkeypatch):
    """A reset() that restarts the injected id and clock counters."""
    state = {}

    def reset():
        state["ids"] = itertools.count(1)
        state["ns"] = itertools.count(1_000_000, 1_000)

    class _U:
        def __init__(self, n):
            self.hex = f"{n:016x}" * 2

    monkeypatch.setattr(uuid, "uuid4", lambda: _U(next(state["ids"])))
    monkeypatch.setattr(time, "time_ns", lambda: next(state["ns"]))
    reset()
    return reset


def _scenario(tr):
    """A request with a caller's traceparent, nested spans, a retained
    hand-off adopted as a job, an attached child span, a span that raises,
    a fault mark and a root annotation; returns the tracer."""
    t = tr.Tracer(capacity=8, max_open=4)
    parent = tr.parse_traceparent("00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    with t.span("POST /3/ModelBuilders/gbm", kind="server", root=True,
                parent=parent, attrs={"method": "POST"}) as root:
        with t.span("validate", kind="internal"):
            pass
        ctx = t.capture()
        t.annotate_root(root.trace_id, peak_device_bytes=10)
    with t.adopt(ctx, "job:gbm", kind="job", attrs={"job": "j1"}) as js:
        token = tr._CURRENT.set(js.context)
        try:
            with t.span("gbm:fit", kind="model") as fit:
                for i in range(3):
                    with t.span("gbm:chunk", kind="tree",
                                attrs={"chunk": i}):
                        t.mark_active(status="delayed", fault="delay:x")
                t.add_span("partition", "partition", fit, 1_000_100,
                           1_000_900, attrs={"shard": 0}, tid="p0")
                t.annotate_root(root.trace_id, peak_device_bytes=99)
            with pytest.raises(ZeroDivisionError):
                with t.span("boom", kind="internal"):
                    1 / 0
        finally:
            tr._CURRENT.reset(token)
    # an ephemeral root (a poll) never enters the ring
    with t.span("GET /3/Jobs", kind="server", root=True, ephemeral=True):
        pass
    # child spans stay silent without an active trace
    assert t.begin("orphan") is None
    return t


def _normalise(obj):
    """Thread idents differ between runs only where a span recorded one."""
    if isinstance(obj, dict):
        return {k: (_normalise(v) if k != "tid" else "tid")
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalise(v) for v in obj]
    return obj


def test_the_same_spans_give_the_same_traces(injected):
    injected()
    pt = _scenario(ptr)
    injected()
    jt = _scenario(jtr)
    got, want = pt.list_traces(), jt.list_traces()
    assert got == want and len(got) == 1
    tid = got[0]["trace_id"]
    assert tid == "a" * 32
    ptrace, jtrace = pt.get_trace(tid), jt.get_trace(tid)
    assert _normalise(ptrace) == _normalise(jtrace)
    assert _normalise(ptr.span_tree(ptrace)) == \
        _normalise(jtr.span_tree(jtrace))
    assert ptr.critical_path(ptrace) == jtr.critical_path(jtrace)
    assert ptrace["status"] == "error"
    names = [s["name"] for s in ptrace["spans"]]
    assert names.count("gbm:chunk") == 3 and "partition" in names


def test_the_same_spans_give_the_same_chrome_export(injected):
    injected()
    pt = _scenario(ptr)
    injected()
    jt = _scenario(jtr)
    tid = "a" * 32
    got = ptr.to_chrome_trace(pt.get_trace(tid))
    want = jtr.to_chrome_trace(jt.get_trace(tid))
    assert _normalise(got) == _normalise(want)
    assert {e["ph"] for e in got["traceEvents"]} == {"M", "X"}


@pytest.mark.parametrize("header", [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-00",
    " 00-" + "1" * 32 + "-" + "2" * 16 + "-01 ",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "garbage", "", None])
def test_traceparent_parsing_agrees(header):
    got, want = ptr.parse_traceparent(header), jtr.parse_traceparent(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert ptr.format_traceparent(got) == jtr.format_traceparent(want)


def test_open_trace_eviction_and_ring_bound_agree(injected):
    def run(tr):
        t = tr.Tracer(capacity=3, max_open=2)
        held = []
        for i in range(5):
            with t.span(f"r{i}", root=True):
                held.append(t.capture())
        for i in range(5):
            with t.span(f"done{i}", root=True):
                pass
        return t.list_traces()
    injected()
    got = run(ptr)
    injected()
    assert got == run(jtr)
    assert len(got) == 3


def test_trace_off_disables_roots(monkeypatch):
    monkeypatch.setenv("H2O3TPU_TRACE_OFF", "1")
    t = ptr.Tracer()
    with t.span("r", root=True) as s:
        assert s is None
    assert t.list_traces() == []


def test_span_hook_wraps_spans_while_set(monkeypatch):
    entered = []

    class Ann:
        def __init__(self, name):
            entered.append(name)

        def __exit__(self, *a):
            entered.append("exit")

    monkeypatch.setattr(ptr, "SPAN_HOOK", Ann)
    with ptr.TRACER.span("hooked", root=True, ephemeral=True):
        pass
    assert entered == ["hooked", "exit"]


def test_rest_build_traces_request_job_fit_and_chunks():
    from h2o3_tpu_torch.api import H2OClient, H2OServer
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.utils.registry import DKV
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    DKV.put("trace_fr", Frame.from_arrays(
        {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
         "y": np.where(X[:, 0] > 0, "p", "n").astype(object)},
        key="trace_fr"))
    s = H2OServer(port=0).start()
    try:
        c = H2OClient(s.url)
        tp = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
        import json
        import urllib.parse
        import urllib.request
        body = urllib.parse.urlencode({
            "training_frame": "trace_fr", "response_column": "y",
            "ntrees": 2, "max_depth": 2, "seed": 1}).encode()
        req = urllib.request.Request(
            s.url + "/3/ModelBuilders/gbm", data=body, method="POST",
            headers={"traceparent": tp,
                     "Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(req) as r:
            assert r.headers["traceparent"].split("-")[1] == "c" * 32
            job = json.loads(r.read())["job"]["key"]["name"]
        for _ in range(600):
            if c.job(job)["status"] not in ("RUNNING", "CREATED"):
                break
            time.sleep(0.02)
        for _ in range(100):
            trace = c.trace("c" * 32)
            if not trace.get("in_progress"):
                break
            time.sleep(0.02)
        spans = {sp["span_id"]: sp for sp in trace["spans"]}

        def chain(sp):
            out = []
            while sp is not None:
                out.append(sp["name"])
                sp = spans.get(sp["parent_id"])
            return out[::-1]
        chunk = next(sp for sp in spans.values() if sp["name"] == "gbm:chunk")
        names = chain(chunk)
        assert names[0] == "POST /3/ModelBuilders/{algo}" or \
            names[0].startswith("POST /3/ModelBuilders")
        assert names[1].startswith("job:") and names[-2:] == ["gbm:fit",
                                                              "gbm:chunk"]
        export = c.trace_export("c" * 32)
        assert {e["name"] for e in export["traceEvents"]} >= {"gbm:fit",
                                                             "gbm:chunk"}
    finally:
        s.stop()
