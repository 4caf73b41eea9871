"""The port's timeline (``h2o3_tpu_torch/utils/timeline.py``) and dispatch
retry (``h2o3_tpu_torch/ops/map_reduce.py``) against the JAX package's:
the event ring wraps and clears alike; the fault injector, seeded alike,
makes the same drop/delay/stall decisions over the same call sequence
(site and worker overrides, ``after`` thresholds included); ``retrying``
absorbs and exhausts alike, with the same attempt histories, metrics and
Job retry credits; ``timed_event`` records its event, its histogram and
its span. The thread dump, CPU and IO meters and the ``torch.profiler``
session functions work on the CPU.
"""

import importlib
import json
import os

import pytest
import torch

from h2o3_tpu.utils import timeline as jtl
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import timeline as ptl
from jax_reference import _jax_compile_cache  # noqa: F401

# the JAX package's ``ops`` exports a function of the module's name
jmr = importlib.import_module("h2o3_tpu.ops.map_reduce")
pmr = importlib.import_module("h2o3_tpu_torch.ops.map_reduce")


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def _ring(tl):
    ring = tl.TimeLine(size=4)
    for i in range(6):
        ring.record("tree", f"e{i}", i)
    before = [(e["kind"], e["what"], e["dur_ns"]) for e in ring.snapshot()]
    ring.clear()
    ring.record("model", "after")
    after = [(e["kind"], e["what"]) for e in ring.snapshot()]
    return before, after


def test_the_ring_wraps_and_clears_alike():
    assert _ring(ptl) == _ring(jtl)
    assert _ring(ptl)[0] == [("tree", f"e{i}", i) for i in range(2, 6)]


def _decisions(tl):
    inj = tl.FaultInjector(
        drop_rate=0.3, delay_rate=0.2, delay_ms=0.0, seed=7,
        site_rates={"gbm_chunk": {"drop_rate": 1.0, "after": 2},
                    "glm_megastep": {"stall_rate": 1.0, "stall_ms": 0.0}},
        worker_rates={1: {"drop_rate": 0.0}})
    out = []
    for i in range(30):
        site = ("gbm_chunk", "glm_megastep", "map_reduce:x")[i % 3]
        scope = tl.worker_scope(1) if i % 5 == 0 else None
        try:
            if scope is not None:
                with scope:
                    inj.maybe_fault(site)
            else:
                inj.maybe_fault(site)
            out.append((site, "ok"))
        except tl.FaultInjected:
            out.append((site, "drop"))
    return out, (inj.dropped, inj.delayed, inj.stalled, inj.crashed)


def test_the_same_calls_give_the_same_faults():
    got, want = _decisions(ptl), _decisions(jtl)
    assert got == want
    assert got[1][0] > 0 and got[1][2] > 0


def _retry_run(mr, tl, monkeypatch, outcome):
    monkeypatch.setenv("H2O3TPU_DISPATCH_BACKOFF_MS", "0")
    calls = []

    def thunk():
        calls.append(1)
        if outcome == "runtime" and len(calls) < 3:
            raise RuntimeError("transient dispatch failure")
        if outcome == "deterministic":
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return "done"

    if outcome == "drops":
        with tl.inject_faults(site_rates={"site": {"drop_rate": 1.0}}):
            with pytest.raises(mr.DispatchFailed) as e:
                mr.retrying("site", thunk)
        return [h["error"] for h in e.value.history], len(calls), str(e.value)
    if outcome == "deterministic":
        with pytest.raises(RuntimeError) as e:
            mr.retrying("site", thunk)
        return str(e.value), len(calls)
    return mr.retrying("site", thunk), len(calls)


@pytest.mark.parametrize("outcome", ["drops", "runtime", "deterministic"])
def test_retrying_absorbs_and_exhausts_alike(monkeypatch, outcome):
    got = _retry_run(pmr, ptl, monkeypatch, outcome)
    want = _retry_run(jmr, jtl, monkeypatch, outcome)
    assert got == want


def test_retries_are_counted_and_credited_to_the_job(monkeypatch):
    from h2o3_tpu_torch.models.job import Job
    from h2o3_tpu_torch.utils import telemetry as tm
    monkeypatch.setenv("H2O3TPU_DISPATCH_BACKOFF_MS", "0")

    def count(outcome):
        return sum(c.value for lb, c in tm.DISPATCH_RETRIES.children()
                   if lb == {"fn": "jobsite", "outcome": outcome})
    r0, x0 = count("retried"), count("exhausted")
    job = Job("retry probe")
    with ptl.inject_faults(site_rates={"jobsite": {"drop_rate": 1.0,
                                                   "after": 0}}):
        job.run(lambda j: pmr.retrying("jobsite", lambda: 1))
    assert job.status == Job.FAILED and job.retries == 3
    assert len(job.retry_history) == 4
    assert count("retried") == r0 + 3 and count("exhausted") == x0 + 1


def test_timed_event_records_event_histogram_and_span():
    from h2o3_tpu_torch.utils import telemetry as tm
    from h2o3_tpu_torch.utils.tracing import TRACER
    hist = tm.MetricsRegistry().histogram("it", buckets=(1.0,))
    with TRACER.span("root", root=True) as root:
        with ptl.timed_event("iteration", "glm_irls", observe=hist):
            pass
    assert ptl.TIMELINE.snapshot()[-1]["what"] == "glm_irls"
    assert hist.labels().count == 1
    trace = TRACER.get_trace(root.trace_id)
    assert [s["name"] for s in trace["spans"]] == ["glm_irls", "root"]


def test_thread_dump_and_meters():
    names = {t["name"] for t in ptl.jstack()}
    assert "MainThread" in names
    assert set(ptl.jstack()[0]) == set(jtl.jstack()[0])
    assert ptl.cpu_ticks().keys() == jtl.cpu_ticks().keys()
    assert ptl.io_stats().keys() == jtl.io_stats().keys()


def test_the_profiler_session_writes_a_chrome_trace(tmp_path):
    ptl.start_profiler(str(tmp_path))
    (torch.ones(16, 16) @ torch.ones(16, 16)).sum()
    path = ptl.stop_profiler()
    assert path == os.path.join(str(tmp_path), "trace.json")
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]
    assert ptl.stop_profiler() is None
    with pytest.raises(RuntimeError, match="CUDA"):
        ptl.device_memory_profile()


def test_a_deadline_keeps_the_built_trees(monkeypatch):
    """``max_runtime_secs`` on a stepped clock: the GBM stops between
    rounds, keeps its trees, and its Job reads CANCELLED with the
    deadline's evidence (the reference's ``Job._check_deadline``)."""
    import types

    import numpy as np

    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import job as jobmod
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.utils import telemetry as tm
    now = [1000.0]

    def tick():
        now[0] += 1.0
        return now[0]
    monkeypatch.setattr(jobmod, "time", types.SimpleNamespace(time=tick))
    before = tm.JOB_DEADLINE_EXCEEDED.labels().value
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 3)).astype(np.float32)
    fr = Frame.from_arrays({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                            "y": (X[:, 0] > 0).astype(np.float32)})
    b = GBM(ntrees=30, max_depth=2, seed=1, max_runtime_secs=5.0)
    m = b.train(y="y", training_frame=fr)
    assert 0 < m.output["ntrees"] < 30
    assert b.job.status == "CANCELLED" and b.job.deadline_exceeded
    assert "max_runtime_secs=5 exceeded" in b.job.progress_msg
    assert tm.JOB_DEADLINE_EXCEEDED.labels().value == before + 1
    with pytest.raises(ValueError, match="max_runtime_secs"):
        GBM(max_runtime_secs=-1)
