"""The port's health evaluator (``h2o3_tpu_torch/utils/health.py``) against
the JAX package's: the registries are replaced by the same scripted probe
values in both modules (``_serving_stats``, ``_score_requests_total``,
``_exhausted_total``, ``_cleaner_stats``, ``_leak_growth_flags``,
``_recompile_total``, ``_compute_loops``), both evaluators sweep on a
stepped clock with injected incident ids, and every sweep's verdict and
the incident records must be the same. Then the rule catalog, the
redaction contract and the diagnostic bundle's members, and the port's
health sweep on a REST server: healthy at first, unhealthy with a
``dispatch_retry_exhaustion`` finding and one open incident once a GBM's
chunk dispatch exhausts its retry budget under injected drops (every
``gbm_chunk`` dispatch), resolved again after the fault clears.
"""

import io
import itertools
import tarfile
import time
import uuid

import numpy as np
import pytest
import torch

from h2o3_tpu.utils import health as jhm
from h2o3_tpu.utils import incidents as jim
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import health as phm
from h2o3_tpu_torch.utils import incidents as pim
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def _quiet_flight():
    """The port's flight recorder stopped and empty around each test, as
    tests/conftest.py's ``_clear_flight`` keeps the reference's: a
    recorder that an earlier module's server started goes on sampling this
    worker's RSS, and its trend rules would read that history."""
    from h2o3_tpu_torch.utils.flight import FLIGHT
    FLIGHT.stop()
    FLIGHT.reset()
    yield
    FLIGHT.reset()


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
def clock(monkeypatch):
    """A stepped wall clock and counter ids; ``clock.reset()`` restarts
    both, ``clock.step(s)`` advances the clock."""
    class Clock:
        def reset(self):
            self.t = 1_700_000_000.0
            self.ids = itertools.count(1)

        def step(self, s=1.0):
            self.t += s

    c = Clock()
    c.reset()

    class _U:
        def __init__(self, n):
            self.hex = (f"{n:06x}" * 6)[:32]

    monkeypatch.setattr(time, "time", lambda: c.t)
    monkeypatch.setattr(uuid, "uuid4", lambda: _U(next(c.ids)))
    return c


#: the probe seams both evaluators read, and a script of their values, one
#: entry a sweep
SEAMS = ("_serving_stats", "_score_requests_total", "_exhausted_total",
         "_cleaner_stats", "_leak_growth_flags", "_recompile_total",
         "_compute_loops", "_ejections_total", "_elastic_rows")


def _script():
    clean = dict(spill_count=0, restore_count=0)
    rows = [{"model": "m", "slo": {"target_ms": 50.0, "p99_ms": 20.0}}]
    return [
        # baseline sweep: every window delta starts here
        dict(_serving_stats={"shed_total": 0, "resident": rows},
             _score_requests_total=100.0, _exhausted_total=0.0,
             _cleaner_stats=clean, _leak_growth_flags=[],
             _recompile_total=0.0, _compute_loops={},
             _ejections_total=0.0, _elastic_rows=[]),
        # sheds and a p99 over the SLO; a retry budget exhausted
        dict(_serving_stats={"shed_total": 40, "resident": [
            {"model": "m", "slo": {"target_ms": 50.0, "p99_ms": 75.0}}]},
             _score_requests_total=200.0, _exhausted_total=1.0),
        # still tripping: the open incidents repeat
        dict(_serving_stats={"shed_total": 90, "resident": [
            {"model": "m", "slo": {"target_ms": 50.0, "p99_ms": 80.0}}]},
             _score_requests_total=300.0, _exhausted_total=2.0,
             _recompile_total=5.0,
             _compute_loops={"glm_irls": {"utilization": 0.001,
                                          "samples": 50}}),
        # thrash and a growing key; the serving rules recover
        dict(_serving_stats={"shed_total": 90, "resident": rows},
             _score_requests_total=400.0,
             _cleaner_stats=dict(spill_count=9, restore_count=9),
             _leak_growth_flags=[{"key": "k", "reasons": ["growing"]}]),
        # everything clears
        dict(_cleaner_stats=dict(spill_count=9, restore_count=9),
             _leak_growth_flags=[], _compute_loops={}),
        dict(),
    ]


def _run(hm, im, monkeypatch, clock):
    clock.reset()
    state = {}
    for name in SEAMS:
        monkeypatch.setattr(hm, name,
                            (lambda n: lambda *a: state[n])(name))
    ev = hm.HealthEvaluator(interval_s=0.1, incidents=im.IncidentLog(
        capacity=16))
    verdicts = []
    for step in _script():
        state.update(step)
        clock.step(1.0)
        v = ev.evaluate()
        verdicts.append({k: v[k] for k in ("status", "healthy", "findings",
                                           "subsystems", "open_incidents",
                                           "evaluated_ms")
                         if k in v})
    incidents = [{k: r[k] for k in r if k != "context"}
                 for r in ev.incidents.list()]
    return verdicts, incidents


def test_the_same_registry_states_give_the_same_verdicts(monkeypatch, clock):
    got = _run(phm, pim, monkeypatch, clock)
    want = _run(jhm, jim, monkeypatch, clock)
    assert got[0] == want[0]
    statuses = [v["status"] for v in got[0]]
    assert statuses[0] == "healthy" and "unhealthy" in statuses
    rules = {f["rule"] for v in got[0] for f in v["findings"]}
    assert {"serving_shed_rate", "serving_p99_slo",
            "dispatch_retry_exhaustion", "compute_recompile_storm",
            "memory_spill_thrash"} <= rules


def test_the_same_registry_states_give_the_same_incidents(monkeypatch,
                                                          clock):
    got = _run(phm, pim, monkeypatch, clock)[1]
    want = _run(jhm, jim, monkeypatch, clock)[1]
    assert got == want
    assert any(r["status"] == "resolved" and r["repeats"] >= 2 for r in got)


def test_the_rule_catalogs_agree():
    def catalog(hm):
        return [(r.name, r.subsystem, r.severity, r.env, r.unit)
                for r in hm.default_rules()]
    assert catalog(phm) == catalog(jhm)
    assert phm.SUBSYSTEMS == jhm.SUBSYSTEMS


@pytest.mark.parametrize("name", [
    "H2O3TPU_API_KEY", "H2O3TPU_SECRET", "H2O3TPU_LDAP_PASSWORD",
    "H2O3TPU_AUTH_TOKEN", "H2O3TPU_PRIVATE_CERT", "H2O3TPU_HEALTH_OFF",
    "H2O3TPU_FLIGHT_INTERVAL_SECS"])
def test_redaction_is_the_references(monkeypatch, name):
    monkeypatch.setenv(name, "s3cr3t-value")
    got, want = phm.redacted_config(), jhm.redacted_config()
    assert got[name] == want[name]
    assert (got[name] == "[redacted]") == bool(phm._SECRET_RE.search(name))


def test_the_bundle_has_the_references_members(monkeypatch):
    monkeypatch.setenv("H2O3TPU_PLANTED_API_KEY", "do-not-ship")

    def members(hm):
        body, fname = hm.diagnostic_bundle(
            hm.HealthEvaluator(interval_s=0.1))
        assert fname.endswith(".tar.gz")
        with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
            out = {m.name: tar.extractfile(m).read()
                   for m in tar.getmembers()}
        return out
    got, want = members(phm), members(jhm)
    assert sorted(got) == sorted(want)
    assert not any(n.endswith(".error") for n in got)
    assert b"do-not-ship" not in b"".join(got.values())
    assert b"[redacted]" in got["h2o3_diagnostics/config.json"]


def test_the_sweep_pages_on_retry_exhaustion_and_resolves(monkeypatch):
    """The sweeps are run inline here (an hour's interval keeps the
    server's thread from sweeping; ``/3/Health`` serves the verdict the
    last sweep published), so no test waits on a thread."""
    from h2o3_tpu_torch.api import H2OClient, H2OServer
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.ops.map_reduce import DispatchFailed
    from h2o3_tpu_torch.utils.health import HEALTH
    from h2o3_tpu_torch.utils.incidents import INCIDENTS
    from h2o3_tpu_torch.utils.timeline import inject_faults
    monkeypatch.setenv("H2O3TPU_HEALTH_INTERVAL_SECS", "3600")
    monkeypatch.setenv("H2O3TPU_DISPATCH_BACKOFF_MS", "1")
    HEALTH.reset()
    INCIDENTS.reset()
    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    fr = Frame.from_arrays({"a": X[:, 0], "b": X[:, 1],
                            "y": (X[:, 0] > 0).astype(np.float32)})
    s = H2OServer(port=0).start()
    try:
        c = H2OClient(s.url)
        HEALTH.evaluate()
        assert c.health()["status"] == "healthy"
        with inject_faults(site_rates={"gbm_chunk": {"drop_rate": 1.0}}):
            with pytest.raises(DispatchFailed) as err:
                GBM(ntrees=2, max_depth=2).train(y="y", training_frame=fr)
        assert len(err.value.history) == 4      # the first try + 3 retries
        HEALTH.evaluate()
        v = c.health()
        assert v["status"] == "unhealthy"
        assert any(f["rule"] == "dispatch_retry_exhaustion"
                   for f in v["findings"])
        opened = c.incidents(state="open")
        assert [r["rule"] for r in opened] == ["dispatch_retry_exhaustion"]
        full = c.incident(opened[0]["id"])
        assert full["context"]["logs"] and full["context"]["compute"]
        for _ in range(5):      # the fault cleared: a few sweeps resolve it
            HEALTH.evaluate()
            if not c.incidents(state="open"):
                break
        assert not c.incidents(state="open")
        assert c.incidents(state="resolved")[0]["resolved_at"]
    finally:
        s.stop()
        INCIDENTS.reset()
        HEALTH.reset()
