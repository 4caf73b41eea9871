"""The port's ops plane (``h2o3_tpu_torch/ops_plane/``) against the JAX
package's: on a stepped monotonic clock, the same QPS, device-second and
byte quotas admit and shed the same requests with the same retry hints;
the remediation engine maps the same rules to the same actions under the
same modes and cooldowns; the action log records, observes, fails and
rolls back alike. Then the port's REST surface: a QPS quota on
``X-H2O3-Tenant`` answers the third post with 429 and ``Retry-After``,
scoring under ``tenant_scope`` charges device-seconds, and a
``serving_shed_rate`` incident in ``act`` mode widens the resident model's
admission target 50 → 75 until the action is rolled back.
"""

import itertools
import time
import uuid

import numpy as np
import pytest
import torch

from h2o3_tpu.ops_plane import actions as jact
from h2o3_tpu.ops_plane import remediate as jrem
from h2o3_tpu.ops_plane import tenancy as jten
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.ops_plane import actions as pact
from h2o3_tpu_torch.ops_plane import remediate as prem
from h2o3_tpu_torch.ops_plane import tenancy as pten
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
    state = {}

    def reset():
        state["t"] = 5_000.0
        state["ids"] = itertools.count(1)

    class _U:
        def __init__(self, n):
            self.hex = (f"{n:06x}" * 6)[:32]

    monkeypatch.setattr(time, "monotonic", lambda: state["t"])
    monkeypatch.setattr(time, "time", lambda: state["t"])
    monkeypatch.setattr(uuid, "uuid4", lambda: _U(next(state["ids"])))

    def step(s):
        state["t"] += s
    reset.step = step
    reset()
    return reset


def _quota_run(ten, clock):
    clock()
    q = ten.QuotaManager()
    q.set_quota("team-a", qps=2)
    q.set_quota("team-b", device_seconds=0.5)
    out = []
    for i in range(8):
        clock.step(0.2)
        for tenant in ("team-a", "team-b", "default", "nobody"):
            try:
                q.admit(tenant)
                out.append((i, tenant, "ok"))
            except ten.QuotaExceeded as e:
                out.append((i, tenant, e.dimension,
                            round(e.retry_after_s, 6)))
        q.charge_device_seconds("team-b", 0.2)
    return out, q.usage_all(), q.quotas(), q.coldest_tenant()


def test_the_same_traffic_meets_the_same_quotas(clock):
    got, want = _quota_run(pten, clock), _quota_run(jten, clock)
    assert got == want
    assert any(r[2] == "qps" for r in got[0] if len(r) == 4)
    assert any(r[2] == "device_seconds" for r in got[0] if len(r) == 4)


@pytest.mark.parametrize("raw", [None, "", "team-a", "Team_B.9", "x" * 64,
                                 "x" * 65, "bad tenant", "../etc", "é"])
def test_tenant_names_are_sanitised_alike(raw):
    def run(ten):
        try:
            return ten.sanitize_tenant(raw)
        except ValueError as e:
            return ("refused", str(e))
    assert run(pten) == run(jten)


def _engine_run(act, rem, monkeypatch, clock, mode):
    clock()
    monkeypatch.setenv("H2O3TPU_REMEDIATE", mode)
    monkeypatch.setenv("H2O3TPU_OPS_COOLDOWN_SECS", "30")
    log = act.ActionLog(capacity=16)
    eng = rem.RemediationEngine(actions=log)
    for rule in ("serving_shed_rate", "serving_p99_slo",
                 "memory_spill_thrash", "compute_recompile_storm",
                 "elastic_heartbeat_gap", "dispatch_retry_exhaustion",
                 "serving_shed_rate"):
        clock.step(10.0)
        eng.on_incident({"rule": rule, "id": f"inc_{rule}"}, None)
    log.record("no_such_action", "r", None, "act")
    return ([{k: r[k] for k in r if k != "at_ms"} for r in log.list()],
            eng.policy_view())


@pytest.mark.parametrize("mode", ["off", "observe", "act", "bogus"])
def test_the_same_incidents_give_the_same_actions(monkeypatch, clock, mode):
    got = _engine_run(pact, prem, monkeypatch, clock, mode)
    want = _engine_run(jact, jrem, monkeypatch, clock, mode)
    assert got == want
    if mode == "act":
        outcomes = {r["action"]: r["outcome"] for r in got[0]}
        assert outcomes["reassign_shards"] == "skipped"
        assert outcomes["no_such_action"] == "failed"


def _frame_and_gbm():
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.utils.registry import DKV
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 3)).astype(np.float32)
    fr = Frame.from_arrays({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                            "y": np.where(X[:, 0] > 0, "p", "n")
                            .astype(object)}, key="ops_fr")
    DKV.put("ops_fr", fr)
    m = GBM(ntrees=2, max_depth=2, seed=1, model_id="ops_gbm").train(
        y="y", training_frame=fr)
    rows = [{"a": float(X[i, 0]), "b": float(X[i, 1]), "c": float(X[i, 2])}
            for i in range(4)]
    return m, rows


def test_a_qps_quota_answers_429_with_retry_after(monkeypatch):
    import urllib.error
    import urllib.request

    from h2o3_tpu_torch.api import H2OClient, H2OServer
    from h2o3_tpu_torch.ops_plane import QUOTAS
    QUOTAS.reset()
    s = H2OServer(port=0).start()
    try:
        c = H2OClient(s.url)
        c.set_quota("team-a", qps=2)

        def post(tenant):
            req = urllib.request.Request(
                s.url + "/3/PostFile?destination_frame=q.raw",
                data=b"a,b\n1,2\n", method="POST",
                headers={"X-H2O3-Tenant": tenant})
            try:
                with urllib.request.urlopen(req) as r:
                    return r.status, None
            except urllib.error.HTTPError as e:
                return e.code, e.headers.get("Retry-After")
        codes = [post("team-a") for _ in range(3)]
        assert [c_[0] for c_ in codes] == [200, 200, 429]
        assert int(codes[2][1]) >= 1
        assert [post("team-z")[0] for _ in range(3)] == [200, 200, 200]
        ops = c.ops()
        assert any(t["tenant"] == "team-a" and t["shed"]
                   for t in ops["tenants"])
    finally:
        s.stop()
        QUOTAS.reset()


def test_scoring_charges_device_seconds_and_relief_widens(monkeypatch):
    from h2o3_tpu_torch.api import H2OClient, H2OServer
    from h2o3_tpu_torch.ops_plane import ACTIONS, ENGINE, QUOTAS
    from h2o3_tpu_torch.ops_plane.tenancy import tenant_scope
    from h2o3_tpu_torch.serving import SCORING
    from h2o3_tpu_torch.utils.incidents import INCIDENTS
    monkeypatch.setenv("H2O3TPU_REMEDIATE", "act")
    monkeypatch.setenv("H2O3TPU_HEALTH_OFF", "1")
    for reg in (QUOTAS, ACTIONS, ENGINE, INCIDENTS):
        reg.reset()
    SCORING.reset()
    m, rows = _frame_and_gbm()
    s = H2OServer(port=0).start()
    try:
        c = H2OClient(s.url)
        with tenant_scope("team-b"):
            SCORING.score(m.key, rows, slo_ms=50)
        assert QUOTAS.usage("team-b")["device_seconds_total"] > 0
        iid = INCIDENTS.open("serving_shed_rate", "serving", "degraded",
                             "shed", 0.4, 0.05)
        rec = INCIDENTS.get(iid)
        assert rec["action_id"]
        act = next(a for a in c.ops()["actions"]
                   if a["id"] == rec["action_id"])
        assert (act["action"], act["outcome"]) == ("serving_relief",
                                                   "applied")
        target = next(r["slo"]["target_ms"] for r in SCORING.stats()[
            "resident"] if r["model"] == m.key)
        assert target == 75.0
        assert c.rollback_action(rec["action_id"]) is True
        target = next(r["slo"]["target_ms"] for r in SCORING.stats()[
            "resident"] if r["model"] == m.key)
        assert target == 50.0
        INCIDENTS.resolve("serving_shed_rate")
        done = c.incidents(state="resolved")
        assert done[0]["resolved_at"] and done[0]["action_id"] == act["id"]
    finally:
        s.stop()
        SCORING.reset()
        for reg in (QUOTAS, ACTIONS, ENGINE, INCIDENTS):
            reg.reset()
