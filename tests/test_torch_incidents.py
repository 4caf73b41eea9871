"""The port's incident log (``h2o3_tpu_torch/utils/incidents.py``) against
the JAX package's: on a stepped clock with injected ids, the same opens,
repeats, resolutions, action stamps and evictions give the same records
and the same ``h2o3_incidents_total`` counts; one incident per rule, the
ring bounded with open incidents spared; rising-edge listeners fire once
per episode and a raising listener is isolated; the trip-time context
carries every pillar, and the flight window when the recorder holds one.
"""

import itertools
import time
import uuid

import pytest
import torch

from h2o3_tpu.utils import incidents as jim
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import incidents as pim
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
def clock(monkeypatch):
    state = {}

    def reset():
        state["t"] = 1_700_000_000.0
        state["ids"] = itertools.count(1)

    class _U:
        def __init__(self, n):
            self.hex = (f"{n:06x}" * 6)[:32]

    monkeypatch.setattr(time, "time", lambda: state["t"])
    monkeypatch.setattr(uuid, "uuid4", lambda: _U(next(state["ids"])))

    def step(s=1.0):
        state["t"] += s
    reset.step = step
    return reset


def _episodes(im, clock):
    """Opens, repeats, resolves, a stamp and evictions on one log."""
    clock()
    log = im.IncidentLog(capacity=4)
    seen = []
    log.add_listener(lambda rec, lg: seen.append((rec["rule"],
                                                  rec["repeats"])))
    log.add_listener(lambda rec, lg: 1 / 0)      # isolated
    ids = []
    for i, (rule, sub) in enumerate([("serving_shed_rate", "serving"),
                                     ("serving_shed_rate", "serving"),
                                     ("memory_spill_thrash", "memory"),
                                     ("serving_shed_rate", "serving")]):
        clock.step()
        ids.append(log.open(rule, sub, "degraded", f"trip {i}",
                            float(i), 0.05, series=[float(i)]))
    log.annotate_action(ids[0], "act_0001")
    clock.step()
    log.resolve("serving_shed_rate")
    log.resolve("never_opened")
    clock.step()
    log.open("serving_shed_rate", "serving", "degraded", "again", 9.0, 0.05)
    for k in range(5):          # evicts the oldest resolved first
        clock.step()
        log.open(f"rule_{k}", "compute", "degraded", "m", k, 0)
        log.resolve(f"rule_{k}")
    recs = [{k: r[k] for k in r if k != "context"} for r in log.list()]
    return recs, log.list("open"), log.open_rules(), seen, log


def test_the_same_episodes_give_the_same_records(clock):
    got, want = _episodes(pim, clock), _episodes(jim, clock)
    assert got[0] == want[0]
    assert [r["id"] for r in got[1]] == [r["id"] for r in want[1]]
    assert got[2] == want[2] and got[3] == want[3]
    assert len(got[0]) == 4
    assert got[3] == [("serving_shed_rate", 1), ("memory_spill_thrash", 1),
                      ("serving_shed_rate", 1), ("rule_0", 1), ("rule_1", 1),
                      ("rule_2", 1), ("rule_3", 1), ("rule_4", 1)]


def test_state_filter_and_unknown_ids(clock):
    *_, log = _episodes(pim, clock)
    with pytest.raises(ValueError):
        log.list("bogus")
    with pytest.raises(KeyError):
        log.get("inc_nope")
    assert all(r["status"] == "resolved" for r in log.list("resolved"))


def test_the_context_carries_every_pillar():
    log = pim.IncidentLog(capacity=8)
    iid = log.open("compute_recompile_storm", "compute", "degraded", "s",
                   7.0, 2.0, series=[1.0, 3.0, 7.0])
    ctx = log.get(iid)["context"]
    assert ctx["series"] == [1.0, 3.0, 7.0]
    assert isinstance(ctx["logs"], list) and isinstance(ctx["traces"], list)
    assert "top_keys" in ctx["memory"] and "loops" in ctx["compute"]
    jlog = jim.IncidentLog(capacity=8)
    jctx = jlog.get(jlog.open("compute_recompile_storm", "compute",
                              "degraded", "s", 7.0, 2.0))["context"]
    assert set(ctx) == set(jctx)


def test_the_flight_window_rides_in_the_context():
    from h2o3_tpu_torch.utils.flight import FLIGHT
    FLIGHT.reset()
    for i in range(6):
        FLIGHT.ingest("health.rule.memory_leak_growth", float(i),
                      now=1000.0 + i)
    log = pim.IncidentLog(capacity=8)
    ctx = log.get(log.open("memory_leak_growth", "memory", "degraded", "m",
                           5.0, 0.0))["context"]
    assert ctx["flight_window"]["samples"][-1] == [1005.0, 5.0]
    FLIGHT.reset()


def test_opens_are_counted_per_rule_and_subsystem():
    def count(rule):
        return sum(c.value for labels, c in pim.INCIDENTS_TOTAL.children()
                   if labels["rule"] == rule)
    before = count("dispatch_retry_exhaustion")
    log = pim.IncidentLog(capacity=8)
    log.open("dispatch_retry_exhaustion", "dispatch", "unhealthy", "x", 1, 0)
    log.open("dispatch_retry_exhaustion", "dispatch", "unhealthy", "x", 2, 0)
    assert count("dispatch_retry_exhaustion") == before + 1
