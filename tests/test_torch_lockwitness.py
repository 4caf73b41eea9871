"""The port's lock-order witness (``h2o3_tpu_torch/utils/lockwitness.py``)
against the JAX package's: armed from the environment at creation time,
the same acquisition sequences record the same edges, counts, inversions
and reports, and held-by-thread sets agree; unarmed factories return the
plain ``threading`` primitives. The port names its locks as the reference
does: every name a port module passes to a factory is one the reference
passes at the same place. A witnessed run of the port's DKV, jobs,
scheduler, serving, health and flight records no inversion.
"""

import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from h2o3_tpu.utils import lockwitness as jlw
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import lockwitness as plw
from jax_reference import _jax_compile_cache  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


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
def armed(monkeypatch):
    monkeypatch.setenv("H2O3TPU_LOCKWITNESS", "1")
    plw.WITNESS.reset()
    jlw.WITNESS.reset()
    yield
    plw.WITNESS.reset()
    jlw.WITNESS.reset()


def _sequence(lw):
    a, b = lw.lock("t.A"), lw.lock("t.B")
    r = lw.rlock("t.R")
    cond = lw.condition("t.C")
    with a:
        with b:
            pass
    with b:                      # the other order: an inversion
        with a:
            pass
    with r:
        with r:                  # reentrant: no self edge
            with a:
                pass
    with cond:
        cond.notify_all()
        assert cond.wait(timeout=0.001) is False
    a.acquire()
    b.acquire()
    a.release()                  # out-of-order release keeps b held
    held = lw.WITNESS.held_by_thread()
    b.release()

    def worker():
        with b:
            with cond:
                pass
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    return lw.WITNESS.report(), lw.WITNESS.inversions(), list(held.values())


def test_the_same_acquisitions_give_the_same_reports(armed):
    got, want = _sequence(plw), _sequence(jlw)
    assert got == want
    report, inversions, held = got
    assert inversions == [("t.A", "t.B")]
    assert "t.R->t.R" not in report["edges"]
    assert held == [["t.B"]]


def test_unarmed_factories_are_plain_primitives(monkeypatch):
    monkeypatch.delenv("H2O3TPU_LOCKWITNESS", raising=False)
    assert type(plw.lock("x")) is type(threading.Lock())
    assert type(plw.rlock("x")) is type(threading.RLock())
    assert isinstance(plw.condition("x"), threading.Condition)
    monkeypatch.setenv("H2O3TPU_LOCKWITNESS", "1")
    assert not isinstance(plw.lock("x"), type(threading.Lock()))


def test_validate_against_a_static_graph(armed):
    _sequence(plw)
    out = plw.WITNESS.validate({("t.A", "t.B")}, {"t.A", "t.B"})
    assert "t.B->t.A" in out["missing_from_static"]
    assert "t.R" in out["unknown_locks"]


_FACTORY = re.compile(r'lockwitness\.(?:lock|rlock|condition)\(\s*"([^"]+)"')


def _names(pkg: str) -> dict[str, set[str]]:
    out = {}
    for path in (ROOT / pkg).rglob("*.py"):
        rel = path.relative_to(ROOT / pkg).as_posix()
        found = set(_FACTORY.findall(path.read_text()))
        if found:
            out[rel] = found
    return out


def test_the_ports_lock_names_are_the_references():
    port, ref = _names("h2o3_tpu_torch"), _names("h2o3_tpu")
    assert len(port) >= 18
    for rel, names in port.items():
        assert names <= ref.get(rel, set()), (rel, names - ref.get(rel, set()))


def test_a_witnessed_run_of_the_port_has_no_inversion(armed):
    # locks are witnessed from their creation: build fresh instances
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
    from h2o3_tpu_torch.serving.service import ScoringService
    from h2o3_tpu_torch.utils.flight import FlightRecorder
    from h2o3_tpu_torch.utils.health import HealthEvaluator
    from h2o3_tpu_torch.utils.incidents import IncidentLog
    from h2o3_tpu_torch.utils.registry import DKV
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 2)).astype(np.float32)
    fr = Frame.from_arrays({"a": X[:, 0], "b": X[:, 1],
                            "y": np.where(X[:, 0] > 0, "p", "n")
                            .astype(object)}, key="lw_fr")
    DKV.put("lw_fr", fr)
    with MeshScheduler(slices=2).lease():
        m = GBM(ntrees=2, max_depth=2, seed=1, model_id="lw_gbm").train(
            y="y", training_frame=fr)
    svc = ScoringService()
    out = svc.score(m.key, [{"a": 0.5, "b": -1.0}])
    assert out["rows"] == 1
    svc.reset()
    ev = HealthEvaluator(interval_s=0.1, incidents=IncidentLog(capacity=8))
    ev.evaluate()
    rec = FlightRecorder(interval_s=1.0)
    rec.sample_once(now=1.0)
    assert plw.WITNESS.acquisitions() > 0
    assert plw.WITNESS.inversions() == []
