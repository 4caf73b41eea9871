"""The port's black box (``h2o3_tpu_torch/utils/blackbox.py``) against the
JAX package's: on one stepped monotonic clock both watchdogs call the same
heartbeat wedged at the same moment (the deadline scales with the watched
period); a dump is written exactly once per instance, with the same
members, parseable, and with secret-looking knobs redacted in its raw
bytes; arming honours ``H2O3TPU_BLACKBOX_OFF``, and an orderly disarm
never dumps. The wedge is also driven end to end, as the reference's
chaos harness drives it: a REST accept loop stalled by an injected fault
is detected and dumped once.
"""

import io
import json
import tarfile
import time

import pytest
import torch

from h2o3_tpu.utils import blackbox as jbb
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import blackbox as pbb
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


def _timeline(bb, monkeypatch):
    """Beats and silences on a stepped monotonic clock; the wedged() reading
    after every step."""
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    box = bb.BlackBox(dump_dir=None)
    box.stall_secs = 2.0
    box.watch("rest_accept", period_s=0.5)     # deadline max(2, 4) = 4 s
    box.watch("health_sweep", period_s=0.1)    # deadline 2 s
    box.beat("unwatched")                      # ignored
    out = []
    for dt, beats in ((1.0, ("rest_accept", "health_sweep")),
                      (1.5, ("rest_accept",)), (1.0, ()), (2.5, ()),
                      (0.5, ("health_sweep",)), (4.2, ())):
        now[0] += dt
        for b in beats:
            box.beat(b)
        out.append(box.wedged())
    return out


def test_the_same_heartbeats_give_the_same_wedges(monkeypatch):
    got = _timeline(pbb, monkeypatch)
    want = _timeline(jbb, monkeypatch)
    assert got == want
    assert got[0] is None and any(w is not None for w in got)
    assert {w[0] for w in got if w} == {"health_sweep", "rest_accept"}


def _members(path):
    with tarfile.open(path, "r:gz") as tar:
        return {m.name.split("/", 1)[1]: tar.extractfile(m).read()
                for m in tar.getmembers()}


def test_a_dump_fires_once_with_the_references_members(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("H2O3TPU_BLACKBOX_TEST_API_KEY", "hush-hush")
    paths = {}
    for name, bb in (("port", pbb), ("jax", jbb)):
        box = bb.BlackBox(dump_dir=str(tmp_path / name))
        box.watch("rest_accept", period_s=1.0)
        paths[name] = box.dump("wedge", {"heartbeat": "rest_accept"})
        assert paths[name] and box.fired()
        assert box.dump("again") is None          # exactly once
        assert box.last_dump() == paths[name]
    got, want = _members(paths["port"]), _members(paths["jax"])
    assert sorted(got) == sorted(want)
    assert not any(n.endswith(".error") for n in got)
    reason = json.loads(got["reason.json"])
    assert reason["reason"] == "wedge" and "rest_accept" in reason["watched"]
    assert b"hush-hush" not in b"".join(got.values())
    threads = json.loads(got["threads.json"])
    assert any("MainThread" in json.dumps(t) for t in threads)


def test_a_sick_member_is_isolated(tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("sick registry")
    monkeypatch.setattr(pbb, "DUMP_MEMBERS",
                        (("flight.json", boom),) + pbb.DUMP_MEMBERS[1:])
    path = pbb.BlackBox(dump_dir=str(tmp_path)).dump("wedge")
    names = _members(path)
    assert "flight.json.error" in names and "traces.json" in names


def test_off_never_arms_and_orderly_disarm_never_dumps(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("H2O3TPU_BLACKBOX_OFF", "1")
    box = pbb.BlackBox(dump_dir=str(tmp_path))
    assert box.arm() is False and not box.armed()
    monkeypatch.delenv("H2O3TPU_BLACKBOX_OFF")
    monkeypatch.setenv("H2O3TPU_BLACKBOX_CHECK_SECS", "0.05")
    assert box.arm() is True and box.armed()
    box.watch("rest_accept", period_s=0.05)
    box.beat("rest_accept")
    box.disarm()
    box._on_exit()                      # an exit after disarm: no dump
    assert not box.fired() and list(tmp_path.iterdir()) == []


def test_a_stalled_accept_loop_is_dumped_once(tmp_path, monkeypatch):
    """The accept loop stalled by an injected fault goes silent past its
    deadline; the watchdog's check (called here, its thread's cadence set
    past the test) reads the wedge and dumps once."""
    from h2o3_tpu_torch.api import H2OServer
    from h2o3_tpu_torch.utils.blackbox import BLACKBOX
    from h2o3_tpu_torch.utils.timeline import inject_faults
    monkeypatch.setenv("H2O3TPU_BLACKBOX_STALL_SECS", "0.05")
    monkeypatch.setenv("H2O3TPU_BLACKBOX_CHECK_SECS", "3600")
    monkeypatch.setenv("H2O3TPU_HEALTH_OFF", "1")
    monkeypatch.setattr(BLACKBOX, "_dump_dir", str(tmp_path))
    BLACKBOX.reset()
    s = H2OServer(port=0).start()
    try:
        BLACKBOX.watch("rest_accept", period_s=0.005)
        with inject_faults(site_rates={"rest.accept": {
                "stall_rate": 1.0, "stall_ms": 2000}}) as inj:
            time.sleep(0.12)
            wedge = BLACKBOX.wedged()
            inj.release_stalls()
        assert wedge is not None and wedge[0] == "rest_accept"
        path = BLACKBOX.dump(f"wedge:{wedge[0]}",
                             detail={"heartbeat": wedge[0]})
        assert BLACKBOX.dump("again") is None
        assert list(tmp_path.glob("h2o3_postmortem_*.tar.gz")) == \
            [tmp_path / path.rsplit("/", 1)[1]]
        reason = json.loads(_members(path)["reason.json"])
        assert reason["detail"]["heartbeat"] == "rest_accept"
    finally:
        s.stop()
        BLACKBOX.reset()
