"""The port's memory meter (``h2o3_tpu_torch/utils/memory.py``) against the
JAX package's (``h2o3_tpu/utils/memory.py``), after
``tests/test_memory.py`` (its REST cases left out). Byte counts differ by
design: the JAX package counts a column at its padded length (a multiple
of 8 rows per device), the port's tensors carry no padding, so a port
column is ``nrows * 4`` bytes where the reference's is ``plen * 4``;
each test states which it checks. The leak detectors of both packages,
fed the same keyed bytes and accesses, flag the same keys for the same
reasons (exact)."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.utils import memory as jmem
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.parse import RawFile
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.utils.memory import (MEMORY, LeakDetector,
                                         array_tree_bytes, device_stats,
                                         fast_device_bytes, host_stats,
                                         value_host_bytes, value_kind_bytes)
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    DKV.clear()
    yield
    DKV.clear()


def _cols(nrows=2000, ncols=3, seed=0):
    rng = np.random.default_rng(seed)
    return {f"x{i}": rng.normal(size=nrows).astype(np.float32)
            for i in range(ncols)}


def test_vec_and_frame_nbytes_unpadded():
    """1001 rows: the port counts 1001 * 4 bytes a column, the reference
    its padded 1024 * 4 (8 CPU devices x 8 rows)."""
    cols = _cols(nrows=1001, ncols=2)
    pf, jf = Frame.from_arrays(cols), JFrame.from_arrays(cols)
    assert [v.nbytes for v in pf.vecs] == [1001 * 4] * 2
    assert [v.nbytes for v in jf.vecs] == [v.plen * 4 for v in jf.vecs]
    assert pf.nbytes == sum(v.nbytes for v in pf.vecs)
    s = np.array(["a", "bb", "ccc"] * 10, dtype=object)
    ps, js = Frame.from_arrays({"s": s}), JFrame.from_arrays({"s": s})
    assert ps.nbytes == 30 * 4 and ps.nbytes < js.nbytes
    host = Frame(["h"], [Vec(None, ps.vec("s").type, host_values=s)])
    assert host.nbytes == s.nbytes == value_host_bytes(host)


def test_value_kind_bytes_dispatch_as_reference():
    pf = Frame.from_arrays(_cols())
    assert value_kind_bytes(pf) == ("frame", pf.nbytes)
    from h2o3_tpu.frame.parse import RawFile as JRawFile
    from h2o3_tpu.models.job import Job as JJob
    for mine, theirs in [(RawFile(b"x" * 100, name="f.csv"),
                          JRawFile(b"x" * 100, name="f.csv")),
                         (Job("j"), JJob("j")), (object(), object())]:
        assert value_kind_bytes(mine) == jmem.value_kind_bytes(theirs)
    from h2o3_tpu_torch.utils.cleaner import SwappedFrame
    assert value_kind_bytes(SwappedFrame("k", "/x", 1, 1, disk_bytes=77)) \
        == ("spilled", 77)


def test_array_tree_bytes_walks_models():
    """A model's arrays and tensors, through dicts, lists and attributes,
    each object once; ``host_only`` leaves card tensors out (on the CPU
    every tensor is on the host)."""
    class Model:
        algo = "gbm"

        def __init__(self):
            w = torch.zeros(10, 4)
            self.output = {"beta": torch.zeros(25), "trees": [w, w],
                           "host": np.zeros(8)}
            self.extra = type("X", (), {})()
            self.extra.t = torch.zeros(3, dtype=torch.int64)

    m = Model()
    assert array_tree_bytes(m) == 25 * 4 + 40 * 4 + 8 * 8 + 3 * 8
    assert value_kind_bytes(m) == ("model", array_tree_bytes(m))
    assert value_host_bytes(m) == array_tree_bytes(m)
    m.output["artifact_bytes"] = 5
    assert value_kind_bytes(m) == ("model", 5)


def test_dkv_registration_and_refresh():
    pf = Frame.from_arrays(_cols(nrows=500, ncols=2))
    DKV.put("fr", pf)
    DKV.put("raw", RawFile(b"y" * 64))
    total, by_kind, n = MEMORY.dkv_totals()
    assert by_kind == {"frame": 4000, "raw": 64} and n == 2
    assert MEMORY.key_bytes("fr") == 4000
    assert MEMORY.dkv_host_bytes() == 64
    pf.add("more", Vec.from_numpy(np.zeros(500, np.float32)))
    assert MEMORY.key_bytes("fr") == 4000        # put saw two columns
    MEMORY.refresh()
    assert MEMORY.key_bytes("fr") == 6000
    assert MEMORY.top_keys(1) == [{"key": "fr", "kind": "frame",
                                   "bytes": 6000}]
    DKV.remove("fr")
    assert MEMORY.dkv_totals()[1] == {"frame": 0, "raw": 64}
    DKV.clear()
    assert MEMORY.dkv_totals() == (0, {}, 0)


def test_host_and_device_stats_on_the_cpu():
    """/proc gives the host numbers; without a card in use the device
    numbers are the bytes of the tensors the DKV's frames hold."""
    h = host_stats()
    assert h["rss_bytes"] > 0 and h["rss_peak_bytes"] >= h["rss_bytes"]
    assert h["total_bytes"] >= h["available_bytes"] > 0
    DKV.put("a", Frame.from_arrays(_cols(nrows=100, ncols=3)))
    d = device_stats()
    assert d["source"] == "keyed_tensors"
    assert d["bytes_in_use"] == 100 * 3 * 4
    assert d["devices"][0]["device"] == "cpu"
    assert fast_device_bytes() is None


def test_watermarks_are_monotonic():
    MEMORY.sample(rss=10, dev=20)
    MEMORY.sample(rss=5, dev=5)
    w = MEMORY.watermarks
    assert w["host_rss_peak_bytes"] >= 10 and w["device_peak_bytes"] >= 20


def _detector_script(det):
    """The same observations for either package's detector; its reports."""
    keyed = {"big": ("frame", 1000), "small": ("frame", 10)}
    out = []
    det.observe(dict(keyed), {"big", "small"})
    for _ in range(3):
        det.observe(dict(keyed), set())
    out.append(det.report())
    det.observe(dict(keyed), {"big"})
    out.append(det.report())
    for b in (100, 200, 300):
        det.observe({"grow": ("frame", b)}, {"grow"})
    out.append(det.report())
    det.observe({}, set())
    out.append((det.report(), det.generation))
    return out


def test_leak_detector_equals_reference():
    mine = _detector_script(LeakDetector(sweeps=2, min_bytes=100))
    theirs = _detector_script(jmem.LeakDetector(sweeps=2, min_bytes=100))
    assert mine == theirs
    assert mine[0][0]["key"] == "big" and mine[0][0]["reasons"] == ["idle"]


def test_meter_leak_sweep_and_idle_streaks():
    pf = Frame.from_arrays(_cols(nrows=300_000, ncols=1, seed=4))
    DKV.put("leaky", pf)
    for _ in range(MEMORY.detector.sweeps + 1):
        MEMORY.leak_sweep()
    assert MEMORY.idle_streaks()["leaky"] == MEMORY.detector.sweeps
    assert any(f["key"] == "leaky" and "idle" in f["reasons"]
               for f in MEMORY.leak_report()["flagged"])
    DKV.get("leaky")
    MEMORY.leak_sweep()
    assert MEMORY.idle_streaks()["leaky"] == 0
    for i in range(MEMORY.detector.sweeps):
        pf.add(f"c{i}", Vec.from_numpy(np.zeros(300_000, np.float32)))
        MEMORY.refresh()
        MEMORY.leak_sweep()
    assert any(f["key"] == "leaky" and "growing" in f["reasons"]
               for f in MEMORY.leak_report()["flagged"])
    s = MEMORY.summary(top_n=3)
    assert s["dkv"]["keys"] == 1 and s["top_keys"][0]["key"] == "leaky"
    assert s["device"]["bytes_in_use"] == pf.nbytes
    assert set(s) == {"host", "device", "dkv", "top_keys", "watermarks",
                      "leaks", "spill"}
