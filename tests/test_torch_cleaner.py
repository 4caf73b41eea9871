"""The port's Cleaner (``h2o3_tpu_torch/utils/cleaner.py``) and its DKV
hooks (``utils/registry.py``), after the reference's Cleaner tests in
``tests/test_ingest.py`` and ``tests/test_binfmt_cleaner.py``: under a
budget a sweep first drops the derived tensors of compressed columns, then
spills the coldest frames and raw uploads behind stubs whose bytes stay
registered as ``spilled``; ``DKV.get`` faults them back in (exact values);
a remove deletes a spilled key's snapshot; ``DKV.get`` racing sweeps never
hands out a stub. The reference's victim order (idle streak, then LRU) is
compared with the port's on the same sequence of puts and gets, and a GBM
trained on a frame faulted back in equals, bit for bit, the GBM trained on
it before the spill."""

import os
import threading

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.utils import cleaner as jclean
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.parse import RawFile
from h2o3_tpu_torch.ingest import stream_import
from h2o3_tpu_torch.utils.cleaner import (CLEANER, SwappedFrame,
                                          SwappedValue, disable_cleaner,
                                          enable_cleaner)
from h2o3_tpu_torch.utils.memory import MEMORY
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import heaps_equal, same_frame


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    DKV.clear()
    yield
    disable_cleaner()
    jclean.disable_cleaner()
    DKV.clear()


def _cols(rng, n=4096, ncols=4):
    return {f"c{i}": rng.normal(size=n).astype(np.float32)
            for i in range(ncols)}


def _mk(key, rng, n=4096):
    f = Frame.from_arrays(_cols(rng, n), key=key)
    DKV.put(key, f)
    return f


def _stub(key):
    with DKV._lock:
        return DKV._store.get(key)


def test_view_drops_before_spilling(tmp_path, rng):
    """Tier 1: with every compressed column built, a budget between the
    compressed and the built size is met by dropping views alone."""
    p = tmp_path / "v.csv"
    p.write_text("a,b,k\n" + "".join(
        f"{i % 90},{rng.normal():.5f},k{i % 5}\n" for i in range(4096)))
    fr = stream_import(str(p), key="v.hex", chunk_rows=1024)
    for v in fr.vecs:
        _ = v.data
    built = fr.nbytes
    enable_cleaner(built - 1000, ice_root=str(tmp_path / "ice"))
    base = CLEANER.stats()
    assert CLEANER.sweep() == []
    st = CLEANER.stats()
    assert st["view_drops"] - base["view_drops"] == 1
    assert st["view_drop_bytes"] - base["view_drop_bytes"] == 4096 * 12
    assert not any(v.device_resident for v in fr.vecs)
    assert isinstance(_stub("v.hex"), Frame)
    assert MEMORY.key_bytes("v.hex") == fr.nbytes == built - 4096 * 12


def test_spill_order_equals_reference(tmp_path, rng):
    """The same puts and gets under budgets of three frames' bytes (the
    port's unpadded, the reference's padded) spill the same keys."""
    cols = {k: _cols(rng) for k in ("a", "b", "c", "d")}
    enable_cleaner(3 * 4096 * 16, ice_root=str(tmp_path / "p"))
    jclean.enable_cleaner(3 * 4096 * 16, ice_root=str(tmp_path / "j"))
    got, want = [], []
    for store, F, out in ((DKV, Frame, got), (JDKV, JFrame, want)):
        for k in ("a", "b", "c"):
            store.put(k, F.from_arrays(cols[k], key=k))
        store.get("a")
        store.put("d", F.from_arrays(cols["d"], key="d"))
        out.append(sorted(k for k, v in store.raw_items()
                          if type(v).__name__ == "SwappedFrame"))
    assert got == want == [["b"]]


def test_spilled_kind_reconciles_memory_view(tmp_path, rng):
    enable_cleaner(150_000, ice_root=str(tmp_path))
    base = CLEANER.stats()
    _mk("fr_a", rng)
    _mk("fr_b", rng)
    DKV.get("fr_b")
    _mk("fr_c", rng)
    stub = _stub("fr_a")
    assert isinstance(stub, SwappedFrame) and stub.disk_bytes > 0
    assert stub.device == torch.device("cpu")
    s = MEMORY.summary(refresh=True)
    assert s["dkv"]["by_kind"]["spilled"] == stub.disk_bytes
    assert any(r["key"] == "fr_a" and r["kind"] == "spilled"
               for r in s["top_keys"])
    sp = s["spill"]
    assert sp["spill_count"] - base["spill_count"] == 1
    assert sp["spill_bytes"] - base["spill_bytes"] == 4096 * 16
    assert [r["key"] for r in sp["spilled_keys"]] == ["fr_a"]


def test_fault_in_restores_values_and_retires_snapshot(tmp_path, rng):
    enable_cleaner(150_000, ice_root=str(tmp_path))
    base = CLEANER.stats()["restore_count"]
    want = _mk("fa", rng).vec("c0").to_numpy().copy()
    _mk("fb", rng)
    _mk("fc", rng)
    stub = _stub("fa")
    assert os.path.exists(stub.path)
    back = DKV["fa"]
    assert isinstance(back, Frame) and back.key == "fa"
    np.testing.assert_array_equal(back.vec("c0").to_numpy(), want)
    assert not os.path.exists(stub.path)
    assert CLEANER.stats()["restore_count"] - base == 1


def test_raw_value_spill_and_fault_in(tmp_path, rng):
    enable_cleaner(150_000, ice_root=str(tmp_path))
    payload = bytes(rng.integers(0, 256, size=120_000, dtype=np.uint8))
    DKV.put("up1", RawFile(payload, name="big.csv"))
    _mk("fr_hot", rng)
    stub = _stub("up1")
    assert isinstance(stub, SwappedValue) and stub.disk_bytes == len(payload)
    back = DKV["up1"]
    assert isinstance(back, RawFile) and back.data == payload
    assert back.name == "big.csv"


def test_removed_or_overwritten_spilled_key_deletes_snapshot(tmp_path, rng):
    enable_cleaner(150_000, ice_root=str(tmp_path))
    for k in ("g_a", "g_b", "g_c", "g_d"):
        _mk(k, rng)
    stubs = [v for _k, v in DKV.raw_items() if isinstance(v, SwappedFrame)]
    assert len(stubs) == 2 and all(os.path.exists(s.path) for s in stubs)
    assert DKV.remove(stubs[0].key) is None
    assert not os.path.exists(stubs[0].path)
    disable_cleaner()
    DKV.put(stubs[1].key, Frame.from_arrays(_cols(rng, 8)))
    assert not os.path.exists(stubs[1].path)
    assert os.listdir(tmp_path) == []


def test_force_spill_and_clear(tmp_path, rng):
    enable_cleaner(10**9, ice_root=str(tmp_path))
    _mk("x1", rng)
    _mk("x2", rng)
    DKV.put("m", object())
    assert CLEANER.force_spill(["m", "x1", "x2"], limit=1) == ["x1"]
    assert isinstance(_stub("x1"), SwappedFrame)
    DKV.clear()
    assert os.listdir(tmp_path) == []


def test_dkv_get_races_cleaner_sweep(tmp_path, rng):
    """Four threads get two keys while each get spills the other: no
    caller ever receives a stub, and the values stay exact."""
    enable_cleaner(70_000, ice_root=str(tmp_path))
    base = CLEANER.stats()["spill_count"]
    want = {k: _mk(k, rng).vec("c0").to_numpy().copy()
            for k in ("race_a", "race_b")}
    errors, stop = [], threading.Event()

    def hammer(key):
        try:
            while not stop.is_set():
                got = DKV.get(key)
                assert isinstance(got, Frame), f"stub escaped: {got!r}"
                np.testing.assert_array_equal(got.vec("c0").to_numpy(),
                                              want[key])
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=hammer, args=(k,), daemon=True)
               for k in want for _ in range(2)]
    for t in threads:
        t.start()
    stop.wait(timeout=2.0)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    assert not errors, errors[0]
    assert CLEANER.stats()["spill_count"] - base > 2


def test_gbm_on_faulted_in_frame_equals_before(tmp_path, rng):
    """A GBM on a frame that was spilled and faulted back in (a streamed
    frame, whose columns come back eager) equals the GBM on it before."""
    from h2o3_tpu_torch.models.gbm import GBM
    n = 2000
    x = rng.normal(size=n)
    k = rng.integers(0, 6, n)
    y = (x + 0.4 * k + rng.normal(size=n)) > 1
    p = tmp_path / "g.csv"
    p.write_text("x,k,y\n" + "".join(f"{a:.5f},k{b},{'Y' if c else 'N'}\n"
                                     for a, b, c in zip(x, k, y)))
    fr = stream_import(str(p), key="g.hex")
    kw = dict(ntrees=3, max_depth=3, nbins=16, seed=3)
    before = GBM(**kw).train(y="y", training_frame=fr)
    enable_cleaner(1, ice_root=str(tmp_path / "ice"))
    assert "g.hex" in CLEANER.sweep()
    assert isinstance(_stub("g.hex"), SwappedFrame)
    back = DKV["g.hex"]
    assert back is not fr and back.vec("x").compressed is None
    same_frame(back, fr)
    after = GBM(**kw).train(y="y", training_frame=back)
    assert heaps_equal(before, after)
