"""The port's frame snapshots and CSV export (``h2o3_tpu_torch/persist/
frame_io.py``) against the JAX package's (``h2o3_tpu/persist/
frame_io.py``), after ``tests/test_persist.py``: a frame of every column
type (NUM, INT, CAT with NA, TIME with exact millisecond values, STR with
None) made from a numpy seed survives ``save_frame``/``load_frame``
exactly; a snapshot written by either package loads in the other, both
ways, with the same names, types, domains and values (exact; TIME as
float64 ms, within 1 ms where the JAX package loads it); ``export_file``
writes the JAX package's bytes, and ``import_file`` of the export gives
back the frame."""

import os

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.types import VecType as JType
from h2o3_tpu.frame.vec import Vec as JVec
from h2o3_tpu.persist import frame_io as jio
from h2o3_tpu_torch import (export_file, import_file, load_frame,
                            save_frame, set_device)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.persist import frame_io
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import same_frame


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
    yield
    DKV.clear()


def _columns(rng, n=300):
    num = rng.normal(size=n).astype(np.float32)
    num[::9] = np.nan
    cats = np.array([None if i % 7 == 0 else f"lv{i % 4}" for i in range(n)],
                    dtype=object)
    ms = (1.6e12 + rng.integers(0, 10**9, n) * 1000.0
          + rng.integers(0, 1000, n)).astype(np.float64)
    ms[::11] = np.nan
    strs = np.array([None if i % 5 == 0 else f"s,{i}\"q" for i in range(n)],
                    dtype=object)
    ints = rng.integers(-3, 40, n).astype(np.float32)
    return num, cats, ms, strs, ints


def _dt(ms):
    out = np.full(len(ms), np.datetime64("NaT"), "datetime64[ms]")
    ok = ~np.isnan(ms)
    out[ok] = ms[ok].astype(np.int64).view("datetime64[ms]")
    return out


def _port_frame(rng, key=None):
    num, cats, ms, strs, ints = _columns(rng)
    base = Frame.from_arrays({"num": num, "cat": cats, "int": ints})
    return Frame(["num", "cat", "t", "s", "int"],
                 [base.vec("num"), base.vec("cat"),
                  Vec.from_numpy(_dt(ms), type=VecType.TIME),
                  Vec.from_numpy(strs, type=VecType.STR), base.vec("int")],
                 key=key)


def _jax_frame(rng):
    num, cats, ms, strs, ints = _columns(rng)
    base = JFrame.from_arrays({"num": num, "cat": cats, "int": ints})
    return JFrame(["num", "cat", "t", "s", "int"],
                  [base.vec("num"), base.vec("cat"),
                   JVec.from_numpy(_dt(ms), type=JType.TIME),
                   JVec(None, JType.STR, len(strs), host_values=strs),
                   base.vec("int")])


def _alike(a, b, ms_atol=0.0):
    """Frames of either package: the device columns by same_frame, TIME
    as float64 ms (exact unless ``ms_atol``), STR by value."""
    same_frame(a[["num", "cat", "int"]], b[["num", "cat", "int"]])
    assert str(a.vec("t").type) == str(b.vec("t").type) == "time"
    np.testing.assert_allclose(np.asarray(a.vec("t").to_numpy())[:a.nrows],
                               np.asarray(b.vec("t").to_numpy())[:b.nrows],
                               rtol=0, atol=ms_atol)
    assert list(a.vec("s").host_values[:a.nrows]) == \
        list(b.vec("s").host_values[:b.nrows])
    assert str(a.vec("s").type) == str(b.vec("s").type) == "string"


def test_snapshot_round_trip(tmp_path, rng):
    fr = _port_frame(rng)
    path = save_frame(fr, str(tmp_path / "snap"))
    assert sorted(os.listdir(path)) == ["columns.npz", "frame.json"]
    assert frame_io.snapshot_bytes(path) > 0
    back = load_frame(path, key="back")
    _alike(fr, back)
    assert DKV.get("back") is back
    assert back.vec("t").time_offset == fr.vec("t").time_offset


def test_snapshots_load_across_packages(tmp_path, rng):
    """A snapshot of the JAX package loads in the port, and the port's in
    the JAX package; each equals the frame it was written from. The JAX
    package's ``load_frame`` rebuilds TIME through ``ms_to_datetime64``,
    which truncates the exact ms to whole ms (ROADMAP queue C), so that
    direction holds TIME within 1 ms; the port keeps the exact ms."""
    jf = _jax_frame(rng)
    jio.save_frame(jf, str(tmp_path / "from_jax"))
    _alike(load_frame(str(tmp_path / "from_jax")), jf)
    pf = _port_frame(np.random.default_rng(3))
    save_frame(pf, str(tmp_path / "from_port"))
    _alike(jio.load_frame(str(tmp_path / "from_port")), pf, ms_atol=1.0)
    with open(tmp_path / "from_port" / "frame.json", "w") as fh:
        fh.write('{"magic": "other"}')
    with pytest.raises(ValueError, match="not a frame snapshot"):
        load_frame(str(tmp_path / "from_port"))


def test_export_writes_reference_bytes_and_reimports(tmp_path, rng):
    cols = {"a": rng.normal(size=60).astype(np.float32),
            "k": np.array([None if i % 6 == 0 else f"l{i % 3}"
                           for i in range(60)], dtype=object),
            "n": rng.integers(0, 9, 60).astype(np.float32)}
    cols["a"][::7] = np.nan
    pf = Frame.from_arrays(cols)
    p, j = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    assert export_file(pf, p) == p
    jio.export_file(JFrame.from_arrays(cols), j)
    assert open(p, "rb").read() == open(j, "rb").read()
    same_frame(import_file(p), pf)
    export_file(pf, str(tmp_path / "t.tsv"), header=False, sep="\t")
    jio.export_file(JFrame.from_arrays(cols), str(tmp_path / "jt.tsv"),
                    header=False, sep="\t")
    assert open(tmp_path / "t.tsv", "rb").read() == \
        open(tmp_path / "jt.tsv", "rb").read()
