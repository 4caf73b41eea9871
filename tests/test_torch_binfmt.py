"""The port's Avro and XLSX readers (``h2o3_tpu_torch/frame/binfmt.py``)
against the JAX package's (``h2o3_tpu/frame/binfmt.py``), after
``tests/test_binfmt_cleaner.py``: the same files, written here from numpy
seeds by small test writers, give the same names, types, domains, NA
positions and values (exact) through both packages' ``import_file``;
unsupported codecs and legacy ``.xls`` are refused by name."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame import parse as jparse
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame import binfmt, parse
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import same_frame as _same
from dataplane_pair import write_avro, write_xlsx, zigzag


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


def _avro_rows(rng, n):
    names = ["ann", "bo", "cy"]
    return [{"id": int(i), "x": float(rng.normal()) if i % 7 else None,
             "f": float(np.float32(rng.normal())),
             "name": names[i % 3] if i % 11 else None,
             "ok": bool(i % 2)} for i in range(n)]


_SCHEMA = {"type": "record", "name": "R", "fields": [
    {"name": "id", "type": "long"},
    {"name": "x", "type": ["null", "double"]},
    {"name": "f", "type": "float"},
    {"name": "name", "type": ["null", "string"]},
    {"name": "ok", "type": "boolean"}]}


@pytest.mark.parametrize("codec", [b"null", b"deflate"])
def test_avro_equals_reference(tmp_path, rng, codec):
    p = str(tmp_path / "t.avro")
    rows = _avro_rows(rng, 2500)
    write_avro(p, _SCHEMA, rows, codec=codec)
    pf = parse.import_file(p)
    assert pf.key == "t_avro.hex" and DKV.get(pf.key) is pf
    _same(pf, jparse.import_file(p))
    assert pf.types["name"] == "enum" and pf.types["id"] == "int"
    names, got = binfmt.read_avro(p)
    assert names == ["id", "x", "f", "name", "ok"] and got == rows


def test_avro_refuses_other_codecs_and_files(tmp_path):
    p = str(tmp_path / "s.avro")
    write_avro(p, _SCHEMA, [], codec=b"snappy")
    with open(p, "ab") as f:
        f.write(zigzag(1) + zigzag(3) + b"abc" + b"S" * 16)
    with pytest.raises(ValueError, match="unsupported Avro codec 'snappy'"):
        binfmt.read_avro(p)
    q = tmp_path / "n.avro"
    q.write_bytes(b"nope")
    with pytest.raises(ValueError, match="not an Avro"):
        binfmt.read_avro(str(q))


def test_xlsx_equals_reference(tmp_path, rng):
    p = str(tmp_path / "t.xlsx")
    rows = [[float(i), float(np.round(rng.normal(), 4)) if i % 5 else None,
             ["lo", "hi"][i % 2] if i % 9 else None]
            for i in range(300)]
    write_xlsx(p, ["n", "v", "grade"], rows)
    pf = parse.import_file(p, key="x")
    _same(pf, jparse.import_file(p, key="jx"))
    assert pf.types == {"n": "int", "v": "real", "grade": "enum"}
    assert binfmt.read_xlsx(p)[1] == [0.0, None, None]


def test_xls_refused_and_gzip_sniffed(tmp_path):
    p = tmp_path / "old.xls"
    p.write_bytes(b"\xd0\xcf")
    with pytest.raises(ValueError, match="legacy BIFF .xls"):
        parse.import_file(str(p))
    g = tmp_path / "g"
    g.write_bytes(b"\x1f\x8b\x08rest")
    assert binfmt.is_gzipped(str(g))
    assert not binfmt.is_gzipped(str(p))
    assert not binfmt.is_gzipped(str(tmp_path / "absent"))
