"""The port's Parquet, ORC, ARFF and SVMLight imports
(``h2o3_tpu_torch/frame/parse.py``) against the JAX package's
(``h2o3_tpu/frame/parse.py``): the same files, written from numpy seeds,
give the same names, types, domains, NA positions and values (exact;
float32 compared as bits). Parquet and ORC are read by pyarrow in the
port and by pandas in the JAX package: dictionary columns, int64 columns
with nulls, booleans with and without nulls, strings and timestamps come
out alike. SVMLight's dense route is compared with the reference's
(scikit-learn's reader), its sparse route with the reference's
``parse_svmlight_sparse``."""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame import parse as jparse
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame import parse
from h2o3_tpu_torch.frame.sparse import SparseFrame
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import same_frame
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
    yield
    DKV.clear()


def _arrow_table(rng, n=500):
    import pyarrow as pa
    ints = rng.integers(-5, 50, n)
    mask = rng.random(n) < 0.1
    levels = np.array(["red", "green", "blue"])
    ts = (np.datetime64("2020-01-01T00:00:00") + rng.integers(
        0, 10**9, n).astype("timedelta64[s]")).astype("datetime64[ms]")
    return pa.table({
        "f": pa.array(np.where(mask, np.nan, rng.normal(size=n))),
        "i": pa.array(ints.tolist()),
        "inull": pa.array([None if m else int(v)
                           for v, m in zip(ints, mask)], pa.int64()),
        "dict": pa.array(levels[rng.integers(0, 3, n)]).dictionary_encode(),
        "s": pa.array([None if m else f"k{v % 7}"
                       for v, m in zip(ints, mask)]),
        "b": pa.array(rng.random(n) < 0.5),
        "bnull": pa.array([None if m else bool(v % 2)
                           for v, m in zip(ints, mask)]),
        "t": pa.array(ts),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
    })


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_arrow_formats_equal_reference(tmp_path, rng, fmt):
    table = _arrow_table(rng)
    p = str(tmp_path / f"t.{fmt}")
    if fmt == "orc":
        import pyarrow.orc as orc
        # ORC has no dictionary type: its strings are plain
        table = table.set_column(3, "dict",
                                 table.column("dict").cast("string"))
        orc.write_table(table, p)
    else:
        import pyarrow.parquet as pq
        pq.write_table(table, p)
    pf = parse.import_file(p)
    jf = jparse.import_file(p)
    same_frame(pf, jf)
    assert pf.types["dict"] == "enum" and pf.types["t"] == "time"
    assert pf.types["bnull"] == "enum" and pf.types["inull"] == "int"
    np.testing.assert_array_equal(pf.vec("t").to_numpy(),
                                  jf.vec("t").to_numpy())
    assert DKV.get(f"t_{fmt}.hex") is pf


ARFF = """% a comment
@relation weather
@attribute outlook {sunny, overcast, rainy, foggy}
@attribute temp numeric
@attribute 'humid' real
@attribute note string
@attribute windy {TRUE, FALSE}
@data
"""


def test_arff_keeps_declared_domains(tmp_path, rng):
    """Nominal domains are the declared ones, in declared order, with
    levels no row uses (``foggy``) kept; ``?`` is missing."""
    outs = ["sunny", "overcast", "rainy"]
    lines = [f"{outs[i % 3]},{int(rng.integers(60, 90))},"
             f"{'?' if i % 6 == 0 else round(float(rng.normal(70, 9)), 2)},"
             f"n{i % 4},{['TRUE', 'FALSE'][i % 2]}" for i in range(200)]
    p = tmp_path / "w.arff"
    p.write_text(ARFF + "\n".join(lines) + "\n")
    pf = parse.import_file(str(p))
    jf = jparse.import_file(str(p))
    assert pf.vec("outlook").domain == ("sunny", "overcast", "rainy",
                                        "foggy")
    assert pf.names == ["outlook", "temp", "humid", "note", "windy"]
    assert pf.types["note"] == "string"
    for n in ("outlook", "temp", "humid", "windy"):
        same_frame(pf[[n]], jf[[n]])
    assert list(pf.vec("note").host_values) == \
        list(jf.vec("note").host_values)


def _svmlight_text(rng, rows, width, zero_based=False):
    lines = []
    for r in range(rows):
        idx = np.sort(rng.choice(width, size=3, replace=False))
        if not zero_based:
            idx = idx + 1
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in idx)
        lines.append(f"{int(rng.integers(0, 2))} {feats}  # row {r}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("zero_based", [False, True])
def test_svmlight_dense_equals_reference(tmp_path, rng, zero_based):
    p = tmp_path / "d.svmlight"
    p.write_text(_svmlight_text(rng, 300, 12, zero_based))
    pf = parse.import_file(str(p))
    jf = jparse.import_file(str(p))
    assert pf.names[0] == "C0" and pf.ncols == jf.ncols
    same_frame(pf, jf)
    dense = parse.import_svmlight(str(p), sparse=False, key="dn")
    same_frame(dense, jf)


def test_svmlight_wide_file_stays_sparse(tmp_path, rng):
    from h2o3_tpu.frame.sparse import parse_svmlight_sparse as jsparse
    p = tmp_path / "w.svm"
    p.write_text(_svmlight_text(rng, 200, 1500))
    pf = parse.import_file(str(p))
    assert isinstance(pf, SparseFrame) and pf.ncols >= 1001
    jf = jsparse(str(p))
    assert (pf.nrows, pf.ncols) == (jf.nrows, jf.ncols)
    assert pf.X.nnz == jf.X.nnz
    sp = parse.import_svmlight(str(p), key="sp")
    assert isinstance(sp, SparseFrame) and DKV.get("sp") is sp
    np.testing.assert_array_equal(sp.vec("C0").to_numpy(),
                                  jf.vec("C0").to_numpy()[:jf.nrows])
