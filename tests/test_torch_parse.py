"""CSV import in the port (``h2o3_tpu_torch/frame/parse.py``, the native
tokenizer built from ``native/csv_parser.cpp`` by
``h2o3_tpu_torch/frame/native_csv.py``) against the JAX package's
(``h2o3_tpu/frame/parse.py``): the same files through both routes (the
native tokenizer; pandas with ``na_strings``, ``header=None`` or a
multi-character separator), with names, types, domains, missing rows and
values equal (numbers exactly in float32). ``col_types`` are compared with
what the reference leaves them (it does not apply them): a column typed
"string" is the port's STR column of the reference's categorical labels.
Also ``RawFile``, ``parse_raw``, ``Frame.from_pandas``/``to_pandas``, the
header ``NA,x,x``, one small file of each binary format and the URI,
streaming and bad-path routes."""

import io

import numpy as np
import pandas as pd
import pytest
import torch

from h2o3_tpu.frame import parse as jparse
from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame import native_csv, parse
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8
    cores)."""
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


def _col(v):
    """A column's host view: labels of a categorical, strings of a string
    column, numbers otherwise."""
    if v.is_categorical:
        return list(v.labels()[:v.nrows])
    if v.data is None:
        return list(v.host_values[:v.nrows])
    return np.asarray(v.to_numpy())[:v.nrows]


def _same_frame(jf, pf, as_str=()):
    assert pf.names == jf.names
    assert pf.nrows == jf.nrows
    for n in jf.names:
        jv, pv = jf.vec(n), pf.vec(n)
        if n in as_str:
            assert pv.type is VecType.STR
            assert _col(pv) == _col(jv)
            continue
        assert str(pv.type) == str(jv.type), n
        if pv.is_categorical:
            assert tuple(pv.domain) == tuple(jv.domain), n
        a, b = _col(pv), _col(jv)
        if isinstance(a, list):
            assert a == b, n
        else:
            np.testing.assert_array_equal(a, b)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


MIXED = ("id,name,score,flag,city\n"
         "1,alpha,1.5,1,Paris\n"
         "2,beta,NA,0,\n"
         "3,,2.25,1,Lyon\n"
         "4,gamma,-3e2,,Paris\n"
         "5,alpha,7,0,Nice\n"
         "6,délta,0.125,1,Lyon\n")


def test_native_route_equals_reference(tmp_path):
    p = _write(tmp_path, "mixed.csv", MIXED)
    before = parse.routes["native"]
    pf = parse.import_file(p)
    assert parse.routes["native"] == before + 1
    _same_frame(jparse.import_file(p), pf)
    assert pf.key == "mixed_csv.hex" and DKV.get(pf.key) is pf
    assert native_csv.build_info["path"].endswith(".so")


@pytest.mark.parametrize("ext", ["txt", "data"])
def test_other_text_extensions_take_the_native_route(tmp_path, ext):
    p = _write(tmp_path, f"mixed.{ext}", MIXED)
    before = parse.routes["native"]
    _same_frame(jparse.import_file(p), parse.import_file(p))
    assert parse.routes["native"] == before + 1


@pytest.mark.parametrize("kw", [dict(na_strings=["alpha", "-1"]),
                                dict(header=None),
                                dict(header=None, na_strings=["Lyon"])],
                         ids=["na_strings", "no_header", "both"])
def test_pandas_routes_equal_reference(tmp_path, kw):
    p = _write(tmp_path, "m.csv", MIXED)
    before = parse.routes["pandas"]
    pf = parse.import_file(p, **kw)
    assert parse.routes["pandas"] == before + 1
    _same_frame(jparse.import_file(p, **kw), pf)


def test_long_separator_fails_like_the_reference(tmp_path):
    """A separator of more than one character goes to pandas' C reader in
    both packages, which refuses it as a regex."""
    p = _write(tmp_path, "m.csv", MIXED.replace(",", ";;"))
    with pytest.raises(ValueError, match="regex separators"):
        jparse.import_file(p, sep=";;")
    with pytest.raises(ValueError, match="regex separators"):
        parse.import_file(p, sep=";;")


def test_one_character_separator_and_quoted_fields(tmp_path):
    """A semicolon separator and RFC quoting (an embedded separator, a
    doubled quote, an embedded newline) on the native route."""
    text = ('a;b;c\n'
            '1;"x;y";"say ""hi"""\n'
            '2;"multi\nline";plain\n'
            '3;z;""\n')
    p = _write(tmp_path, "q.csv", text)
    _same_frame(jparse.import_file(p, sep=";"), parse.import_file(p, sep=";"))
    p2 = _write(tmp_path, "q2.csv", text.replace(";", ","))
    _same_frame(jparse.import_file(p2), parse.import_file(p2))


def test_quoted_header_takes_pandas(tmp_path):
    p = _write(tmp_path, "qh.csv", '"a,1",b\n1,2\n3,4\n')
    before = dict(parse.routes)
    _same_frame(jparse.import_file(p), parse.import_file(p))
    assert parse.routes["pandas"] == before["pandas"] + 1


@pytest.mark.parametrize("route", ["native", "pandas"])
def test_col_types_string_keeps_a_str_column(tmp_path, route):
    """``col_types={"name": "string"}`` gives a host STR column holding
    the strings the reference parses as categorical labels (the reference
    does not apply col_types); other columns as the reference."""
    p = _write(tmp_path, "ct.csv", MIXED)
    kw = dict(na_strings=["zzz"]) if route == "pandas" else {}
    ct = {"name": "string", "city": "string"}
    before = parse.routes[route]
    pf = parse.import_file(p, col_types=ct, **kw)
    assert parse.routes[route] == before + 1
    jf = jparse.import_file(p, col_types=ct, **kw)
    _same_frame(jf, pf, as_str=("name", "city"))
    assert pf.vec("name").host_values[2] is None


def test_col_types_numeric_and_enum(tmp_path):
    """enum keeps categorical; numeric reads non-numbers as missing; a
    numeric column forced to string re-reads its text through pandas."""
    p = _write(tmp_path, "ce.csv", "a,b,c\n1,x,10\n2,3.5,20\n,y,30\n")
    pf = parse.import_file(p, col_types={"b": "numeric", "a": "enum",
                                         "c": "string"})
    assert pf.vec("a").type is VecType.CAT and pf.vec("a").domain == \
        ("1", "2")
    np.testing.assert_array_equal(pf.vec("b").to_numpy(),
                                  np.float32([np.nan, 3.5, np.nan]))
    assert list(pf.vec("c").host_values) == ["10", "20", "30"]
    with pytest.raises(ValueError, match="col_types"):
        parse.import_file(p, col_types={"a": "uuid"})


def test_header_na_and_duplicate_names(tmp_path):
    """The header NA,x,x gives ["NA", "x", "x.1"] (the contract of
    tests/test_ingest.py::test_header_edge_cases_match_eager) on both
    routes, with the values of pandas' route."""
    p = _write(tmp_path, "h.csv", "NA,x,x\n1,2,3\n4,5,6\n")
    fn = parse.import_file(p)
    fp = parse.import_file(p, na_strings=["none"])
    assert fn.names == fp.names == ["NA", "x", "x.1"]
    for n in fn.names:
        np.testing.assert_array_equal(fn.vec(n).to_numpy(),
                                      fp.vec(n).to_numpy())
    for names in (["x", "x", "x.1", "x"], ["a", "a", "a", "a.1", "b"],
                  ["NA", "x", "x"]):
        text = ",".join(names) + "\n" + ",".join("1" * len(names)) + "\n"
        want = list(pd.read_csv(io.StringIO(text), engine="c").columns)
        assert parse.dedupe_names(names) == want


def _write_format(tmp_path, name):
    """A two-row file of one column ``x`` (SVMLight: the label ``C0`` and
    one feature) in the format its extension names."""
    p = str(tmp_path / name)
    ext = name.rsplit(".", 1)[1]
    if ext in ("parquet", "orc"):
        import pyarrow as pa
        table = pa.table({"x": pa.array([1.0, 2.5])})
        if ext == "orc":
            import pyarrow.orc as orc
            orc.write_table(table, p)
        else:
            import pyarrow.parquet as pq
            pq.write_table(table, p)
    elif ext == "arff":
        _write(tmp_path, name, "@relation r\n@attribute x numeric\n"
                               "@data\n1\n2.5\n")
    elif ext == "svmlight":
        _write(tmp_path, name, "1 1:2.5\n0 1:-1\n")
    elif ext == "avro":
        from dataplane_pair import write_avro
        write_avro(p, {"type": "record", "name": "R", "fields": [
            {"name": "x", "type": "double"}]}, [{"x": 1.0}, {"x": 2.5}])
    else:
        from dataplane_pair import write_xlsx
        write_xlsx(p, ["x"], [[1.0], [2.5]])
    return p


@pytest.mark.parametrize("name,what", [("a.parquet", "Parquet"),
                                       ("a.orc", "ORC"), ("a.arff", "ARFF"),
                                       ("a.svmlight", "SVMLight"),
                                       ("a.avro", "Avro"), ("a.xlsx", "XLSX")])
def test_refused_formats_raise_by_name(tmp_path, name, what):
    """Each format the reference parses (``what``) parses in the port to
    the reference's frame, under the reference's key."""
    p = _write_format(tmp_path, name)
    pf = parse.import_file(p)
    jf = jparse.import_file(p)
    _same_frame(jf, pf)
    assert pf.key == jf.key == name.replace(".", "_") + ".hex"
    assert DKV.get(pf.key) is pf


def test_refused_uris_streaming_and_bad_paths(tmp_path, monkeypatch):
    """A cloud URI without its endpoint's credentials raises the
    reference's guidance; H2O3TPU_INGEST_STREAMING=1 streams a text file
    into the frame the eager route gives; ``file://`` and bad paths
    behave as the reference's."""
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    with pytest.raises(ValueError, match="S3 credentials missing"):
        parse.import_file("s3://bucket/a.csv")
    p = _write(tmp_path, "s.csv", "x\n1\n")
    monkeypatch.setenv("H2O3TPU_INGEST_STREAMING", "1")
    streamed = parse.import_file(p)
    assert streamed._ingest_stats["rows"] == 1
    monkeypatch.delenv("H2O3TPU_INGEST_STREAMING")
    eager = parse.import_file("file://" + p)
    assert eager.nrows == 1
    _same_frame(eager, streamed)
    with pytest.raises(FileNotFoundError):
        parse.import_file(str(tmp_path / "absent.csv"))
    with pytest.raises(IsADirectoryError):
        parse.import_file(str(tmp_path))


def test_rawfile_and_upload_file(tmp_path):
    """A RawFile's bytes parse once into a frame whose transient key
    leaves the DKV; upload_file is import_file."""
    from h2o3_tpu.frame.parse import RawFile as JRawFile
    data = MIXED.encode()
    rf = parse.RawFile(data, name="up.csv")
    pf = rf.frame()
    assert rf.frame() is pf and rf.data == data
    assert [k for k in DKV.keys() if k.startswith("_upload_")] == []
    _same_frame(JRawFile(data, name="up.csv").frame(), pf)
    p = _write(tmp_path, "u.csv", MIXED)
    _same_frame(jparse.upload_file(p), parse.upload_file(p, key="u"))
    assert "u" in DKV


def test_parse_raw_equals_reference():
    text = "a,b,c\n1,x,2020-01-01\n2,,2021-06-30\n3,y,\n"
    jf = jparse.parse_raw(text, parse_dates=["c"])
    pf = parse.parse_raw(text, key="raw", parse_dates=["c"])
    _same_frame(jf, pf)
    assert DKV.get("raw") is pf


def test_from_pandas_types_equal_reference():
    """object and str columns categorical, datetimes TIME (exact ms on the
    host), booleans INT, numbers NUM/INT, a category column factorized
    again; to_pandas gives the reference's frame back."""
    df = pd.DataFrame({
        "s": pd.Series(["b", None, "a", "b"], dtype=object),
        "t": pd.to_datetime(["2020-01-01 00:00:00", None, "2021-03-04 05:06:07",
                             "1999-12-31 23:59:59"]),
        "flag": [True, False, True, True],
        "i": [1, 2, 3, 4], "f": [0.5, np.nan, 2.5, -1.0],
        "cat": pd.Categorical(["z", "y", "z", None]),
        "st": pd.Series(["u", "v", None, "u"], dtype="str"),
    })
    jf, pf = JFrame.from_pandas(df), Frame.from_pandas(df)
    _same_frame(jf, pf)
    assert pf.vec("t").type is VecType.TIME
    np.testing.assert_array_equal(pf.vec("t").to_numpy(),
                                  jf.vec("t").to_numpy())
    assert pf.vec("t").time_offset == jf.vec("t").time_offset
    pd.testing.assert_frame_equal(pf.to_pandas(), jf.to_pandas())


def test_from_arrays_keeps_explicit_str():
    """An untyped string column is categorical in both packages; one typed
    STR stays a host column."""
    vals = np.array(["a b", "c", None], dtype=object)
    assert Frame.from_arrays({"s": vals}).vec("s").type is VecType.CAT
    v = Frame.from_arrays({"s": vals}, types={"s": VecType.STR}).vec("s")
    assert v.type is VecType.STR and list(v.host_values) == ["a b", "c", None]
