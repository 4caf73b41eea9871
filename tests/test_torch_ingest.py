"""The port's streaming chunked parse (``h2o3_tpu_torch/ingest/
pipeline.py``) and its compressed Vecs against the JAX package's
(``h2o3_tpu/ingest/pipeline.py``), after ``tests/test_ingest.py``: the
same files, written from numpy seeds, through both packages' streaming
routes and the port's eager route give the same names, types, domains,
codecs, NA positions and values (exact; float32 compared as bits). The
port decodes a column on its tensor's device by widening the narrow
payload there (``CompressedChunk.to_tensor``): on the CPU in these tests,
on the card in ``chip_smoke.py`` phase 16. ``H2O3TPU_INGEST_CHUNK_ROWS`` is set
small so that every breaking token lies past the first batch. A GBM and a
binomial GLM on a streamed frame equal, bit for bit, the same models on
the eager frame."""

import gzip
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from h2o3_tpu.ingest import stream_import as jstream
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame import parse
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.ingest import stream_import
from h2o3_tpu_torch.models import job as jobmod
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import heaps_equal, same_frame as _same
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    # the reference's tokenizer reads pandas' pyarrow-backed strings on a
    # stage thread, which crashes a process whose first such parse that is
    # (ROADMAP queue C): one parse on this thread first
    import io

    import pandas as pd
    pd.read_csv(io.StringIO("a,b\n1,x\n"), dtype=str)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("H2O3TPU_INGEST_CHUNK_ROWS", "256")
    monkeypatch.delenv("H2O3TPU_INGEST_STREAMING", raising=False)
    yield
    DKV.clear()


def _write_csv(path, nrows, rng, gz=False, cats=("aa", "bb", "cc")):
    xi = rng.integers(-40, 90, size=nrows)
    yf = rng.normal(size=nrows)
    cs = [cats[i % len(cats)] for i in range(nrows)]
    text = "xi,yf,cat\n" + "".join(f"{a},{b:.6f},{c}\n"
                                   for a, b, c in zip(xi, yf, cs))
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return xi.astype(np.float32), yf.astype(np.float32), cs


@pytest.mark.parametrize("gz", [False, True])
def test_stream_parse_matches_reference_and_eager(tmp_path, rng, gz):
    p = str(tmp_path / ("t.csv.gz" if gz else "t.csv"))
    xi, yf, cs = _write_csv(p, 3000, rng, gz=gz)
    fr = stream_import(p, key="s.hex", chunk_rows=512)
    assert fr.types == {"xi": "int", "yf": "real", "cat": "enum"}
    np.testing.assert_array_equal(fr.vec("xi").to_numpy(), xi)
    assert list(fr.vec("cat").labels()) == cs
    _same(fr, jstream(p, key="js.hex", chunk_rows=512))
    _same(fr, parse.import_file(p, key="se.hex"))
    np.testing.assert_allclose(fr.vec("yf").to_numpy(), yf, atol=1e-6)
    assert DKV.get("s.hex") is fr
    st = fr._ingest_stats
    assert st["chunks"] >= 5 and st["rows"] == 3000
    assert st["inflight_peak_bytes"] < st["bytes_in"]


def test_stream_parse_compresses_like_reference(tmp_path, rng):
    p = str(tmp_path / "c.csv")
    _write_csv(p, 4000, rng)
    fr = stream_import(p, key="c.hex", chunk_rows=1024)
    jf = jstream(p, key="jc.hex", chunk_rows=1024)
    for n in fr.names:
        assert fr.vec(n).compressed.codec == jf.vec(n).compressed.codec
    assert fr.vec("xi").compressed.codec == "i8"
    assert fr.vec("cat").compressed.codec == "dict8"
    assert fr.vec("yf").compressed.codec == "f32"
    assert fr._ingest_stats == jf._ingest_stats


def test_promote_and_reparse(tmp_path):
    """A batch past the sample that breaks a numeric guess restarts once
    with the column categorical; k columns broken in one batch ride one
    restart."""
    lines = ["a,b"] + [f"{i},{i * 2}" for i in range(1500)] \
        + ["surprise,3000"] + [f"{i},{i}" for i in range(50)]
    p = tmp_path / "p.csv"
    p.write_text("\n".join(lines) + "\n")
    fr = stream_import(str(p), key="p.hex")
    assert fr.nrows == 1551
    assert fr.types["a"] == "enum" and fr.types["b"] == "int"
    assert fr._ingest_stats["restarts"] == 1
    _same(fr, jstream(str(p), key="jp.hex", chunk_rows=256))
    lines2 = ["m,n"] + [f"{i},{i}" for i in range(1000)] + ["uh,oh"]
    p2 = tmp_path / "p2.csv"
    p2.write_text("\n".join(lines2) + "\n")
    fr2 = stream_import(str(p2), key="p2.hex")
    assert fr2.types == {"m": "enum", "n": "enum"}
    assert fr2._ingest_stats["restarts"] == 1
    _same(fr2, jstream(str(p2), key="jp2.hex", chunk_rows=256))


def test_import_file_routes_streaming_in_a_job(tmp_path, rng, monkeypatch):
    """``import_file`` streams behind H2O3TPU_INGEST_STREAMING (1, and auto
    for a gzip file by its magic bytes), inside a Job that ends DONE with
    row and byte progress; 0 takes the eager route."""
    jobs = []
    orig_init = jobmod.Job.__init__

    def recording_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        jobs.append(self)

    monkeypatch.setattr(jobmod.Job, "__init__", recording_init)
    p = str(tmp_path / "r.csv")
    xi, _, _ = _write_csv(p, 2000, rng)
    monkeypatch.setenv("H2O3TPU_INGEST_STREAMING", "1")
    fr = parse.import_file(p, key="r.hex")
    assert hasattr(fr, "_ingest_stats") and fr.nrows == 2000
    np.testing.assert_array_equal(fr.vec("xi").to_numpy(), xi)
    job = [j for j in jobs if j.description.startswith("Parse")][-1]
    assert job.status == jobmod.Job.DONE and job.progress == 1.0
    assert "rows" in job.progress_msg and "bytes" in job.progress_msg
    monkeypatch.setenv("H2O3TPU_INGEST_STREAMING", "0")
    assert not hasattr(parse.import_file(p, key="r2.hex"), "_ingest_stats")
    g = tmp_path / "noext"
    g.write_bytes(gzip.compress(open(p, "rb").read()))
    monkeypatch.setenv("H2O3TPU_INGEST_STREAMING", "auto")
    assert parse._stream_mode(str(g), "gz") and \
        not parse._stream_mode(p, "csv")
    monkeypatch.setenv("H2O3TPU_INGEST_STREAM_MIN_BYTES", "10")
    assert parse._stream_mode(p, "csv")


def test_lazy_decode_view_drop_and_accounting(tmp_path, rng):
    """A compressed Vec's tensor is built on first access, dropped and
    built again; nrows, device, nbytes, rollups and to_numpy never build
    it, and the rollups equal the eager column's."""
    p = str(tmp_path / "l.csv")
    xi, _, _ = _write_csv(p, 2048, rng)
    fr = stream_import(p, key="l.hex", chunk_rows=512)
    fe = parse.import_file(p, key="le.hex")
    v = fr.vec("xi")
    assert not v.device_resident
    assert v.nrows == 2048 and v.device == torch.device("cpu")
    assert v.nbytes == v.compressed.nbytes
    assert v.rollups() == fe.vec("xi").rollups()
    np.testing.assert_array_equal(v.to_numpy(), xi)
    assert not any(u.device_resident for u in fr.vecs)
    _ = v.data
    assert v.device_resident and v.nbytes == v.compressed.nbytes + 2048 * 4
    held = v.data
    assert fr.drop_device_views() == 2048 * 4 and not v.device_resident
    assert torch.equal(held, v.data)     # built again, equal; held intact
    assert v.data is v.data


def test_decode_once_under_concurrent_readers(tmp_path, rng):
    """Two threads reading a compressed column's data get one tensor."""
    p = str(tmp_path / "cc.csv")
    _write_csv(p, 4096, rng)
    fr = stream_import(p, key="cc.hex")
    got, barrier = [], threading.Barrier(4)

    def read():
        barrier.wait()
        got.append(fr.vec("yf").data)

    threads = [threading.Thread(target=read) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(got) == 4 and all(g is got[0] for g in got)


def test_multi_member_gzip_reads_every_member(tmp_path):
    a = gzip.compress(b"x,y\n1,10\n2,20\n")
    b = gzip.compress(b"3,30\n4,40\n5,50\n")
    p = tmp_path / "multi.csv.gz"
    p.write_bytes(a + b)
    fr = stream_import(str(p), key="mm.hex", chunk_rows=64)
    np.testing.assert_array_equal(fr.vec("x").to_numpy(), [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(fr.vec("y").to_numpy(),
                                  [10, 20, 30, 40, 50])
    _same(fr, jstream(str(p), key="jmm.hex", chunk_rows=64))


@pytest.mark.parametrize("text,names", [
    ('"last,first",age\n"x",1\n"y",2\n', ["last,first", "age"]),
    ("NA,x,x\n1,2,3\n4,5,6\n", ["NA", "x", "x.1"]),
    ("x,x,x.1,x\n1,2,3,4\n", ["x", "x.2", "x.1", "x.3"]),
])
def test_header_names_match_eager(tmp_path, text, names):
    """Quoted header names split by the CSV reader; ``NA`` stays a name;
    duplicates take pandas' ``x.1`` on the streaming route as on both
    eager routes (the contract of the reference's
    ``test_header_edge_cases_match_eager``)."""
    import pandas as pd
    p = tmp_path / "h.csv"
    p.write_text(text)
    assert list(pd.read_csv(str(p)).columns) == names
    fr = stream_import(str(p), key="h.hex")
    assert fr.names == names
    if '"' not in text:     # a quoted header takes pandas' route
        fe = parse.import_file(str(p), key="he.hex")
        assert fe.names == names
        _same(fr, fe)
    fp = parse.import_file(str(p), key="hp.hex", na_strings=["zz"])
    assert fp.names == names


def test_quoted_embedded_newlines(tmp_path):
    p = tmp_path / "nl.csv"
    p.write_text('txt,v\n"line1\nline2",5\n"plain",7\n"a\nb\nc",9\n')
    fr = stream_import(str(p), key="nl.hex")
    assert fr.nrows == 3
    _same(fr, parse.import_file(str(p), key="nle.hex"))
    _same(fr, jstream(str(p), key="jnl.hex"))


def test_forced_numeric_bad_tokens_become_na(tmp_path):
    lines = ["x,v"] + [f"{i},{i}" for i in range(300)] + ["oops,300"]
    p = tmp_path / "na.csv"
    p.write_text("\n".join(lines) + "\n")
    fr = stream_import(str(p), key="na.hex", chunk_rows=64,
                       col_types={"x": "numeric"})
    assert fr._ingest_stats["restarts"] == 0
    got = fr.vec("x").to_numpy()
    assert np.isnan(got[300]) and got[299] == 299
    _same(fr, jstream(str(p), key="jna.hex", chunk_rows=64,
                      col_types={"x": "numeric"}))


def test_col_types_force_categorical(tmp_path):
    lines = ["zip,v"] + [f"{94000 + i % 5},{i}" for i in range(400)]
    p = tmp_path / "z.csv"
    p.write_text("\n".join(lines) + "\n")
    for ct in ("enum", VecType.CAT, "string"):
        fr = stream_import(str(p), key="z.hex", chunk_rows=128,
                           col_types={"zip": ct})
        assert fr.types["zip"] == "enum" and fr.vec("zip").cardinality() == 5
        assert fr._ingest_stats["restarts"] == 0
    _same(fr, jstream(str(p), key="jz.hex", chunk_rows=128,
                      col_types={"zip": "string"}))


def test_to_numpy_returns_fresh_array(tmp_path, rng):
    p = str(tmp_path / "mut.csv")
    _write_csv(p, 256, rng)
    fr = stream_import(p, key="mut.hex", chunk_rows=64)
    want = fr.vec("yf").to_numpy().copy()
    arr = fr.vec("yf").to_numpy()
    arr[:] = 0.0
    np.testing.assert_array_equal(fr.vec("yf").to_numpy(), want)


def test_wide_integral_span_still_types_int(tmp_path):
    p = tmp_path / "w.csv"
    p.write_text("id\n" + "\n".join(str(i * 7) for i in range(20000)) + "\n")
    fr = stream_import(str(p), key="w.hex", chunk_rows=4096)
    assert fr.vec("id").compressed.codec == "f32"
    assert fr.types["id"] == "int"


def test_cancelled_parse_raises_not_none(tmp_path, rng, monkeypatch):
    """A parse whose Job is cancelled raises from ``import_file``; the
    stages stop."""
    p = str(tmp_path / "c.csv")
    _write_csv(p, 5000, rng)
    orig_init = jobmod.Job.__init__

    def cancelled_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        if self.description.startswith("Parse"):
            self.cancel()

    monkeypatch.setattr(jobmod.Job, "__init__", cancelled_init)
    monkeypatch.setenv("H2O3TPU_INGEST_STREAMING", "1")
    before = threading.active_count()
    with pytest.raises(ValueError, match="cancelled"):
        parse.import_file(p, key="cx.hex")
    assert "cx.hex" not in DKV
    assert threading.active_count() <= before


def test_job_runs_in_background_and_carries_errors():
    job = jobmod.Job("work").run(lambda j: (j.update(0.5, "half"), 7)[1],
                                 background=True).join(timeout=10)
    assert job.status == jobmod.Job.DONE and job.result == 7
    bad = jobmod.Job("bad").run(lambda j: 1 / 0)
    assert bad.status == jobmod.Job.FAILED
    assert isinstance(bad.exception, ZeroDivisionError)
    stop = threading.Event()

    def loop(j):
        while not stop.wait(0.01):
            j.update(0.1)

    c = jobmod.Job("c").run(loop, background=True)
    c.cancel()
    c.join(timeout=10)
    stop.set()
    assert c.status == jobmod.Job.CANCELLED and c.should_stop


def _model_csv(tmp_path, rng, n=3000):
    x1 = rng.normal(size=n)
    x2 = rng.integers(0, 500, n)
    c = rng.integers(0, 7, n)
    yb = 1 / (1 + np.exp(-(0.5 * x1 - 0.004 * (x2 - 250) + 0.3 * c))) \
        > rng.uniform(size=n)
    text = "x1,x2,c,y\n" + "".join(
        f"{a:.6f},{b},k{d},{'yes' if e else 'no'}\n"
        for a, b, d, e in zip(x1, x2, c, yb))
    p = tmp_path / "g.csv.gz"
    p.write_bytes(gzip.compress(text.encode()))
    q = tmp_path / "g.csv"
    q.write_text(text)
    return str(p), str(q)


def test_gbm_and_glm_streamed_equal_eager(tmp_path, rng):
    """The streamed (gzip) frame and the eager frame of the same rows
    train the same GBM trees and the same binomial GLM, bit for bit."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.glm import GLM
    gz, plain = _model_csv(tmp_path, rng)
    fs = stream_import(gz, key="gs.hex")
    fe = parse.import_file(plain, key="ge.hex")
    _same(fs, fe)
    kw = dict(ntrees=4, max_depth=3, nbins=16, seed=1)
    ms = GBM(**kw).train(y="y", training_frame=fs)
    me = GBM(**kw).train(y="y", training_frame=fe)
    assert heaps_equal(ms, me)
    assert torch.equal(ms.predict(fs).vec("pyes").data,
                       me.predict(fe).vec("pyes").data)
    gkw = dict(family="binomial", lambda_=1e-4, max_iterations=20, seed=7)
    gs = GLM(**gkw).train(y="y", training_frame=fs)
    ge = GLM(**gkw).train(y="y", training_frame=fe)
    assert torch.equal(gs.output["beta"], ge.output["beta"])
    assert torch.equal(gs.predict(fs).vec("pyes").data,
                       ge.predict(fe).vec("pyes").data)


def test_streaming_parse_in_a_fresh_process(tmp_path):
    """The port's tokenizer reads tokens as Python strings: a fresh process
    streams a small gzip file 30 times without crashing (the reference's
    pyarrow-backed strings crash such a process within a few parses)."""
    import subprocess
    import sys
    p = tmp_path / "f.csv.gz"
    p.write_bytes(gzip.compress(b"x,y\n1,a\n2,b\n"))
    code = ("import torch\n"
            "from h2o3_tpu_torch import set_device\n"
            "from h2o3_tpu_torch.ingest import stream_import\n"
            "set_device('cpu')\n"
            f"for _ in range(30): stream_import({str(p)!r})\n"
            "print('ok')\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=str(root))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

