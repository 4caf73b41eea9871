"""The port's telemetry (``h2o3_tpu_torch/utils/telemetry.py``) against the
JAX package's: the same sequence of metric events into a fresh registry of
each gives the same snapshot rows and the same OpenMetrics text, byte for
byte; the module-level catalog holds the same families with the same
kinds, help, labels and buckets; the log ring formats and filters alike.
Then the port's wiring: the sites the reference feeds (model builds, a
GBM's chunk, parses, the DKV, persist, serving) move the port's families.
"""

import logging
import threading

import numpy as np
import pytest
import torch

from h2o3_tpu.utils import telemetry as jtm
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import telemetry as ptm
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


def _events(tm):
    """One registry of the module ``tm`` driven through a fixed sequence:
    counters with and without labels, gauges, histograms with hostile
    label values, rejected observations and a custom bucket set."""
    reg = tm.MetricsRegistry()
    c = reg.counter("reqs", "requests", ("route", "status"))
    c.labels(route="/3/Cloud", status="200").inc()
    c.labels(route="/3/Cloud", status="200").inc(2.5)
    c.labels(route='we"ird\\path\nx', status="500").inc()
    reg.counter("plain", 'help with "quotes" and \\ and\nnewline').inc(7)
    g = reg.gauge("keys", "resident keys")
    g.set(10)
    g.inc(5)
    g.dec(3)
    h = reg.histogram("lat", "latency", ("loop",), buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0, float("nan"), -1.0, float("inf")):
        h.labels(loop="gbm_chunk").observe(v)
    h2 = reg.histogram("bytes", buckets=tm.SCORE_BATCH_BUCKETS)
    for v in (1, 3, 4096, 1e9):
        h2.observe(v)
    reg.gauge("big").set(1e16)
    reg.gauge("frac").set(0.125)
    return reg


def test_the_same_events_give_the_same_snapshot():
    assert _events(ptm).snapshot() == _events(jtm).snapshot()
    assert _events(ptm).snapshot(include_buckets=False) == \
        _events(jtm).snapshot(include_buckets=False)


def test_the_same_events_give_the_same_openmetrics_text():
    got, want = _events(ptm).to_openmetrics(), _events(jtm).to_openmetrics()
    assert got == want
    assert got.endswith("# EOF\n")
    assert "h2o3_telemetry_rejected_total{where=\"lat\"} 3" in got


@pytest.mark.parametrize("v", [0.0, 1.0, 2.5, 1e15, 1e16, float("nan"),
                               float("inf"), -float("inf"), 1 / 3, 123456789])
def test_number_rendering(v):
    assert ptm._fmt(v) == jtm._fmt(v)


@pytest.mark.parametrize("v", ["plain", 'q"uote', "back\\slash", "new\nline",
                               '\\n literal', ""])
def test_label_and_help_escaping(v):
    assert ptm._escape_label(v) == jtm._escape_label(v)
    assert ptm._escape_help(v) == jtm._escape_help(v)


def test_the_catalog_is_the_references():
    def catalog(tm):
        return {name: (f.kind, f.help, f.labelnames, f.buckets)
                for name, f in vars(tm).items()
                if isinstance(f, tm._Family)}
    got, want = catalog(ptm), catalog(jtm)
    assert got == want
    assert len(got) >= 60


def test_registration_is_idempotent_and_type_checked():
    for tm in (ptm, jtm):
        reg = tm.MetricsRegistry()
        assert reg.counter("x", "a") is reg.counter("x", "b")
        with pytest.raises(ValueError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("y", "", ("a",)).labels(b="1")
        with pytest.raises(ValueError):
            reg.counter("z").inc(-1)


def test_concurrent_increments_are_exact():
    reg = ptm.MetricsRegistry()
    c = reg.counter("hits")
    h = reg.histogram("obs")

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.01)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = {r["name"]: r["value"] for r in reg.snapshot(False)}
    assert rows["hits_total"] == 16000 and rows["obs_count"] == 16000


def test_log_rings_format_and_filter_alike():
    records = [logging.LogRecord("h2o3", lv, __file__, 1, msg, None, None)
               for lv, msg in ((logging.INFO, "one"),
                               (logging.WARNING, "two\nlines"),
                               (logging.DEBUG, "three"),
                               (logging.ERROR, "four"))]
    pr, jr = ptm.LogRing(capacity=3), jtm.LogRing(capacity=3)
    for r in records:
        pr.emit(r)
        jr.emit(r)
    for level in (0, logging.INFO, logging.WARNING, logging.ERROR):
        assert pr.lines(level) == jr.lines(level)
    assert len(pr.lines()) == 3 and " | " in pr.lines()[0]
    assert ptm.LOG_FILES == jtm.LOG_FILES
    assert (ptm.LOG_FORMAT, ptm.LOG_DATEFMT) == (jtm.LOG_FORMAT,
                                                 jtm.LOG_DATEFMT)


def test_install_log_ring_is_idempotent_on_the_ports_logger():
    a, b = ptm.install_log_ring(), ptm.install_log_ring()
    assert a is b
    assert a in logging.getLogger("h2o3_tpu_torch").handlers
    logging.getLogger("h2o3_tpu_torch").warning("ring line")
    assert any("ring line" in ln for ln in a.lines())


def _value(name, **labels):
    for r in ptm.METRICS.snapshot(include_buckets=False):
        if r["name"] == name and all(r["labels"].get(k) == v
                                     for k, v in labels.items()):
            return r["value"]
    return 0.0


def test_builds_parses_dkv_and_persist_move_the_families(tmp_path):
    from h2o3_tpu_torch.frame.parse import import_file
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.persist.model_io import load_model, save_model
    from h2o3_tpu_torch.utils.registry import DKV
    rng = np.random.default_rng(0)
    p = tmp_path / "t.csv"
    X = rng.normal(size=(300, 3))
    y = np.where(X[:, 0] > 0, "a", "b")
    p.write_text("x0,x1,x2,y\n" + "\n".join(
        f"{a:.4f},{b:.4f},{c:.4f},{d}" for (a, b, c), d in zip(X, y)))
    before = {k: _value(k) for k in ("h2o3_parse_rows_total",
                                     "h2o3_dkv_puts_total",
                                     "h2o3_dkv_gets_total")}
    builds0 = _value("h2o3_model_builds_total", algo="gbm")
    chunks0 = _value("h2o3_iteration_seconds_count", loop="gbm_chunk")
    fr = import_file(str(p), key="tele.hex")
    assert _value("h2o3_parse_rows_total") - before[
        "h2o3_parse_rows_total"] == 300
    m = GBM(ntrees=3, max_depth=2, seed=1).train(y="y", training_frame=fr)
    assert _value("h2o3_model_builds_total", algo="gbm") == builds0 + 1
    assert _value("h2o3_iteration_seconds_count",
                  loop="gbm_chunk") == chunks0 + 1
    assert _value("h2o3_dkv_puts_total") > before["h2o3_dkv_puts_total"]
    DKV.get("tele.hex")
    assert _value("h2o3_dkv_gets_total") > before["h2o3_dkv_gets_total"]
    assert _value("h2o3_dkv_keys") == len(DKV.keys())
    assert _value("h2o3_dkv_bytes", kind="frame") > 0
    w0 = _value("h2o3_persist_write_bytes_total", what="model")
    r0 = _value("h2o3_persist_read_bytes_total", what="model")
    path = save_model(m, str(tmp_path / "m.bin"))
    load_model(path, device="cpu")
    size = (tmp_path / "m.bin").stat().st_size
    assert _value("h2o3_persist_write_bytes_total", what="model") == w0 + size
    assert _value("h2o3_persist_read_bytes_total", what="model") == r0 + size
    assert _value("h2o3_dispatches_per_iteration", loop="gbm_round") > 0
