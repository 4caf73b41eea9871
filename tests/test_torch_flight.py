"""The port's flight recorder (``h2o3_tpu_torch/utils/flight.py``) against
the JAX package's: the same samples ingested at the same injected times
give the same raw rings, rollup windows, queries, windows and stats; the
fixed-memory bounds drop the same overflow series; a sampler tick over
identical registries records the same series names. ``derived.mfu_min``
reads the compute meter's utilization of rated loops. Then the REST
surface: the port's server starts the recorder and ``/3/TimeSeries``
serves it, filtered as the reference's is.
"""

import math

import pytest
import torch

from h2o3_tpu.utils import flight as jfl
from h2o3_tpu.utils import telemetry as jtm
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import flight as pfl
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


def _feed(fl):
    rec = fl.FlightRecorder(interval_s=0.5, raw_len=16, rollup_len=16,
                            rollup_secs=2.0, max_series=8)
    t = 1_000.0
    for i in range(40):
        t += 0.25
        rec.ingest("h2o3_requests_total", float(i * 3),
                   labels={"route": "/3/Cloud", "method": "GET"}, now=t)
        rec.ingest("h2o3_dkv_keys", float(i % 5), now=t)
        rec.ingest("derived.host_rss_bytes", 1e9 + i * 1e6, now=t)
    # non-numeric and non-finite samples are refused
    assert rec.ingest("bad", "x", now=t) is False
    rec.ingest("nan", math.nan, now=t)
    # overflow: past max_series, series are counted and dropped
    for k in range(10):
        rec.ingest(f"extra_{k}", 1.0, now=t)
    return rec


def test_the_same_samples_give_the_same_record():
    got, want = _feed(pfl), _feed(jfl)
    assert got.query() == want.query()
    assert got.query(name="h2o3_", since=1_005.0) == \
        want.query(name="h2o3_", since=1_005.0)
    assert got.query(labels={"route": "/3/Cloud"}) == \
        want.query(labels={"route": "/3/Cloud"})
    assert got.values("h2o3_dkv_keys") == want.values("h2o3_dkv_keys")
    assert got.window("derived.host_rss_bytes") == \
        want.window("derived.host_rss_bytes")
    assert got.window("absent") is None and want.window("absent") is None
    g, w = got.stats(), want.stats()
    assert g == w and g["dropped_series"] > 0
    assert got.export() == want.export()


def test_rollups_carry_min_max_mean_last():
    rec = _feed(pfl)
    [row] = rec.query(name="h2o3_dkv_keys")
    assert row["rollup"]
    for w in row["rollup"]:
        assert w["min"] <= w["mean"] <= w["max"]
        assert {"t", "min", "max", "mean", "last", "count"} <= set(w)


def test_a_tick_records_the_same_series_names(monkeypatch):
    for fl in (pfl, jfl):
        monkeypatch.setattr(fl, "_derived_rss", lambda: 1.0)
    # fresh registries of the same catalog, so both ticks see alike
    preg, jreg = ptm.MetricsRegistry(), jtm.MetricsRegistry()
    for reg in (preg, jreg):
        reg.counter("h2o3_x", "", ("k",)).labels(k="a").inc(2)
        reg.gauge("h2o3_g").set(5)
        reg.histogram("h2o3_h", buckets=(1.0,)).observe(0.5)
    monkeypatch.setattr(ptm, "METRICS", preg)
    monkeypatch.setattr(jtm, "METRICS", jreg)
    prec, jrec = pfl.FlightRecorder(interval_s=1.0), \
        jfl.FlightRecorder(interval_s=1.0)
    prec.sample_once(now=5.0)
    jrec.sample_once(now=5.0)
    got = {n for n in prec.series_names() if not n.startswith("derived.")}
    want = {n for n in jrec.series_names() if not n.startswith("derived.")}
    assert got == want and "h2o3_x_total" in got
    assert prec.values("h2o3_g") == jrec.values("h2o3_g") == [5.0]


def test_mfu_min_reads_the_meters_rated_loops(monkeypatch):
    from h2o3_tpu_torch.utils.costs import COSTS
    monkeypatch.setattr(COSTS, "loops", lambda: {
        "gbm_chunk": {"utilization": 0.02, "samples": 5},
        "glm_irls": {"utilization": 0.004, "samples": 9},
        "scoring": {"utilization": 0.0001, "samples": 1},
        "dl_epoch": {"utilization": None, "samples": 9}})
    assert pfl._derived_mfu_min() == 0.004
    monkeypatch.setattr(COSTS, "loops", lambda: {})
    assert pfl._derived_mfu_min() is None


def test_the_server_starts_the_recorder_and_serves_timeseries(monkeypatch):
    from h2o3_tpu_torch.api import H2OClient, H2OServer
    from h2o3_tpu_torch.utils.flight import FLIGHT
    monkeypatch.setenv("H2O3TPU_FLIGHT_INTERVAL_SECS", "0.05")
    FLIGHT.reset()
    s = H2OServer(port=0).start()
    try:
        assert FLIGHT.running()
        c = H2OClient(s.url)
        c.cloud_status()
        FLIGHT.sample_once()
        ts = c.timeseries(name="h2o3_requests")
        assert ts["series"] and ts["running"]
        assert all(r["name"].startswith("h2o3_requests")
                   for r in ts["series"])
        ts = c.timeseries(name="h2o3_requests", labels={"method": "GET"})
        assert all(r["labels"].get("method") == "GET" for r in ts["series"])
    finally:
        s.stop()
    assert not FLIGHT.running()
