"""The port's compute meter (``h2o3_tpu_torch/utils/costs.py``) against the
JAX package's: the same signature pairs give the same diffs; the same
compile records give the same per-site tables and recompile events; the
peak table resolves the reference's TPU kinds alike and adds the H100 row;
off a card utilization is null. The port's sites: a new signature (shape,
dtype, statics) is a compile, a repeat is not; probes sample the first
call and every ``H2O3TPU_COSTS_SAMPLE``-th; ``H2O3TPU_COSTS_OFF`` records
nothing. Cost functions: a tree growth's level bytes are the histogram
kernel's bound bytes for that level's shape; an IRLS step's Gram is
2·R·P² FLOP. The kernel-build cache counts hits and misses by site.
"""

import pytest
import torch

from h2o3_tpu.utils import costs as jco
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.utils import costs as pco
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


def _sig(*shapes, dtype="float32", devices=None, **statics):
    args = []
    for s in shapes:
        a = {"shape": list(s), "dtype": dtype}
        if devices is not None:
            a["devices"] = devices
        args.append(a)
    return {"args": args, "statics": {k: repr(v) for k, v in statics.items()}}


PAIRS = [
    (_sig((100, 28)), _sig((200, 28))),
    (_sig((100, 28)), _sig((100, 28, 1))),
    (_sig((100, 28)), _sig((100, 28), dtype="int8")),
    (_sig((100, 28), depth=6), _sig((100, 28), depth=7)),
    (_sig((100, 28)), _sig((100, 28), (4,))),
    (_sig((8,), devices=[0]), _sig((8,), devices=[0, 1])),
    ({"args": [{"scalar": "int"}]}, {"args": [{"scalar": "float"}]}),
    (_sig((3,)), _sig((3,))),
]


@pytest.mark.parametrize("old,new", PAIRS)
def test_signature_diffs_are_the_references(old, new):
    assert pco.signature_diff(old, new) == jco.signature_diff(old, new)


@pytest.mark.parametrize("kind", [
    "TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v6e", "TPU v4", "TPU v3",
    "cpu", "NVIDIA A100-SXM4-80GB"])
def test_the_peak_table_keeps_the_references_rows(kind):
    assert pco.backend_peak(kind) == jco.backend_peak(kind)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "NVIDIA H100 NVL"])
def test_the_h100_row(kind):
    row = pco.backend_peak(kind)
    assert row == {"name": "NVIDIA H100 80GB HBM3", "flops_per_sec": 989.4e12,
                   "hbm_bytes_per_sec": 3.35e12}


def _records(co):
    m = co.CostMeter()
    m.record_compile("gbm:boost_scan", _sig((100, 28), rounds=20), 0.5,
                     1e9, 2e8, loop="gbm_chunk")
    m.record_compile("gbm:boost_scan", _sig((100, 28), rounds=20), 0.25,
                     1e9, 2e8, loop="gbm_chunk")          # repeat
    m.record_compile("gbm:boost_scan", _sig((100, 28), rounds=5), 0.1,
                     2.5e8, 5e7)                          # recompile
    m.record_compile("score:gbm", _sig((8, 28), bucket=8), 0.2, None, 1e4,
                     loop="scoring")
    m.record_eager_fallback("score:glm", loop="scoring")
    m.observe("gbm:boost_scan", 0.01)
    m.observe("score:gbm", 0.01)                          # no flops: no row
    m.observe("gbm:boost_scan", 0.0)                      # ignored
    snap = m.snapshot()
    return ({k: snap[k] for k in ("sites", "loops", "signature_count",
                                  "recompile_events")},
            m.signature_count(), m.recompile_count())


def test_the_same_records_give_the_same_tables():
    got, want = _records(pco), _records(jco)
    assert got == want
    loops = got[0]["loops"]
    assert loops["gbm_chunk"]["utilization"] is None   # no card here
    assert loops["gbm_chunk"]["achieved_bytes_per_sec"] == 5e9
    assert got[2] == 1


def _site(monkeypatch, sample="4"):
    monkeypatch.setenv("H2O3TPU_COSTS_SAMPLE", sample)
    pco.COSTS.clear()
    calls = []

    def cost(args, statics):
        calls.append(statics)
        return float(args[0].numel()), float(args[0].numel() * 4)
    return pco.accounted("t:site", cost, loop="t_loop"), calls


def test_a_new_signature_is_a_compile_and_probes_are_sampled(monkeypatch):
    site, calls = _site(monkeypatch)
    for n in (8, 8, 8, 8, 8, 16, 8):
        with site.dispatch((torch.ones(n),), {"k": 1}):
            pass
    snap = pco.COSTS.snapshot()
    [row] = [s for s in snap["sites"] if s["site"] == "t:site"]
    assert row["compiles"] == 2 and len(row["signatures"]) == 2
    assert len(calls) == 2                     # the cost function once each
    assert row["recompile_events"][0]["diff"] == ["arg0.shape[0]: 8 -> 16"]
    assert snap["loops"]["t_loop"]["samples"] == 2     # calls 0 and 4
    assert snap["loops"]["t_loop"]["utilization"] is None


def test_costs_off_records_nothing(monkeypatch):
    site, calls = _site(monkeypatch)
    monkeypatch.setenv("H2O3TPU_COSTS_OFF", "1")
    with site.dispatch((torch.ones(4),)):
        pass
    assert calls == [] and pco.COSTS.snapshot()["sites"] == []


def test_grow_cost_levels_are_the_kernels_bound_bytes():
    from h2o3_tpu_torch.models.tree import grow_cost
    from h2o3_tpu_torch.ops.hist import hist_bytes
    c = grow_cost(1_000_000, 28, 1, 6, 64, 1)
    assert c["level_bytes"] == [hist_bytes(1_000_000, 28, n, 65, 1)
                                for n in (1, 1, 2, 4, 8, 16)]
    assert c["bytes"] == sum(c["level_bytes"]) + 1_000_000 * 16 + 64 * 12
    k3 = grow_cost(1000, 5, 3, 2, 16, 2, w_per_class=True)
    assert k3["level_bytes"][0] == hist_bytes(1000, 5, 1, 17, 2, 3, True)


def test_a_gbm_fit_records_its_sites_and_scope(monkeypatch):
    import numpy as np

    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.tree import grow_cost
    pco.COSTS.clear()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 4)).astype(np.float32)
    fr = Frame.from_arrays({**{f"x{i}": X[:, i] for i in range(4)},
                            "y": (X[:, 0] > 0).astype(np.float32)})
    scopes = []
    real = pco.CostMeter.scope

    def spy(self, site):
        scopes.append(site)
        return real(self, site)
    monkeypatch.setattr(pco.CostMeter, "scope", spy)
    GBM(ntrees=3, max_depth=3, nbins=16, seed=1).train(y="y",
                                                       training_frame=fr)
    assert "fit:gbm" in scopes
    sites = {s["site"]: s for s in pco.COSTS.snapshot()["sites"]}
    one = grow_cost(500, 4, 1, 3, 16, 1)
    assert sites["gbm:grow_batched"]["bytes"] == one["bytes"]
    assert sites["gbm:boost_scan"]["bytes"] == 3 * one["bytes"]
    assert sites["gbm:grow_batched"]["signatures"][0]["signature"][
        "statics"] == {"depth": "3", "n_bins": "16"}


def test_an_irls_step_costs_its_gram():
    from h2o3_tpu_torch.models.glm import _irls_cost
    X = torch.ones(1000, 9)
    flops, nbytes = _irls_cost((X, torch.ones(1000)), {})
    assert flops == 2.0 * 1000 * 100 + 2.0 * 1000 * 10 + 1000 / 3.0
    assert nbytes == 1000 * 10 * 4 + 1000 * 8 + 100 * 4


def test_the_build_cache_counts_by_site(monkeypatch, tmp_path):
    from h2o3_tpu_torch.ops import _build
    from h2o3_tpu_torch.utils import compile_cache as cc
    cc.reset()
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("H2O3TPU_COMPILE_CACHE", raising=False)
    assert cc.enable() is False                  # opt-in
    monkeypatch.setenv("H2O3TPU_COMPILE_CACHE", str(tmp_path))
    assert cc.enable() is True
    assert _build.BUILD_DIR == tmp_path
    (tmp_path / "libh2o3_torch_0.so").write_bytes(b"")
    with pco.COSTS.scope("fit:gbm"):
        cc.note("misses")
        cc.note("hits")
    cc.note("hits")
    st = cc.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (2, 1, 1)
    assert st["by_site"] == {"fit:gbm": {"hits": 1, "misses": 1},
                             "(unattributed)": {"hits": 1, "misses": 0}}
    monkeypatch.setenv("H2O3TPU_COMPILE_CACHE", "off")
    assert cc.enable() is False
    cc.reset()


def test_cost_of_a_scorer():
    import numpy as np

    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    m = GBM(ntrees=2, max_depth=3, seed=1).train(
        y="y", training_frame=Frame.from_arrays(
            {"a": X[:, 0], "b": X[:, 1],
             "y": np.where(X[:, 0] > 0, "p", "n").astype(object)}))
    flops, nbytes = pco.cost_of(m, 64, 2, 0)
    assert flops == 2 * 64 * 2 * 3
    assert nbytes > 64 * 4 * 2
