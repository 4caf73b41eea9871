"""The port's rank mesh, its single-process runtime and map_reduce
(``h2o3_tpu_torch/parallel/``, ``ops/map_reduce.py``), held against the
JAX package's ``parallel/mesh.py``, ``parallel/distributed.py`` and
``ops/map_reduce.py`` in one process.

- Mesh carving: the port's ``slice_meshes`` of an 8-rank mesh against the
  JAX package's of its 8-device global mesh (tests/conftest.py): the same
  blocks of positions, clamped to the same divisors, degrading alike
  (tests/test_mesh_slices.py's cases); ``padded_len`` alike, against the
  global count and widened to the lcm of a bound non-divisor mesh;
  contextvar bindings isolated across threads.
- The single-process paths of ``distributed`` (tests/test_distributed.py's
  cases): identity, fetch, barrier, shutdown, the double-init guard (the
  join itself faked, so no socket is opened), and the retried allgather:
  absorption, exhaustion and injected faults, exactly as the reference's.
- map_reduce on one rank: the identity reduction, its telemetry, the
  ejection hook, and ``segment_sum_cols`` against the reference's.
- The fixed-point sums across ranks on the CPU: the scale rule on device
  counts equals the host rule, and two row halves' counts and
  accumulators, summed, equal the one-rank plain fixed histograms bit for
  bit (the CPU side of what phase 20 of chip_smoke.py checks on the card).
"""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.parallel import distributed as jdist
from h2o3_tpu.parallel import mesh as JM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.ops import hist as H
from h2o3_tpu_torch.ops import map_reduce as mr
from h2o3_tpu_torch.parallel import distributed as dist
from h2o3_tpu_torch.parallel import mesh as M
from jax_reference import _jax_compile_cache  # noqa: F401

# the module (the package exports a function of the same name)
jmr = importlib.import_module("h2o3_tpu.ops.map_reduce")


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setenv("H2O3TPU_DISPATCH_BACKOFF_MS", "1")


BASE = M.Mesh(range(8))


def _positions(slices, base_ids):
    return [[base_ids.index(i) for i in ids] for ids in slices]


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 8, 64])
def test_slice_meshes_carve_as_the_reference(k):
    """Disjoint contiguous blocks covering the base, k clamped to the
    largest divisor <= k, [base] at k <= 1 — the reference's carving."""
    jslices = JM.slice_meshes(k)
    jids = list(JM.mesh_device_ids(JM.global_mesh()))
    pslices = M.slice_meshes(k, base=BASE)
    assert _positions([list(JM.mesh_device_ids(m)) for m in jslices],
                      jids) == [list(m.ranks) for m in pslices]
    if k <= 1:
        assert pslices == [BASE] and pslices[0] is BASE
    ids = [set(M.mesh_device_ids(m)) for m in pslices]
    assert set().union(*ids) == set(BASE.ranks)
    assert sum(map(len, ids)) == 8


def test_get_mesh_prefers_the_bound_slice():
    s0 = M.slice_meshes(2, base=BASE)[0]
    g = M.global_mesh()
    assert M.get_mesh() is g and M.num_global_devices() == 1
    with M.bind_mesh(s0):
        assert M.get_mesh() is s0 and M.num_devices() == 4
        assert M.bound_mesh() is s0
        # padding stays a global invariant inside a binding (lcm with 4)
        from h2o3_tpu_torch.frame.vec import padded_len
        assert padded_len(100) % (4 * 8) == 0
    assert M.get_mesh() is g and M.bound_mesh() is None


def test_mesh_context_concurrent_threads_no_clobber():
    """Interleaved bindings on two threads each see their own mesh, and
    neither exit moves the process-global mesh."""
    s0, s1 = M.slice_meshes(2, base=BASE)
    g = M.global_mesh()
    inside = threading.Barrier(2, timeout=10)
    seen, errs = {}, []

    def worker(name, mesh):
        try:
            with M.mesh_context(mesh):
                inside.wait()
                seen[name] = M.get_mesh()
                inside.wait()
        except Exception as e:   # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=a)
               for a in (("a", s0), ("b", s1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and seen["a"] is s0 and seen["b"] is s1
    assert M.get_mesh() is g and M.global_mesh() is g


@pytest.mark.parametrize("nrows,ndev", [(100, 1), (100, 3), (1000, 8),
                                        (0, 2), (64, 8)])
def test_padded_len_is_the_references(nrows, ndev):
    from h2o3_tpu.frame.vec import padded_len as jpadded
    from h2o3_tpu_torch.frame.vec import padded_len
    assert padded_len(nrows, ndev) == jpadded(nrows, ndev)


def test_non_divisor_submesh_widens_the_unit_to_the_lcm():
    """A bound mesh of 3 ranks: the padded length divides by both the
    bound mesh's unit and the global one, as the reference's does on its
    8-device cloud."""
    from h2o3_tpu.frame.vec import padded_len as jpadded
    from h2o3_tpu_torch.frame.vec import padded_len
    from jax.sharding import Mesh
    with M.mesh_context(M.Mesh(range(3))):
        plen = padded_len(100)
    with JM.mesh_context(Mesh(np.array(jax.devices()[:3]),
                              axis_names=(JM.ROWS,))):
        jplen = jpadded(100)
    assert plen % (3 * 8) == 0
    # the reference's global unit is 8 devices, the port's one rank
    assert jplen % (3 * 8) == 0 and jplen % (8 * 8) == 0


def test_one_rank_holds_every_row_and_rehome_moves_tensors():
    assert M.row_sharding(37) == (0, 37)
    assert M.replicated_sharding(37) == (0, 37)
    model = {"a": [torch.zeros(2)], "t": (torch.ones(1),)}
    assert M.rehome(model, torch.device("cpu")) is model
    assert model["t"][0].device.type == "cpu"


# -- distributed: the single-process paths (tests/test_distributed.py) --------

@pytest.fixture
def _fake_join(monkeypatch):
    """The coordinator lifecycle without a coordinator: the join and the
    leave are faked, so no socket is opened and no peer is waited for."""
    calls = []
    monkeypatch.setattr(dist, "_join", lambda *a: calls.append(a) or (
        None, "gloo", ["host/cpu", "host/cpu"]))
    monkeypatch.setattr(dist, "_leave", lambda: None)
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setattr(dist, "_init_args", None)
    yield calls
    dist._initialized = False
    dist._init_args = None
    dist._device = dist._backend = None
    dist._placements = []
    M.set_mesh(None)
    set_device("cpu")


def test_process_identity_single_process():
    assert dist.process_count() == jdist.process_count() == 1
    assert dist.process_index() == jdist.process_index() == 0
    assert not dist.is_multiprocess() and not jdist.is_multiprocess()


def test_fetch_a_tensor_single_process():
    out = dist.fetch(torch.arange(16, dtype=torch.float32))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, jdist.fetch(
        jnp.arange(16, dtype=jnp.float32)))


def test_fetch_a_row_blocked_frame_column_single_process():
    from h2o3_tpu_torch.frame.frame import Frame
    fr = Frame.from_arrays({"a": np.arange(32, dtype=np.float32)})
    assert fr.block is None
    np.testing.assert_array_equal(dist.fetch(fr.vec("a").data),
                                  np.arange(32, dtype=np.float32))


def test_fetch_non_tensor_values_pass_through():
    for v in (np.array([1.0, 2.0]), [3, 4]):
        np.testing.assert_array_equal(dist.fetch(v), jdist.fetch(v))


def test_barrier_is_noop_single_process():
    dist.barrier("test")
    jdist.barrier("test")


def test_shutdown_idempotent():
    dist.shutdown_distributed()
    dist.shutdown_distributed()


def test_init_single_process_installs_mesh_only():
    dist.init_distributed()
    assert M.global_mesh().shape["rows"] == 1 and M.global_mesh().group is None


def test_reinit_same_coordinator_args_is_idempotent(_fake_join):
    calls = _fake_join
    dist.init_distributed("10.0.0.1:1234", num_processes=2, process_id=0,
                          device="cpu")
    assert len(calls) == 1 and dist._initialized
    dist.init_distributed("10.0.0.1:1234", num_processes=2, process_id=0,
                          device="cpu")
    assert len(calls) == 1
    assert dist.backend() == "gloo" and dist.placements() == [
        "host/cpu", "host/cpu"]


def test_reinit_different_coordinator_args_raises(_fake_join):
    dist.init_distributed("10.0.0.1:1234", num_processes=2, process_id=0,
                          device="cpu")
    with pytest.raises(RuntimeError, match="different\\s+coordinator"):
        dist.init_distributed("10.0.0.2:9999", num_processes=4, process_id=1,
                              device="cpu")
    with pytest.raises(RuntimeError, match="different\\s+coordinator"):
        dist.init_distributed("10.0.0.1:1234", num_processes=2, process_id=0,
                              local_device_ids=[2, 3], device="cpu")
    assert dist._init_args == ("10.0.0.1:1234", 2, 0, None, "cpu")
    dist.shutdown_distributed()
    assert not dist._initialized and dist._init_args is None


def test_backend_rule():
    """nccl when every rank has a card of its own; gloo on the CPU and
    where two ranks share a card."""
    assert dist.choose_backend(["a/cuda:0", "a/cuda:1"]) == "nccl"
    assert dist.choose_backend(["a/cuda:0", "b/cuda:0"]) == "nccl"
    assert dist.choose_backend(["a/cuda:0"]) == "nccl"
    assert dist.choose_backend(["a/cuda:0", "a/cuda:0"]) == "gloo"
    assert dist.choose_backend(["a/cpu", "b/cpu"]) == "gloo"


def _flaky(attempts, fail_times, err="transient link hiccup"):
    def gather(t):
        attempts.append(1)
        if len(attempts) <= fail_times:
            raise RuntimeError(err)
        return t
    return gather


def test_allgather_retries_transient_failures(monkeypatch):
    """fetch's cross-rank gather runs under the dispatch retry budget, as
    the reference's does: one transient failure is absorbed."""
    from jax.experimental import multihost_utils
    ours, theirs = [], []
    monkeypatch.setattr(dist, "all_gather_blocks", _flaky(ours, 1))
    monkeypatch.setattr(
        multihost_utils, "process_allgather",
        lambda arr, tiled=True: _flaky(theirs, 1)(np.asarray(arr)))
    out = dist._allgather(torch.tensor([1.0, 2.0]))
    np.testing.assert_array_equal(out, jdist._allgather(
        np.array([1.0, 2.0], np.float32)))
    assert len(ours) == len(theirs) == 2


def test_allgather_exhaustion_raises_structured(monkeypatch):
    from jax.experimental import multihost_utils
    monkeypatch.setenv("H2O3TPU_DISPATCH_RETRIES", "1")
    monkeypatch.setattr(dist, "all_gather_blocks", _flaky([], 99, "link down"))
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda arr, tiled=True: _flaky([], 99, "link down")(
                            arr))
    with pytest.raises(mr.DispatchFailed) as ours:
        dist._allgather(torch.tensor([1.0]))
    with pytest.raises(jmr.DispatchFailed) as theirs:
        jdist._allgather(np.array([1.0], np.float32))
    assert ours.value.fn == theirs.value.fn == "allgather"
    assert len(ours.value.history) == len(theirs.value.history) == 2


def test_allgather_faults_injectable(monkeypatch):
    from h2o3_tpu_torch.utils.timeline import inject_faults
    monkeypatch.setenv("H2O3TPU_DISPATCH_RETRIES", "2")
    monkeypatch.setattr(dist, "all_gather_blocks", lambda t: t)
    with inject_faults(site_rates={"allgather": {"drop_rate": 1.0}}) as inj:
        with pytest.raises(mr.DispatchFailed) as ei:
            dist._allgather(torch.tensor([7.0]))
    assert inj.dropped == 3
    assert all("FaultInjected" in h["error"] for h in ei.value.history)


# -- map_reduce on one rank ---------------------------------------------------

def test_map_reduce_on_one_rank_is_the_map_and_feeds_its_families():
    from h2o3_tpu_torch.utils import telemetry as tm

    def partials(x, w):
        return {"sum": (x * w).sum(), "n": torch.stack([w.sum(), x.max()])}

    x, w = torch.arange(10.0), torch.ones(10)
    before = tm.MR_DISPATCHES.labels(fn="partials").value
    out = mr.map_reduce(partials, x, w)
    assert out["sum"].item() == 45.0 and out["n"].tolist() == [10.0, 9.0]
    assert tm.MR_DISPATCHES.labels(fn="partials").value == before + 1
    assert mr.mesh_reduce(partials, x, w)["sum"].item() == 45.0


def test_map_reduce_traces_a_partition_span_a_rank(monkeypatch):
    from h2o3_tpu_torch.utils import tracing as tr
    monkeypatch.setenv("H2O3TPU_TRACE_PARTITIONS", "1")
    with tr.TRACER.span("root", root=True) as root:
        mr.map_reduce(lambda x: x.sum(), torch.ones(4))
    spans = tr.TRACER.get_trace(root.trace_id)["spans"]
    parts = [s for s in spans if s["name"].startswith("partition:")]
    disp = [s for s in spans if s["name"].startswith("map_reduce:")]
    assert len(parts) == 1 and disp[0]["attrs"]["straggler"] == 0


def test_ejection_scope_hears_an_exhausted_budget(monkeypatch):
    from h2o3_tpu_torch.utils.timeline import inject_faults
    monkeypatch.setenv("H2O3TPU_DISPATCH_RETRIES", "1")
    heard = []
    with mr.ejection_scope(lambda fn, hist: heard.append((fn, len(hist)))):
        with inject_faults(site_rates={"map_reduce": {"drop_rate": 1.0}}):
            with pytest.raises(mr.DispatchFailed):
                mr.map_reduce(lambda x: x.sum(), torch.ones(3))
    assert heard == [("map_reduce", 2)]


def test_segment_sum_cols_matches_the_reference():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(64, 2)).astype(np.float32)
    ids = rng.integers(-1, 5, 64).astype(np.int32)
    ours = mr.segment_sum_cols(torch.tensor(vals), torch.tensor(ids), 5)
    theirs = jmr.segment_sum_cols(jnp.asarray(vals), jnp.asarray(ids), 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        mr.map_cols(lambda a: a * 2, torch.ones(3)).numpy(), [2, 2, 2])


# -- the fixed-point sums across ranks, on the CPU ----------------------------

def _stats(rng, K, R, N, outliers):
    node = torch.tensor(rng.integers(-1, N + 1, size=(K, R)),
                        dtype=torch.int32)
    g = torch.tensor(rng.normal(size=(K, R)), dtype=torch.float32)
    if outliers:
        g[0, :5] *= 1e6
    h = torch.tensor(rng.random((K, R)) + 0.1, dtype=torch.float32)
    w = torch.tensor(rng.integers(0, 3, R), dtype=torch.float32)
    return node, g, h, w


@pytest.mark.parametrize("K,R,N,outliers", [(1, 1000, 1, False),
                                            (1, 3001, 4, True),
                                            (2, 777, 3, True),
                                            (1, 60, 2, False)])
def test_scale_rule_on_counts_is_the_host_rule(K, R, N, outliers):
    node, g, h, w = _stats(np.random.default_rng(R), K, R, N, outliers)
    q = H.fixed_needed_qbits(R, N, 9)
    exps, bad = H.fixed_exponents(node, g, h, w, N, q)
    e2, b2 = H.exponents_from_counts(
        H.fixed_counts_plain(node, g, h, w, N), q)
    assert e2.tolist() == exps and b2.tolist() == bad


@pytest.mark.parametrize("K,R,N,outliers", [(1, 1000, 1, False),
                                            (1, 3001, 4, True),
                                            (2, 777, 3, True)])
def test_two_halves_summed_equal_one_rank(K, R, N, outliers):
    rng = np.random.default_rng(R + K)
    node, g, h, w = _stats(rng, K, R, N, outliers)
    Bt = 9
    b = torch.tensor(rng.integers(-1, Bt, size=(3, R)), dtype=torch.int8)
    q = H.fixed_needed_qbits(R, N, Bt)
    one = H.level_histograms_fixed_plain(b, node, g, h, w, N, Bt, q)
    cut = R // 3
    halves = [(b[:, a:c].contiguous(), node[:, a:c], g[:, a:c], h[:, a:c],
               w[a:c]) for a, c in ((0, cut), (cut, R))]
    counts = sum(H.fixed_counts_plain(pn, pg, ph, pw, N)
                 for _, pn, pg, ph, pw in halves)
    exps, bad = H.exponents_from_counts(counts, q)
    acc = sum(H.fixed_acc_plain(pb, pn, pg, ph, pw, N, Bt, exps.tolist(),
                                bad.tolist())
              for pb, pn, pg, ph, pw in halves)
    got = H.fixed_from_acc(acc, exps, bad)
    assert torch.equal(got.view(torch.int32), one.view(torch.int32))
    with H.fixed_point_on_cpu():
        mesh = H.mesh_level_histograms(b, node, g, h, w, N, Bt)
        tot = H.mesh_node_totals(node, g, h, w, N)
    assert torch.equal(mesh.view(torch.int32), one.view(torch.int32))
    assert torch.equal(tot, H.node_totals_fixed_plain(node, g, h, w, N))
