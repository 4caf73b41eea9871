"""The port's ``windowed_parallel`` (``h2o3_tpu_torch/orchestration/
parallel_build.py``) through the four cases of
tests/test_parallel_build.py, each also run through the JAX package's
``windowed_parallel`` on the same ``run_one``, whose results (items,
values and errors, in submission order, and whether the stream ended)
must be equal; then the stream lease of the port's scheduler, which on
the CPU has no stream and never serialises a one-slice layout."""

import contextvars
import threading
import time

import pytest

from h2o3_tpu.orchestration.parallel_build import \
    windowed_parallel as jwindowed
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.orchestration import scheduler as psched
from h2o3_tpu_torch.orchestration.parallel_build import windowed_parallel
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    set_device("cpu")
    yield
    set_device(None)


def _same(out_p, out_j):
    (rp, ep), (rj, ej) = out_p, out_j
    assert ep == ej
    assert [(i, r, type(e), str(e)) for i, r, e in rp] == \
        [(i, r, type(e), str(e)) for i, r, e in rj]


def test_results_in_submission_order():
    def run(i):
        time.sleep(0.02 * (5 - i))       # later items finish first
        return i * 10

    out, exhausted = windowed_parallel(range(5), 3, lambda n: True, run)
    assert exhausted
    assert [item for item, _, _ in out] == [0, 1, 2, 3, 4]
    assert [res for _, res, _ in out] == [0, 10, 20, 30, 40]
    _same((out, exhausted), jwindowed(range(5), 3, lambda n: True, run))


def test_window_respects_parallelism():
    active, peak = [0], [0]
    lock = threading.Lock()

    def run(i):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.02)
        with lock:
            active[0] -= 1
        return i

    out = windowed_parallel(range(8), 2, lambda n: True, run)
    assert peak[0] <= 2
    _same(out, jwindowed(range(8), 2, lambda n: True, run))


@pytest.mark.parametrize("par", [1, 2])
def test_budget_gate_stops_submission(par):
    ran = []

    def run(i):
        ran.append(i)
        return i

    out, exhausted = windowed_parallel(range(100), par, lambda n: n < 5, run)
    assert not exhausted                 # a budget stop, not the stream end
    assert len(out) == 5
    assert len(ran) == 5                 # never advanced past the gate
    _same((out, exhausted), jwindowed(range(100), par, lambda n: n < 5, run))


@pytest.mark.parametrize("par", [1, 2])
def test_failures_recorded_not_raised(par):
    def run(i):
        if i == 2:
            raise ValueError("boom")
        return i

    out, ended = windowed_parallel(range(4), par, lambda n: True, run)
    assert [e is not None for _, _, e in out] == [False, False, True, False]
    assert isinstance(out[2][2], ValueError)
    _same((out, ended), jwindowed(range(4), par, lambda n: True, run))


def test_a_failure_releases_its_budget():
    """The gate counts successes and builds in flight: with a budget of 3
    and item 1 failing, items 0, 2 and 3 succeed, at both parallelisms,
    in both packages."""
    def run(i):
        if i == 1:
            raise RuntimeError("bad")
        return i

    for par in (1, 2):
        out = windowed_parallel(range(10), par, lambda n: n < 3, run)
        assert [i for i, r, e in out[0] if e is None] == [0, 2, 3]
        _same(out, jwindowed(range(10), par, lambda n: n < 3, run))


def test_context_variables_reach_the_builds():
    var = contextvars.ContextVar("run_id", default=None)
    var.set("run-7")
    out, _ = windowed_parallel(range(3), 2, lambda n: True,
                               lambda i: var.get())
    assert [r for _, r, _ in out] == ["run-7"] * 3


def test_leases_on_the_cpu_have_no_stream_and_pair_up():
    """Two slices: two builds hold a lease at once, a third waits; one
    slice: builds share it and never wait. The rollup counts them."""
    psched.SLICE_STATS.reset()
    sched = psched.MeshScheduler(slices=2)
    assert sched.device.type == "cpu"
    active, peak = [0], [0]
    lock = threading.Lock()

    def run(i):
        with sched.lease(rows=100, algo="gbm") as lease:
            assert lease.stream is None and lease.index in (0, 1)
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.05)
            with lock:
                active[0] -= 1
        return i

    out, _ = windowed_parallel(range(6), 3, lambda n: True, run)
    assert [r for _, r, _ in out] == list(range(6)) and peak[0] == 2
    assert sched.free_count() == 2
    one = psched.MeshScheduler(slices=1)
    with one.lease() as a, one.lease() as b:
        assert a.label == b.label == "full"
    snap = psched.SLICE_STATS.snapshot()
    assert snap["count"] == 2
    assert sum(s["builds"] for s in snap["slices"]) == 8
