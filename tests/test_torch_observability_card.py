"""Card-only cases of the port's observability layer (``-m cuda``; they skip
where there is no card). This file imports no JAX. A ``torch.profiler``
capture around a GBM fit holds CUDA kernel events, ``fixed_hist_kernel``
among them, and the span names as ``record_function`` events; the compute
meter rates the GBM's sites against the H100 row, with a utilization that
is a number in (0, 1]; a probe never adds a host sync."""

import gzip
import json

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.utils.registry import DKV


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (CUPTI and CUDA events have "
                    "no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _reset():
    yield
    DKV.clear()


def frame(device, n=200_000):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return Frame.from_arrays({**{f"x{i}": X[:, i] for i in range(8)},
                              "y": y}, device=device)


@pytest.mark.cuda
def test_a_capture_holds_the_kernels_and_the_span_names(cuda_device):
    """A fit on this thread while the capture's window is open on another
    (as a REST capture and a REST build run): its kernels and its spans'
    names are in the artifact."""
    import threading
    import time

    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.ops.hist import node_totals
    from h2o3_tpu_torch.utils import tracing
    from h2o3_tpu_torch.utils.profiling import PROFILER, kernel_events
    fr = frame(cuda_device)
    GBM(ntrees=1, max_depth=3, seed=1).train(y="y", training_frame=fr)
    rec = {}
    th = threading.Thread(target=lambda: rec.update(
        PROFILER.capture(duration_ms=2500)))
    th.start()
    for _ in range(6000):
        if tracing.SPAN_HOOK is not None:
            break
        time.sleep(0.005)
    totals0 = node_totals.launches
    with tracing.TRACER.span("probe", root=True):
        GBM(ntrees=2, max_depth=3, seed=1).train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    th.join(timeout=60)
    body, _ = PROFILER.artifact_bytes(rec["capture_id"])
    trace = json.loads(gzip.decompress(body))
    names = [e["name"] for e in kernel_events(trace)]
    # 2 trees of 3 levels, each level one fixed launch (few nodes), and
    # the node totals of each tree: all fixed_hist_kernel instances
    fixed = sum("fixed_hist_kernel" in n for n in names)
    assert fixed == 2 * 3 + (node_totals.launches - totals0)
    user = {e["name"] for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"}
    assert {"gbm:fit", "gbm:chunk"} <= user


@pytest.mark.cuda
def test_the_meter_rates_the_gbm_against_the_h100_row(cuda_device):
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.utils.costs import COSTS, backend_peak
    COSTS.clear()
    fr = frame(cuda_device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        GBM(ntrees=3, max_depth=4, seed=1).train(y="y", training_frame=fr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    snap = COSTS.snapshot()
    assert backend_peak() is not None
    assert snap["peak"]["name"] == "NVIDIA H100 80GB HBM3"
    loops = snap["loops"]
    for loop in ("gbm_chunk", "gbm_grow"):
        util = loops[loop]["utilization"]
        assert util is not None and 0.0 < util <= 1.0, (loop, util)
        assert loops[loop]["achieved_bytes_per_sec"] > 0
