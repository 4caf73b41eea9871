"""Card-only case of the port's grid search (``-m cuda``; it skips where
there is no card). This file imports no JAX: parallelism 2 (two builds in
flight, each on a CUDA stream of its own) is held against parallelism 1
on the card.

AutoML's GBM grid (RandomDiscrete, search seed 42, builder seed 1, 6 of
its 108 points) at toy size: the model ids are equal at both
parallelisms, and a model whose every level runs the fixed-point
histogram kernel (max_depth 7 or less at 65 bins: its last level
histograms 32 nodes, fewer than the 64 where the global kernel takes
over) has the same trees bit for bit, its sums being exact. A deeper
model's levels of 64 nodes or more run the global kernel, whose float
reductions vary from run to run, so it is held to the training AUC
within 1e-3. The streams' pool gives the builds two streams.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.orchestration import scheduler
from h2o3_tpu_torch.orchestration.grid import GridSearch
from h2o3_tpu_torch.utils.registry import DKV

#: AutoML's GBM grid (h2o3_tpu/orchestration/automl.py:138-153)
AUTOML_GBM = {"max_depth": [3, 5, 7, 9], "learn_rate": [0.05, 0.1, 0.2],
              "sample_rate": [0.6, 0.8, 1.0],
              "col_sample_rate": [0.4, 0.7, 1.0]}


def grid_cols(n, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.where(x[:, 0] + x[:, 1] + 0.5 * rng.normal(size=n) > 0, "t", "f")
    return {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "y": y}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    """Each test starts and ends with an empty port DKV (other files'
    models may share this process, and the grids here reuse one id)."""
    DKV.clear()
    yield
    DKV.clear()


def _bitwise(a, b) -> bool:
    return all(torch.equal(getattr(ta, f), getattr(tb, f))
               for ta, tb in zip(a.output["trees"], b.output["trees"])
               for f in HEAP_FIELDS)


@pytest.mark.cuda
def test_grid_parallelism_two_matches_one_on_card(cuda_device):
    fr = Frame.from_arrays(grid_cols(20_000), device=cuda_device)
    crit = dict(strategy="RandomDiscrete", max_models=6, seed=42)
    grids = [GridSearch(GBM, AUTOML_GBM, grid_id="card_grid",
                        search_criteria=crit, parallelism=par, ntrees=10,
                        seed=1, nbins=64).train(y="y", training_frame=fr)
             for par in (1, 2)]
    assert grids[0].model_ids == grids[1].model_ids
    assert len(grids[0].models) == 6
    for a, b in zip(grids[0].models, grids[1].models):
        if a.params["max_depth"] <= 7:
            assert _bitwise(a, b), a.key
        else:
            assert abs(a.training_metrics.auc - b.training_metrics.auc) \
                < 1e-3
    leases = scheduler.SLICE_STATS.snapshot()["slices"]
    assert {s["slice"] for s in leases} >= {"0", "1"}


@pytest.mark.cuda
def test_overlapped_builds_of_other_kernel_shapes_all_launch(cuda_device):
    """Two builds in flight whose levels take other kernels and shared
    memory sizes (XGBoost's 257 int16 bins beside GBM's 65 int8 bins, the
    global kernel at their deep levels): each launch sets its kernel's
    process-wide shared-memory ceiling first, so the launches must not
    interleave (a launch above the other thread's lower ceiling is
    refused). Every build succeeds, and each fixed-kernel model equals
    its build at parallelism 1 bit for bit."""
    from h2o3_tpu_torch.models.xgboost import XGBoost
    from h2o3_tpu_torch.orchestration.parallel_build import windowed_parallel
    from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
    fr = Frame.from_arrays(grid_cols(200_000), device=cuda_device)
    steps = [(cls, d) for d in (3, 9, 4, 8) for cls in (XGBoost, GBM)]

    def build(step):
        cls, depth = step
        return cls(ntrees=8, max_depth=depth, seed=1).train(
            y="y", training_frame=fr)

    runs = {par: windowed_parallel(steps, par, lambda n: True, build,
                                   scheduler=MeshScheduler(slices=par))[0]
            for par in (2, 1)}
    assert all(e is None for _, _, e in runs[2]), \
        [str(e) for _, _, e in runs[2] if e is not None]
    for (step, a, _), (_, b, _) in zip(runs[1], runs[2]):
        cls, depth = step
        if (cls is GBM and depth <= 7) or (cls is XGBoost and depth <= 5):
            assert _bitwise(a, b), (cls.__name__, depth)
