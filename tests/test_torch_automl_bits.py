"""The port's AutoML (``h2o3_tpu_torch/orchestration/automl.py``) repeated
bit for bit at parallelism 1 and 2 (the JAX package's contract for its own
AutoML), model by model in plan order: every tree, every CV metric, the
metalearner's coefficients and the leaderboard. Port only: the JAX
package's AutoML is held against in tests/test_torch_automl_runs.py."""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.orchestration.automl import AutoML
from h2o3_tpu_torch.utils.registry import DKV


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
def _clear_port_dkv():
    """Each test starts and ends with an empty port DKV (other files'
    models may share this process)."""
    DKV.clear()
    yield
    DKV.clear()


def _trees(m):
    out = m.output
    return out.get("trees_multi") or [out.get("trees") or []]


def _same_model(a, b):
    assert a.algo == b.algo and a.params.get("max_depth") == \
        b.params.get("max_depth")
    for ta, tb in zip(_trees(a), _trees(b)):
        for x, y in zip(ta, tb):
            for f in HEAP_FIELDS:
                assert torch.equal(getattr(x, f), getattr(y, f)), f
    if a.algo == "glm":
        assert torch.equal(a.output["beta"], b.output["beta"])
    if a.algo == "stackedensemble":
        assert torch.equal(a.output["metalearner"].output["beta"],
                           b.output["metalearner"].output["beta"])
    else:
        assert torch.equal(a.cv_holdout_predictions,
                           b.cv_holdout_predictions)
    ca, cb = a.cross_validation_metrics, b.cross_validation_metrics
    assert (ca.auc, ca.logloss) == (cb.auc, cb.logloss)


def test_parallelism_one_and_two_repeat_bit_for_bit():
    """Sampling on (the GBM steps' 0.8 row and column rates): plan order,
    models and the leaderboard the same bits."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(320, 3)).astype(np.float32)
    y = np.where(X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=320)
                 > 0, "t", "f")
    fr = Frame.from_arrays({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                            "y": y})
    runs = []
    for par in (1, 2):
        aml = AutoML(max_models=3, nfolds=2, seed=11, parallelism=par,
                     project_name="bits",
                     include_algos=["GLM", "GBM", "STACKEDENSEMBLE"])
        aml.train(y="y", training_frame=fr)
        runs.append(aml)
    steps = [[m for m in aml.leaderboard._rows] for aml in runs]
    assert [r["algo"] for r in steps[0]] == [r["algo"] for r in steps[1]]
    assert [r["algo"] for r in steps[0]] == ["glm", "gbm", "gbm",
                                             "stackedensemble",
                                             "stackedensemble"]
    for ra, rb in zip(*steps):
        _same_model(ra["_model"], rb["_model"])
    rank = [[(r["algo"], r["auc"]) for r in aml.leaderboard._sorted()]
            for aml in runs]
    assert rank[0] == rank[1]
