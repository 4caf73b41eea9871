"""Card-only cases of the port's scoring tier (``-m cuda``; they skip where
there is no card). This file imports no JAX. A GBM's and a GLM's bucket is
captured as a CUDA graph (``mode == "graph"``), replayed twice on the same
rows bit for bit, and equal bit for bit to ``predict`` on the frame those
rows came from; dropping the model frees its graphs' memory."""

import gc

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.serving import SCORING, ScorerCache, serving_schema
from h2o3_tpu_torch.utils.registry import DKV

N = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _reset():
    yield
    SCORING.reset()
    DKV.clear()


def frame(device):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    X[::13, 1] = np.nan
    g = rng.choice(np.array(["u", "v", "w"]), N)
    y = np.where(X[:, 0] - X[:, 1] + 0.4 * (g == "v") > 0, "yes", "no")
    return Frame.from_arrays({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                              "g": g, "y": y}, device=device)


def fit(algo, fr):
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.glm import GLM
    b = (GBM(ntrees=6, max_depth=4, seed=1) if algo == "gbm"
         else GLM(family="binomial", lambda_=1e-4))
    return b.train(y="y", training_frame=fr)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gbm", "glm"])
def test_a_captured_bucket_replays_bit_for_bit(cuda_device, algo):
    fr = frame(cuda_device)
    model = fit(algo, fr)
    schema = serving_schema(model)
    cache = ScorerCache()
    scorer = cache.get(model, schema, 64)
    assert scorer.mode == "graph", scorer.error
    rows = np.arange(5, 5 + 64 * 7, 7)
    num = np.stack([fr.vec(c).to_numpy()[rows] for c in schema.num_cols], 1)
    cat = np.stack([fr.vec(c).to_numpy()[rows] for c in schema.cat_cols], 1)
    first = scorer.score(num, cat.astype(np.int32))
    again = scorer.score(num, cat.astype(np.int32))
    assert np.array_equal(first, again)
    want = model.predict(fr).vec("pyes").to_numpy()[rows]
    assert np.array_equal(first[:, 1], want)
    st = cache.stats()
    assert (st["graph"], st["eager"], st["signatures"]) == (1, 0, 1)


@pytest.mark.cuda
def test_dropping_a_model_frees_its_graphs(cuda_device):
    fr = frame(cuda_device)
    model = fit("gbm", fr)
    DKV.put(model.key, model)
    rows = [{"a": 0.1 * i, "b": None, "c": -0.2, "g": "v"} for i in range(9)]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = SCORING.score(model.key, rows)
    assert SCORING.stats()["modes"][model.key][0]["mode"] == "graph"
    assert len(out["predictions"]["predict"]) == 9
    assert SCORING.evict(model.key)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() <= before + (8 << 20)
