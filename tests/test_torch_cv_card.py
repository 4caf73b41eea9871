"""Card-only cases of cross-validation and the TargetEncoder in the port
(``-m cuda``; they skip where there is no card). This file imports no JAX:
the card's results are held against the port itself and its CPU path.

- The CV GBM's main model is bit for bit a GBM trained without CV: every
  level of these trees runs the fixed-point histogram kernel, whose sums
  are exact, and the final level's totals too.
- With unit weights and a 0/1 response the TargetEncoder's per-level sums
  are integers below 2^24, so the card's float32 atomics give the same
  encodings run after run, and the CPU's at rtol 1e-6 (the blend's
  ``exp`` may differ by an ulp between the CPU and the card).
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import model_base
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.target_encoder import TargetEncoder


@pytest.fixture
def cuda_device():
    """The card; skips without one (the histogram kernels have no CPU
    mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def gbm_cols(n, seed=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    g = rng.choice(np.array(["a", "b", "c"]), n)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.7 * (g == "b")
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols.update(g=g, y=y)
    return cols


def te_cols(n, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.choice(["a", "b", "c", "d"], size=n, p=[0.4, 0.3, 0.2, 0.1])
    p = np.array([{"a": 0.8, "b": 0.5, "c": 0.3, "d": 0.1}[c] for c in g])
    g = g.astype(object)
    g[rng.random(n) < 0.05] = None
    return {"g": g, "h": rng.choice(["p", "q", "r"], size=n).astype(object),
            "y": np.where(rng.uniform(size=n) < p, "yes", "no")}


@pytest.mark.cuda
def test_cv_main_model_is_bit_for_bit_the_plain_model_on_card(cuda_device):
    fr = Frame.from_arrays(gbm_cols(8192), device=cuda_device)
    kw = dict(ntrees=4, max_depth=4, nbins=64, learn_rate=0.2, seed=5)
    plain = GBM(**kw).train(y="y", training_frame=fr)
    cv = GBM(nfolds=5, keep_cross_validation_predictions=True,
             **kw).train(y="y", training_frame=fr)
    for a, b in zip(plain.output["trees"], cv.output["trees"]):
        for f in ("feat", "thresh_bin", "leaf", "is_split", "na_left"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert cv.training_metrics.auc == plain.training_metrics.auc
    mm = model_base.compute_metrics(
        cv.cv_holdout_predictions,
        model_base.response_as_float(fr.vec("y"))[0], cv.cv_holdout_mask, 2)
    assert mm.auc == cv.cross_validation_metrics.auc


@pytest.mark.cuda
def test_unit_weight_encodings_repeat_bit_for_bit_on_card(cuda_device):
    cols = te_cols(200_000)
    params = dict(data_leakage_handling="KFold", nfolds=5, blending=True,
                  inflection_point=3, smoothing=10)

    def run(dev):
        fr = Frame.from_arrays(cols, device=dev)
        m = TargetEncoder(**params).train(x=["g", "h"], y="y",
                                          training_frame=fr)
        out = m.transform(fr, as_training=True)
        return torch.stack([out.vec("g_te").data, out.vec("h_te").data])

    a, b = run(cuda_device), run(cuda_device)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), run("cpu").numpy(),
                               rtol=1e-6)
