"""Card-only cases of the port's persistence (``-m cuda``; they skip where
there is no card). This file imports no JAX. A model trained and saved on
the card (binomial and multinomial GBM, GLM, DeepLearning) loads onto the
card bit for bit (``load_model(device="cuda")``) and through a MOJO bit
for bit (``MojoModel.load(device="cuda")``); a model saved on the card
loads on the CPU, with its tensors there, and scores within rtol 1e-6
and atol 2.4e-7 (two float32 ulps at 1.0: a class probability computed as
1 − p carries the rounding of p's scale) of the card: the same float32
arithmetic, which the two devices' libraries may round apart by an ulp
(measured on an H100: one GLM probability of 8,192 off by 1.19e-7).
With the card present and the default device unset, a GBM trained on a
CPU frame with ``auto_recovery_dir`` and a grid with ``recovery_dir``
resume onto the CPU, tree for tree equal to an uninterrupted fit.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch import load_model, save_model
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.genmodel.mojo import MojoModel
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.persist import recovery as prec
from h2o3_tpu_torch.utils.registry import DKV

N = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


def cols(seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    X[::17, 2] = np.nan
    g = rng.choice(np.array(["u", "v", "w"]), N)
    logit = 1.2 * X[:, 0] - X[:, 1] + 0.5 * (g == "v")
    yb = np.where(rng.random(N) < 1 / (1 + np.exp(-logit)), "yes", "no")
    ym = np.array(["k0", "k1", "k2"])[np.digitize(X[:, 0], [-0.4, 0.4])]
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "g": g, "yb": yb,
            "ym": ym}


def fit(fam: str, frame):
    from h2o3_tpu_torch.models.deeplearning import DeepLearning
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.glm import GLM
    builder, y = {
        "gbm": (GBM(ntrees=5, max_depth=4, seed=1), "yb"),
        "gbm_multinomial": (GBM(ntrees=4, max_depth=4, seed=1), "ym"),
        "glm": (GLM(family="binomial", lambda_=1e-3), "yb"),
        "deeplearning": (DeepLearning(hidden=[8], epochs=2, seed=1), "ym"),
    }[fam]
    return builder.train(y=y, training_frame=frame)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["gbm", "gbm_multinomial", "glm",
                                 "deeplearning"])
def test_a_card_model_round_trips_on_the_card(cuda_device, fam, tmp_path):
    fr = Frame.from_arrays(cols(), device=cuda_device)
    m = fit(fam, fr)
    want = m._score_raw(fr)
    back = load_model(save_model(m, str(tmp_path / "m.bin")),
                      device=cuda_device)
    got = back._score_raw(fr)
    assert got.is_cuda and torch.equal(got, want)
    mojo = MojoModel.load(m.download_mojo(str(tmp_path / "m.mojo")),
                          device=cuda_device)
    assert torch.equal(mojo._score_raw(fr), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["gbm", "glm"])
def test_a_card_model_loads_on_the_cpu(cuda_device, fam, tmp_path):
    m = fit(fam, Frame.from_arrays(cols(), device=cuda_device))
    back = load_model(save_model(m, str(tmp_path / "m.bin")), device="cpu")
    assert all(not v.is_cuda for v in back.output.values()
               if isinstance(v, torch.Tensor))
    got = back._score_raw(Frame.from_arrays(cols(), device="cpu"))
    want = m._score_raw(Frame.from_arrays(cols(), device=cuda_device))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want.cpu().numpy(), rtol=1e-6,
                               atol=2 * np.finfo(np.float32).eps)


class Crash(Exception):
    """The process dying right after a snapshot landed."""


def _trees(model) -> list:
    return list(model.output["trees"])


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["build", "grid"])
def test_a_cpu_frame_resumes_on_the_cpu_beside_a_card(cuda_device, what,
                                                      tmp_path, monkeypatch):
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.orchestration import GridSearch
    monkeypatch.setenv("H2O3TPU_CHECKPOINT_EVERY", "2")
    fr = Frame.from_arrays(cols(), device="cpu")
    rdir = str(tmp_path / "rec")
    params = dict(ntrees=6, max_depth=3, seed=1)

    def grid(d, **criteria):
        return GridSearch(GBM, {"max_depth": [2, 3]}, grid_id="g1",
                          recovery_dir=d, search_criteria=criteria or None,
                          ntrees=3, seed=1).train(y="yb", training_frame=fr)

    if what == "build":
        real = prec.BuildRecovery.snapshot

        def snapshot(self, model, progress, target):
            real(self, model, progress, target)
            raise Crash(progress)

        with monkeypatch.context() as m:
            m.setattr(prec.BuildRecovery, "snapshot", snapshot)
            with pytest.raises(Crash):
                GBM(auto_recovery_dir=rdir, **params).train(
                    y="yb", training_frame=fr)
        DKV.clear()
        got = [GBM(auto_recovery_dir=rdir, **params).train(
            y="yb", training_frame=fr)]
        want = [GBM(**params).train(y="yb", training_frame=fr)]
    else:
        grid(rdir, max_models=1)
        DKV.clear()
        got = grid(rdir).models
        want = grid(str(tmp_path / "whole")).models
    assert len(got) == len(want)
    for g, w in zip(sorted(got, key=lambda m: m.key),
                    sorted(want, key=lambda m: m.key)):
        assert len(_trees(g)) == len(_trees(w))
        for tg, tw in zip(_trees(g), _trees(w)):
            for f in HEAP_FIELDS:
                assert getattr(tg, f).device.type == "cpu"
                assert torch.equal(getattr(tg, f), getattr(tw, f))
