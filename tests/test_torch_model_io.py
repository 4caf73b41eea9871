"""Binary model save and load of the port (``h2o3_tpu_torch/persist/
model_io.py``) after ``tests/test_persist.py``'s model cases: a round trip
per family (binomial and multinomial GBM, DRF, XGBoost, GLM, DeepLearning,
KMeans, IsotonicRegression, NaiveBayes, PCA), trained by the port on
numpy-seeded frames of 256 rows, scores bit for bit (``torch.equal``)
and is back in the port's DKV under its key; the file's size is each
model's ``artifact_file_bytes``; the live model keeps its tensors.

A binary model of the JAX package (its own ``save_model`` of a model read
from a MOJO) is refused by name, pointing to the MOJO route. The
card-only cases are in ``tests/test_torch_persist_card.py``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from h2o3_tpu_torch import load_model, save_model, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.persist.model_io import TensorArray, host_copy
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 256


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


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
            "ym": ym, "yr": (2 * X[:, 0] - X[:, 1]).astype(np.float32)}


#: family: (module, class, params, y, x)
FAMILIES = {
    "gbm": ("gbm", "GBM", dict(ntrees=4, max_depth=3, seed=1), "yb", None),
    "gbm_multinomial": ("gbm", "GBM", dict(ntrees=3, max_depth=3, seed=1),
                        "ym", None),
    "drf": ("gbm", "DRF", dict(ntrees=4, max_depth=4, seed=1), "yr", None),
    "xgboost": ("xgboost", "XGBoost", dict(ntrees=3, max_depth=3, seed=1),
                "yb", None),
    "glm": ("glm", "GLM", dict(family="binomial", lambda_=1e-3), "yb",
            None),
    "deeplearning": ("deeplearning", "DeepLearning",
                     dict(hidden=[6], epochs=2, seed=1), "ym", None),
    "kmeans": ("kmeans", "KMeans", dict(k=3, seed=1), None, ["a", "b"]),
    "isotonic": ("isotonic", "IsotonicRegression", dict(), "yr", ["a"]),
    "naive_bayes": ("naive_bayes", "NaiveBayes", dict(), "yb",
                    ["a", "b", "g"]),
    "pca": ("decomposition", "PCA", dict(k=2), None, ["a", "b", "c"]),
}


def _fit(fam, frame):
    import importlib
    mod, cls, params, y, x = FAMILIES[fam]
    b = getattr(importlib.import_module(f"h2o3_tpu_torch.models.{mod}"),
                cls)(**params)
    return b.train(x=x if x is not None else
                   [c for c in ("a", "b", "c", "g")], y=y,
                   training_frame=frame)


def _scores(model, frame) -> list:
    pred = model.predict(frame)
    return [(n, v.data) for n, v in zip(pred.names, pred.vecs)]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_save_load_round_trip_is_bit_for_bit(fam, tmp_path):
    fr = Frame.from_arrays(cols())
    m = _fit(fam, fr)
    path = save_model(m, str(tmp_path / f"{fam}.bin"))
    assert m.artifact_file_bytes == os.path.getsize(path)
    DKV.clear()
    back = load_model(path, device="cpu")
    assert DKV.get(m.key) is back and back.key == m.key
    assert type(back) is type(m)
    assert back.artifact_file_bytes == m.artifact_file_bytes
    assert back.params == m.params
    for (na, va), (nb, vb) in zip(_scores(back, fr), _scores(m, fr)):
        assert na == nb and torch.equal(va, vb), na
    assert torch.equal(back._score_raw(fr), m._score_raw(fr))
    if m.training_metrics is not None:
        assert back.training_metrics.mse == m.training_metrics.mse


def test_host_copy_leaves_the_live_model_alone():
    fr = Frame.from_arrays(cols())
    m = _fit("deeplearning", fr)
    h = host_copy(m)
    assert isinstance(m.output["net"].W[0], torch.nn.Parameter)
    assert isinstance(h.output["net"].W[0], TensorArray)
    assert h.output["net"].W[0].parameter
    assert not isinstance(h.data_info.num_means, TensorArray)
    again = pickle.loads(pickle.dumps(h.output["net"].W[0]))
    assert isinstance(again, TensorArray) and again.parameter
    np.testing.assert_array_equal(again, m.output["net"].W[0].detach())


def test_the_model_method_saves(tmp_path):
    fr = Frame.from_arrays(cols())
    m = _fit("gbm", fr)
    back = load_model(m.save(str(tmp_path / "m.bin")), device="cpu")
    assert torch.equal(back._score_raw(fr), m._score_raw(fr))


def test_a_binary_model_of_the_jax_package_is_refused_by_name(tmp_path):
    from h2o3_tpu.genmodel.mojo import MojoModel as JMojo
    from h2o3_tpu.persist.model_io import save_model as jsave
    m = _fit("glm", Frame.from_arrays(cols()))
    jm = JMojo.load(m.download_mojo(str(tmp_path / "m.mojo")))._inner
    path = jsave(jm, str(tmp_path / "jax.bin"))
    with pytest.raises(ValueError, match="JAX package.*MOJO"):
        load_model(path, device="cpu")
    other = tmp_path / "other.bin"
    other.write_bytes(b"not a model\n")
    with pytest.raises(ValueError, match="not a saved model"):
        load_model(str(other), device="cpu")
