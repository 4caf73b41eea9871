"""Real H2O-3 MOJO zips in the port (``h2o3_tpu_torch/genmodel/mojo_ref.py``
and ``mojo_ref2.py``) against the JAX package's readers
(``h2o3_tpu/genmodel/mojo_ref.py``, ``mojo_ref2.py``).

- The seven zips of ``tests/data/ref_mojo/`` (GBM, GLM, KMeans, binomial
  and multinomial StackedEnsembles, two XGBoosts) score ``prostate.csv``
  exactly as the JAX package's reader scores it (float64,
  ``np.array_equal``: the same numpy walk), and the GBM to the metrics the
  zip itself stores (``tests/test_mojo_ref.py``'s provenance, at 1e-8).
- ``import_mojo`` of the GBM zip predicts through a frame of the port,
  on the frame's device, with the stored logloss at float32's 1e-5.
- Every synthesized long-tail zip of ``tests/test_mojo_ref2.py``
  (DeepLearning, PCA, GLRM, CoxPH, Word2Vec, Isotonic, RuleFit, XGBoost,
  extended isolation forest), built by the same writer code: its test
  classes run here against the port's reader, each model's every method
  call also made on the JAX package's model and required to return the
  same value exactly (``_Both``). The TargetEncoder's transform runs on
  both packages' frames and its columns equal exactly.
"""

import csv
import json
import zipfile

import numpy as np
import pytest
import torch

import test_mojo_ref2 as ref2
from h2o3_tpu.genmodel import mojo_ref as jref
from h2o3_tpu.genmodel import mojo_ref2 as jref2
from h2o3_tpu_torch import import_mojo, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.genmodel import mojo_ref as pref
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

DATA = "tests/data/ref_mojo"
ZIPS = ["gbm_variable_importance", "glm_model", "kmeans_model",
        "ensemble_binomial", "ensemble_multinomial", "xgboost_prostate_age",
        "xgboost_multinomial"]
GBM_TRAIN_LOGLOSS = 0.2675723908575812
GBM_TRAIN_MSE = 0.07338612397264782


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


def prostate() -> list[dict]:
    with open(f"{DATA}/prostate.csv") as f:
        return list(csv.DictReader(f))


def design(m) -> np.ndarray:
    """prostate.csv's rows in the model's feature order, categoricals coded
    through the model's own domains (an unseen level past the domain)."""
    rows = prostate()
    X = np.zeros((len(rows), m.n_features))
    for j, c in enumerate(m.columns[: m.n_features]):
        dom = m.domains[j]
        for i, r in enumerate(rows):
            v = r.get(c, "")
            X[i, j] = (dom.index(v) if dom and v in dom else len(dom)
                       if dom else float(v) if v != "" else np.nan)
    return X


@pytest.mark.parametrize("name", ZIPS)
def test_real_mojo_scores_as_the_references_reader(name):
    path = f"{DATA}/{name}.zip"
    assert pref.is_reference_mojo(path) and jref.is_reference_mojo(path)
    pm, jm = pref.load_ref_mojo(path), jref.load_ref_mojo(path)
    assert type(pm).__name__ == type(jm).__name__ and pm.algo == jm.algo
    X = design(pm)
    got, want = pm.score(X), jm.score(X)
    assert got.dtype == np.float64 and np.array_equal(got, want,
                                                      equal_nan=True)
    assert np.isfinite(got).all()


def test_the_gbm_zip_scores_to_its_stored_metrics():
    m = pref.load_ref_mojo(f"{DATA}/gbm_variable_importance.zip")
    with zipfile.ZipFile(f"{DATA}/gbm_variable_importance.zip") as z:
        tm = json.loads(z.read("experimental/modelDetails.json"))[
            "output"]["training_metrics"]
    assert (tm["logloss"], tm["MSE"]) == (GBM_TRAIN_LOGLOSS, GBM_TRAIN_MSE)
    y = np.array([int(r["CAPSULE"]) for r in prostate()])
    p = m.score(design(m))
    p1 = np.clip(p[:, 1], 1e-15, 1 - 1e-15)
    logloss = float(-np.mean(y * np.log(p1) + (1 - y) * np.log(1 - p1)))
    assert logloss == pytest.approx(GBM_TRAIN_LOGLOSS, abs=1e-8)
    assert float(np.mean((y - p[:, 1]) ** 2)) == pytest.approx(
        GBM_TRAIN_MSE, abs=1e-8)


def test_import_mojo_of_a_real_zip_predicts_on_the_frames_device():
    rows = prostate()
    feats = ["AGE", "RACE", "DPROS", "DCAPS", "PSA", "VOL", "GLEASON"]
    cols = {c: np.array([float(r[c]) for r in rows], np.float32)
            for c in feats}
    y = np.array([int(r["CAPSULE"]) for r in rows])
    cols["CAPSULE"] = y.astype(np.float32)
    fr = Frame.from_arrays(cols)
    model = import_mojo(f"{DATA}/gbm_variable_importance.zip",
                        model_id="ref_gbm", device="cpu")
    assert DKV.get("ref_gbm") is model
    assert model.response_domain == ("0", "1")
    raw = model._score_raw(fr)
    assert isinstance(raw, torch.Tensor) and raw.device == fr.device
    pred = model.predict(fr)
    assert pred.names == ["predict", "p0", "p1"]
    pc = np.clip(pred.vec("p1").to_numpy().astype(np.float64), 1e-15,
                 1 - 1e-15)
    ll = float(-np.mean(y * np.log(pc) + (1 - y) * np.log(1 - pc)))
    assert ll == pytest.approx(GBM_TRAIN_LOGLOSS, abs=1e-5)
    assert float(model.model_performance(fr).logloss) == pytest.approx(
        GBM_TRAIN_LOGLOSS, abs=1e-5)


# -- the long-tail families of tests/test_mojo_ref2.py -------------------------


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


class _Both:
    """The port's model, whose every method call is also made on the JAX
    package's model: both raise alike, or return the same value."""

    def __init__(self, port, ref):
        self.__dict__.update(_port=port, _ref=ref)

    def __getattr__(self, name):
        got = getattr(self._port, name)
        if not callable(got) or isinstance(got, type):
            return got

        def both(*a, **k):
            try:
                want = getattr(self._ref, name)(*a, **k)
            except Exception as e:          # noqa: BLE001 — compared below
                with pytest.raises(type(e)):
                    got(*a, **k)
                raise
            out = got(*a, **k)
            assert _same(out, want), name
            return out
        return both

    def __setattr__(self, name, value):
        setattr(self._port, name, value)
        setattr(self._ref, name, value)


def _load_both(zip_bytes):
    try:
        ref = jref.load_ref_mojo(zip_bytes)
    except Exception as e:                  # noqa: BLE001 — compared below
        with pytest.raises(type(e)):
            pref.load_ref_mojo(zip_bytes)
        raise
    return _Both(pref.load_ref_mojo(zip_bytes), ref)


@pytest.fixture(autouse=True)
def _port_reader(monkeypatch):
    """tests/test_mojo_ref2.py's classes below read their zips through
    both packages' readers."""
    monkeypatch.setattr(ref2, "load_ref_mojo", _load_both)


TestDeepLearningMojo = ref2.TestDeepLearningMojo
TestPCAMojo = ref2.TestPCAMojo
TestGlrmMojo = ref2.TestGlrmMojo
TestCoxPHMojo = ref2.TestCoxPHMojo
TestWord2VecMojo = ref2.TestWord2VecMojo
TestIsotonicMojo = ref2.TestIsotonicMojo
TestRuleFitMojo = ref2.TestRuleFitMojo
TestXGBoostMojo = ref2.TestXGBoostMojo
TestExtendedIsoForMojo = ref2.TestExtendedIsoForMojo
TestMultinomialRuleFit = ref2.TestMultinomialRuleFit
TestDeepLearningMaxout = ref2.TestDeepLearningMaxout


def test_the_long_tail_dispatch_names_the_same_families():
    from h2o3_tpu_torch.genmodel import mojo_ref2 as pref2
    assert pref2.EXT_ALGOS == jref2.EXT_ALGOS


@pytest.mark.parametrize("kw", [dict(), dict(blending=True),
                                dict(has_na=False), dict(nclasses=3)])
def test_target_encoder_transforms_as_the_reference(kw):
    from h2o3_tpu.frame.frame import Frame as JFrame
    fixture = ref2.TestTargetEncoderMojo()._fixture
    both = fixture(**kw)
    city = np.array(["nyc", "sf", None, "la", "sf"], object)
    got = both._port.transform(Frame.from_arrays({"city": city}))
    want = both._ref.transform(JFrame.from_arrays({"city": city}))
    assert got.names == want.names
    for c in got.names:
        g, w = got.vec(c), want.vec(c)
        if g.is_categorical:
            assert list(g.labels()) == list(w.labels()[:5])
        else:
            assert np.array_equal(g.to_numpy(), w.to_numpy()[:5],
                                  equal_nan=True), c


def test_generic_predicts_a_synthesized_deeplearning_zip():
    both, _ = ref2.TestDeepLearningMojo()._fixture(
        activation="Rectifier", family="bernoulli", n_classes=2)
    fr = Frame.from_arrays({
        "cat": np.array(["a", "b", "c"], object),
        "x1": np.array([0.1, -0.5, 2.0], np.float32),
        "x2": np.array([1.0, 0.0, -1.0], np.float32)})
    pred = both._port.predict(fr)
    assert pred.names[0] == "predict"
    p = pred.vec("p1").to_numpy()
    assert ((p >= 0) & (p <= 1)).all()
    want = both._ref.score(both._port._design(fr))[:, 1].astype(np.float32)
    assert np.array_equal(p, want)
    raw = both._port._score_raw(fr)
    assert raw.shape == (3, 2) and raw.device == fr.device
