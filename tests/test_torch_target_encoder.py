"""TargetEncoder in the port (``h2o3_tpu_torch/models/target_encoder.py``)
against the JAX package's (``h2o3_tpu/models/target_encoder.py``) on the
same numpy-seeded frames: the four cases of tests/test_algos2.py, blending
at H2O's documented example settings, KFold with a fold column, a level
missing in training, weights, a numeric target, noise, and
``convert.target_encoder_model``.

Tolerances: the level tables, the prior and every encoding at rtol 1e-6
(with unit weights and a 0/1 response the sums and counts are integers,
so both packages divide the same float32 numbers; the blend's ``exp`` may
differ by an ulp between XLA and torch), and at rtol 1e-5 with
fractional weights (float32 sums in another order). Noise comes from
``jax.random`` in the reference and a ``torch.Generator`` here: it is
held to its bound, |noisy - clean| <= noise, and to its seed.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.target_encoder import TargetEncoder as JTE
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.target_encoder import TargetEncoder
from jax_reference import _jax_compile_cache  # noqa: F401

BASE = {"a": 0.8, "b": 0.5, "c": 0.3, "d": 0.1}


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def te_cols(n=2000, seed=0, na=False):
    """tests/test_algos2.py's te_frame: level g sets P(yes) by BASE."""
    rng = np.random.default_rng(seed)
    g = rng.choice(["a", "b", "c", "d"], size=n, p=[0.4, 0.3, 0.2, 0.1])
    y = rng.uniform(size=n) < np.array([BASE[c] for c in g])
    g = g.astype(object)
    if na:
        g[rng.random(n) < 0.05] = None
    return {"g": g, "h": rng.choice(["p", "q", "r"], size=n).astype(object),
            "x": rng.normal(size=n),
            "y": np.array(["yes" if t else "no" for t in y], dtype=object),
            "yn": (np.array([BASE[c] if c else 0.5 for c in g])
                   + rng.normal(scale=0.1, size=n)).astype(np.float32),
            "w": rng.uniform(0.25, 2.0, n).astype(np.float32),
            "fold": rng.integers(0, 4, n).astype(np.float32)}


def fit_both(cols, x=("g",), y="y", **params):
    jm = JTE(**params).train(x=list(x), y=y,
                             training_frame=JFrame.from_arrays(cols))
    pm = TargetEncoder(**params).train(x=list(x), y=y,
                                       training_frame=Frame.from_arrays(cols))
    return jm, pm


def encodings(model, cols, make, as_training=False):
    fr = make(cols)
    out = model.transform(fr, as_training=as_training)
    return {c: np.asarray(out.vec(f"{c}_te").to_numpy())[: fr.nrows]
            for c in model.output["columns"]}


def assert_same(jm, pm, cols, rtol=1e-6, as_training=(False, True)):
    assert pm.output["columns"] == jm.output["columns"]
    np.testing.assert_allclose(pm.output["prior"], jm.output["prior"],
                               rtol=rtol)
    for c in jm.output["columns"]:
        assert pm.output["domains"][c] == tuple(jm.output["domains"][c])
        np.testing.assert_allclose(pm.output["lut"][c].numpy(),
                                   jm.output["lut"][c], rtol=rtol)
    for t in as_training:
        pe = encodings(pm, cols, Frame.from_arrays, t)
        je = encodings(jm, cols, JFrame.from_arrays, t)
        for c in je:
            np.testing.assert_allclose(pe[c], je[c], rtol=rtol,
                                       err_msg=f"{c} as_training={t}")


def test_target_encoder_means():
    cols = te_cols()
    jm, pm = fit_both(cols, x=("g", "x"), columns=["g"])
    assert_same(jm, pm, cols)
    enc = encodings(pm, cols, Frame.from_arrays)["g"]
    labels = Frame.from_arrays(cols).vec("g").labels()
    for lev, expected in BASE.items():
        assert abs(enc[labels == lev].mean() - expected) < 0.06


def test_target_encoder_blending():
    cols = te_cols()
    jm, pm = fit_both(cols, columns=["g"], blending=True,
                      inflection_point=1e6)
    assert_same(jm, pm, cols)
    enc = encodings(pm, cols, Frame.from_arrays)["g"]
    assert np.allclose(enc, pm.output["prior"], atol=1e-3)


@pytest.mark.parametrize("leak", ["KFold", "LeaveOneOut"])
def test_target_encoder_kfold_loo(leak):
    cols = te_cols()
    jm, pm = fit_both(cols, columns=["g"], data_leakage_handling=leak,
                      nfolds=3)
    assert_same(jm, pm, cols)
    a = encodings(pm, cols, Frame.from_arrays, True)["g"]
    b = encodings(pm, cols, Frame.from_arrays, False)["g"]
    assert not np.allclose(a, b)
    assert abs(a.mean() - b.mean()) < 0.05


def test_target_encoder_unseen_level():
    cols = te_cols()
    jm, pm = fit_both(cols, columns=["g"])
    new = {"g": np.array(["a", "zzz", None], dtype=object)}
    pe = encodings(pm, new, Frame.from_arrays)["g"]
    np.testing.assert_allclose(pe, encodings(jm, new, JFrame.from_arrays)["g"],
                               rtol=1e-6)
    assert pe[1] == pytest.approx(pm.output["prior"], abs=1e-5)


def test_documented_example_settings_with_missing_levels():
    """H2O's Target Encoding docs' example: KFold, blending, inflection
    point 3, smoothing 10, on two columns, one with missing levels."""
    cols = te_cols(na=True)
    jm, pm = fit_both(cols, x=("g", "h"), data_leakage_handling="KFold",
                      blending=True, inflection_point=3, smoothing=10,
                      nfolds=5)
    assert_same(jm, pm, cols)
    assert pm.output["lut"]["g"].shape[0] == 5      # four levels + NA slot


def test_kfold_by_a_fold_column():
    cols = te_cols()
    jm, pm = fit_both(cols, columns=["g"], data_leakage_handling="KFold",
                      fold_column="fold")
    assert_same(jm, pm, cols)


def test_fractional_weights_and_a_numeric_target():
    cols = te_cols(n=2048)
    jm, pm = fit_both(cols, x=("g", "h"), y="yn", weights_column="w",
                      data_leakage_handling="LeaveOneOut", blending=True)
    assert_same(jm, pm, cols, rtol=1e-5)


def test_noise_is_bounded_and_seeded():
    cols = te_cols()
    fr = Frame.from_arrays(cols)
    kw = dict(columns=["g"], data_leakage_handling="KFold", nfolds=5)

    def train_enc(**over):
        m = TargetEncoder(**kw, **over).train(x=["g"], y="y",
                                              training_frame=fr)
        return m.transform(fr, as_training=True).vec("g_te").data

    clean = train_enc()
    noisy = train_enc(noise=0.15, seed=3)
    # the draw is in [-0.15, 0.15); adding it to values below 2 rounds by
    # at most 2^-23
    d = (noisy.double() - clean.double()).abs()
    assert float(d.max()) <= 0.15 + 2 ** -23 and float(d.max()) > 0.1
    assert torch.equal(noisy, train_enc(noise=0.15, seed=3))
    assert not torch.equal(noisy, train_enc(noise=0.15, seed=4))
    # the full-statistics transform carries no noise
    m = TargetEncoder(**kw, noise=0.15).train(x=["g"], y="y",
                                              training_frame=fr)
    assert torch.equal(m.transform(fr).vec("g_te").data,
                       TargetEncoder(**kw).train(x=["g"], y="y",
                                                 training_frame=fr)
                       .transform(fr).vec("g_te").data)


def test_convert_scores_a_reference_encoder():
    cols = te_cols(na=True)
    jm = JTE(columns=["g", "h"], blending=True, inflection_point=3,
             smoothing=10).train(x=["g", "h"], y="y",
                                 training_frame=JFrame.from_arrays(cols))
    out = {k: jm.output[k] for k in ("lut", "domains", "prior", "columns",
                                     "data_leakage_handling")}
    cm = convert.target_encoder_model(out, response_column="y")
    assert cm.is_applied(cm.transform(Frame.from_arrays(cols)))
    new = {"g": np.array(["d", "zzz", None, "a"], dtype=object),
           "h": np.array(["r", "p", "q", None], dtype=object)}
    pe = encodings(cm, new, Frame.from_arrays)
    je = encodings(jm, new, JFrame.from_arrays)
    for c in je:
        np.testing.assert_array_equal(pe[c], je[c])


@pytest.mark.parametrize("params,y,match", [
    (dict(), "h", "binary or numeric"),
    (dict(data_leakage_handling="k_fold"), "y", "KFold"),
])
def test_refusals(params, y, match):
    fr = Frame.from_arrays(te_cols(n=256))
    with pytest.raises(ValueError, match=match):
        TargetEncoder(**params).train(x=["g"], y=y, training_frame=fr)


def test_no_categorical_column_raises():
    fr = Frame.from_arrays(te_cols(n=256))
    with pytest.raises(ValueError, match="no categorical"):
        TargetEncoder().train(x=["x"], y="y", training_frame=fr)


def test_nfolds_sets_the_folds_and_runs_no_cross_validation():
    fr = Frame.from_arrays(te_cols(n=256))
    m = TargetEncoder(data_leakage_handling="KFold", nfolds=4).train(
        x=["g"], y="y", training_frame=fr)
    assert m.cross_validation_metrics is None
    assert m.training_metrics is None
