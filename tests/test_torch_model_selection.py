"""ModelSelection and ANOVAGLM in the port
(h2o3_tpu_torch/models/model_selection.py) against the JAX reference
(``h2o3_tpu/models/model_selection.py``) on the same numpy-seeded frames.

The frames have clearly separated best subsets (y linear in three of six
predictors, each of the three at least twice the next one's effect), so
that no float32 tie between two subsets' R² can flip a pick. Every mode
is held to the reference's subsets exactly, their R² (or minus the
residual deviance) at rtol 1e-5, the best model's coefficients at rtol
1e-4; ANOVAGLM's table's degrees of freedom exactly, its deviances at
rtol 1e-4 with an absolute floor of 2e-6 x the full model's deviance
(a difference of two float32 deviances: a few ulps of each), the F values
at that floor carried through (x residual df / full deviance) and the
p-values at 1e-3 (scipy's F tail of those).
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import model_selection as jms
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import model_selection as pms

N = 640
X = [f"x{i}" for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def ms_cols(n=N, seed=0, binomial=False):
    """Six normal predictors; y = 3 x1 - 1.5 x4 + 0.7 x2 + noise (or a
    logistic draw of it)."""
    rng = np.random.default_rng(seed)
    Xm = rng.normal(size=(n, 6)).astype(np.float32)
    eta = 3.0 * Xm[:, 1] - 1.5 * Xm[:, 4] + 0.7 * Xm[:, 2]
    cols = {f"x{i}": Xm[:, i] for i in range(6)}
    if binomial:
        cols["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "yes",
                             "no")
    else:
        cols["y"] = (eta + rng.normal(scale=0.5, size=n)).astype(np.float32)
    return cols


def glm_spec(m) -> dict:
    """A reference GLM as convert's inner-model mapping."""
    return dict(output={k: (np.asarray(v) if hasattr(v, "shape") else v)
                        for k, v in m.output.items()},
                data_info=dataclasses.asdict(m.data_info),
                response_column=m.response_column,
                response_domain=m.response_domain, params=dict(m.params))


def _results_match(pm, jm):
    pr, jr = pm.result(), jm.result()
    assert [r["n_predictors"] for r in pr] == [r["n_predictors"] for r in jr]
    assert [r["predictors"] for r in pr] == [r["predictors"] for r in jr]
    np.testing.assert_allclose([r["r2"] for r in pr], [r["r2"] for r in jr],
                               rtol=1e-5)
    pc, jc = pm.coef(), jm.coef()
    assert list(pc) == list(jc)
    np.testing.assert_allclose(list(pc.values()), list(jc.values()),
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def frames():
    cols = ms_cols()
    return cols, JFrame.from_arrays(cols), Frame.from_arrays(cols)


@pytest.mark.parametrize("params", [
    dict(mode="maxr", max_predictor_number=3),
    dict(mode="allsubsets", max_predictor_number=2, min_predictor_number=2),
    dict(mode="forward", max_predictor_number=4),
    dict(mode="backward", min_predictor_number=2),
])
def test_selected_subsets_match_reference(frames, params):
    _, jf, pf = frames
    x = X[1:] if params["mode"] == "maxr" else X    # maxr: 25 subsets
    jm = jms.ModelSelection(**params).train(x=x, y="y", training_frame=jf)
    pm = pms.ModelSelection(**params).train(x=x, y="y", training_frame=pf)
    _results_match(pm, jm)
    assert sorted(pm.output["best_per_size"]) == \
        sorted(jm.output["best_per_size"])


def test_binomial_ranks_by_deviance_like_reference():
    cols = ms_cols(binomial=True, seed=3)
    kw = dict(mode="forward", max_predictor_number=2)
    jm = jms.ModelSelection(**kw).train(x=X, y="y",
                                        training_frame=JFrame.from_arrays(cols))
    pm = pms.ModelSelection(**kw).train(x=X, y="y",
                                        training_frame=Frame.from_arrays(cols))
    assert all(r["r2"] < 0 for r in pm.result())    # minus the deviance
    _results_match(pm, jm)


def test_anova_table_matches_reference(frames):
    _, jf, pf = frames
    jm = jms.ANOVAGLM().train(x=X[:4], y="y", training_frame=jf)
    pm = pms.ANOVAGLM().train(x=X[:4], y="y", training_frame=pf)
    pt, jt = pm.anova_table(), jm.anova_table()
    assert [(r["predictor"], r["df"]) for r in pt] == \
        [(r["predictor"], r["df"]) for r in jt]
    dev_full = float(jm.output["full_model"].output["residual_deviance"])
    df_resid = N - len(jm.output["full_model"].output["coef_names"]) - 1
    floor = 2e-6 * dev_full
    for key, atol in (("deviance", floor),
                      ("f_value", floor * df_resid / dev_full),
                      ("p_value", 1e-3)):
        np.testing.assert_allclose([r[key] for r in pt],
                                   [r[key] for r in jt], rtol=1e-4,
                                   atol=atol)


def test_reference_models_score_alike_through_convert(frames):
    cols, jf, pf = frames
    jm = jms.ModelSelection(max_predictor_number=2).train(
        x=X, y="y", training_frame=jf)
    pm = convert.model_selection_model(
        dict(jm.output), glm_spec(jm.output["best_model"]), "y", None,
        dict(jm.params), device="cpu")
    want = jm.predict(jf).vec("predict").to_numpy()[:N]
    np.testing.assert_allclose(pm.predict(pf).vec("predict").to_numpy(),
                               want, rtol=1e-5, atol=1e-5)
    assert pm.result() == jm.result()
    ja = jms.ANOVAGLM().train(x=X[:3], y="y", training_frame=jf)
    pa = convert.anova_glm_model(dict(ja.output),
                                 glm_spec(ja.output["full_model"]), "y",
                                 None, dict(ja.params), device="cpu")
    assert pa.anova_table() == ja.anova_table()
    np.testing.assert_allclose(pa.predict(pf).vec("predict").to_numpy(),
                               ja.predict(jf).vec("predict").to_numpy()[:N],
                               rtol=1e-5, atol=1e-5)


def test_refusals(frames):
    _, _, pf = frames
    with pytest.raises(ValueError, match="unknown mode"):
        pms.ModelSelection(mode="sideways").train(x=X, y="y",
                                                  training_frame=pf)
    with pytest.raises(ValueError, match="unknown parameters"):
        pms.ModelSelection(max_runtime_secs=3)
