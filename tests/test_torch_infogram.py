"""Infogram in the port (h2o3_tpu_torch/models/infogram.py) against the JAX
reference (``h2o3_tpu/models/infogram.py``) on the same numpy-seeded
frames: five features of decreasing information about a binary response
and a protected categorical column.

The GBM surrogates run without sampling, so both packages grow the same
trees (leaves apart in the last bits). Tolerances: ``_mean_cmi`` of one
model at rtol 1e-5; the relevance (scaled variable importance) at rtol
1e-5; the raw CMI, a difference of two mean log2-probabilities near
-0.6, at an absolute 1e-5 (a few float32 ulps of each mean), and the
scaled CMI at 1e-4; the admissible features and the predictor order
exactly. ``fairness_metrics`` on the same model at rtol 1e-6 (host
float64 arithmetic on probabilities 1e-7 apart).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import infogram as jig
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import infogram as pig
from h2o3_tpu_torch.models.tree import HEAP_FIELDS

N = 640
X = [f"x{i}" for i in range(5)]
SMALL = dict(ntrees=4, max_depth=3)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def ig_cols(n=N, seed=0):
    rng = np.random.default_rng(seed)
    Xm = rng.normal(size=(n, 5)).astype(np.float32)
    g = rng.choice(np.array(["A", "B", "C"]), n, p=[0.5, 0.3, 0.2])
    eta = 2.0 * Xm[:, 0] - 1.2 * Xm[:, 1] + 0.5 * Xm[:, 2] + 0.6 * (g == "A")
    cols = {f"x{i}": Xm[:, i] for i in range(5)}
    cols["g"] = g.astype(object)
    cols["g"][rng.random(n) < 0.03] = None
    cols["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "1", "0")
    return cols


def gbm_spec(m) -> dict:
    """A reference GBM as convert's inner-model mapping (group splits
    carry their left masks)."""
    out = dict(m.output, trees=[{k: np.asarray(getattr(t, k))
                                 for k in HEAP_FIELDS + ("left_mask",)
                                 if getattr(t, k, None) is not None}
                                for t in m.output["trees"]])
    return dict(output=out, response_column=m.response_column,
                response_domain=m.response_domain, params=dict(m.params))


@pytest.fixture(scope="module")
def frames():
    cols = ig_cols()
    return cols, JFrame.from_arrays(cols), Frame.from_arrays(cols)


@pytest.fixture(scope="module")
def ref_gbm(fits):
    """The core case's reference surrogate and the port's conversion of
    it."""
    jm = fits["core"][0].output["relevance_model"]
    pm = convert.gbm_model(gbm_spec(jm)["output"], "y", jm.response_domain,
                           device="cpu")
    return jm, pm


def test_mean_cmi_matches_reference(frames, ref_gbm):
    _, jf, pf = frames
    jm, pm = ref_gbm
    np.testing.assert_allclose(pig._mean_cmi(pm, pf, "y"),
                               jig._mean_cmi(jm, jf, "y"), rtol=1e-5)


def _tables_match(pm, jm):
    po, jo = pm.output, jm.output
    assert po["all_predictor_names"] == jo["all_predictor_names"]
    np.testing.assert_allclose(po["relevance"], jo["relevance"], rtol=1e-5)
    np.testing.assert_allclose(po["cmi_raw"], jo["cmi_raw"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(po["cmi"], jo["cmi"], rtol=1e-4, atol=1e-4)
    assert pm.get_admissible_features() == jm.get_admissible_features()
    assert [r["column"] for r in pm.infogram_data()] == \
        [r["column"] for r in jm.infogram_data()]


CASES = {
    "core": (X[:4], dict(algorithm_params=SMALL)),
    "fair": (X[:3] + ["g"], dict(algorithm_params=SMALL,
                                 protected_columns=["g"])),
    "glm": (X[:4], dict(algorithm="glm", top_n_features=3)),
}


@pytest.fixture(scope="module")
def fits(frames):
    """(reference fit, port fit) per case, fitted once in the module."""
    _, jf, pf = frames
    return {case: (jig.Infogram(**kw).train(x=x, y="y", training_frame=jf),
                   pig.Infogram(**kw).train(x=x, y="y", training_frame=pf))
            for case, (x, kw) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_tables_match_reference(frames, fits, case):
    _, jf, pf = frames
    jm, pm = fits[case]
    assert pm.output["build_core"] == jm.output["build_core"]
    _tables_match(pm, jm)
    np.testing.assert_allclose(pm.predict(pf).vec("p1").to_numpy(),
                               jm.predict(jf).vec("p1").to_numpy()[:N],
                               rtol=1e-5, atol=1e-6)


def test_fairness_metrics_match_reference(frames, ref_gbm):
    _, jf, pf = frames
    jm, pm = ref_gbm
    for ref in (None, ["B"]):
        got = pig.fairness_metrics(pm, pf, ["g"], reference=ref)
        want = jig.fairness_metrics(jm, jf, ["g"], reference=ref)
        assert got.names == want.names
        assert [None if c < 0 else got.vec("g").domain[c]
                for c in got.vec("g").to_numpy()] == \
            list(want.vec("g").to_numpy())
        for c in got.names[1:]:
            np.testing.assert_allclose(got.vec(c).to_numpy(),
                                       want.vec(c).to_numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", ["core", "glm"])
def test_reference_model_scores_alike_through_convert(frames, fits, case):
    _, jf, pf = frames
    jm = fits[case][0]
    rel = jm.output["relevance_model"]
    if case == "glm":
        spec = dict(algo="glm", output={
            k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in rel.output.items()},
            data_info=dataclasses.asdict(rel.data_info), response_column="y",
            response_domain=rel.response_domain, params=dict(rel.params))
    else:
        spec = dict(gbm_spec(rel), algo="gbm")
    pm = convert.infogram_model(dict(jm.output), spec, "y",
                                jm.response_domain, dict(jm.params),
                                device="cpu")
    assert pm.get_admissible_features() == jm.get_admissible_features()
    np.testing.assert_allclose(pm.predict(pf).vec("p1").to_numpy(),
                               jm.predict(jf).vec("p1").to_numpy()[:N],
                               rtol=1e-5, atol=1e-6)


def test_refusals(frames):
    _, _, pf = frames
    with pytest.raises(ValueError, match="categorical response"):
        pig.Infogram().train(x=X[1:], y="x0", training_frame=pf)
    with pytest.raises(ValueError, match="unsupported infogram algorithm"):
        pig.Infogram(algorithm="xgboost").train(x=X, y="y",
                                                training_frame=pf)
    regression = types.SimpleNamespace(is_classifier=False,
                                       response_domain=None)
    with pytest.raises(ValueError, match="binomial"):
        pig.fairness_metrics(regression, pf, ["g"])
