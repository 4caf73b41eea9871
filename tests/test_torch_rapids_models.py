"""The model prims of the Rapids engine (``h2o3_tpu_torch/rapids/exec.py``:
``makeLeaderboard``, ``model.reset.threshold``, ``PermutationVarImp``,
``result``, ``transform``, ``fairnessMetrics``,
``segment_models_as_frame``, ``model.testJavaScoring``) against the JAX package's, on JAX-trained
models (a GBM with group splits, a GLM, ModelSelection, a TargetEncoder)
carried into the port with ``convert``; the same Rapids strings through
both engines. Probabilities and metrics within rtol 1e-5, fairness
metrics within 1e-4, permutation importances within 1e-3 (each a
difference of two metrics); labels, names and row orders exactly."""

import numpy as np
import pytest

from rapids_pair import _cpu_port, pair, same_value  # noqa: F401
from h2o3_tpu.rapids import exec as jx
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch.rapids import exec as px
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(scope="module")
def models():
    from h2o3_tpu.models.gbm import GBM as JGBM
    from h2o3_tpu.models.glm import GLM as JGLM
    from h2o3_tpu.models.model_selection import ModelSelection
    from h2o3_tpu.models.target_encoder import TargetEncoder
    from h2o3_tpu_torch import convert
    from test_torch_carry import carry
    from test_torch_model_selection import glm_spec
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS

    def carry_gbm(jm):
        """``carry`` with the trees' group-split masks (``sex``)."""
        out = dict(jm.output, trees=[
            {k: np.asarray(getattr(t, k))
             for k in HEAP_FIELDS + ("left_mask",)} for t in jm.output["trees"]])
        pm = convert.gbm_model(out, response_column=jm.response_column,
                               response_domain=jm.response_domain,
                               params=dict(jm.params))
        pm.key = jm.key
        return pm
    r = np.random.default_rng(5)
    n = 192
    X = r.normal(size=(n, 2)).astype(np.float32)
    sex = r.choice(["m", "f"], size=n, p=[0.6, 0.4]).astype(object)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.5 * (sex == "m")
    yv = np.where(r.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no"
                  ).astype(object)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "sex": sex, "y": yv}
    jf, pf = pair(cols)
    jg = JGBM(ntrees=5, max_depth=3, seed=1, model_id="rm_gbm").train(
        y="y", training_frame=jf)
    jl = JGLM(family="binomial", lambda_=1e-3, model_id="rm_glm").train(
        y="y", training_frame=jf)
    tcols = {"x0": X[:, 0], "x1": X[:, 1],
             "t": (X[:, 0] * 2 + r.normal(size=n) * 0.1).astype(np.float32)}
    jt, pt = pair(tcols)
    jms = ModelSelection(mode="maxr", max_predictor_number=2,
                         model_id="rm_ms").train(y="t", training_frame=jt)
    pms = convert.model_selection_model(
        dict(jms.output), glm_spec(jms.output["best_model"]), "t", None,
        dict(jms.params), device="cpu")
    pms.key = "rm_ms"
    jte = TargetEncoder(model_id="rm_te").train(x=["sex"], y="y",
                                                training_frame=jf)
    pte = convert.target_encoder_model(
        {k: jte.output[k] for k in ("lut", "domains", "prior", "columns",
                                    "data_leakage_handling")},
        response_column="y")
    pte.key = "rm_te"
    return dict(frames=(jf, pf), j=[jg, jl, jms, jte],
                p=[carry_gbm(jg), carry(jl, n), pms, pte])


@pytest.fixture
def keyed_models(models):
    jf, pf = models["frames"]
    jf.key = pf.key = "rmfr"
    JDKV.put("rmfr", jf)
    DKV.put("rmfr", pf)
    for jm, pm in zip(models["j"], models["p"]):
        JDKV.put(jm.key, jm)
        DKV.put(pm.key, pm)
    yield models
    for m in models["p"] + models["j"]:
        m._default_threshold = None
    DKV.clear()


def test_make_leaderboard(keyed_models):
    expr = "(makeLeaderboard ['rm_gbm' 'rm_glm'] rmfr 'auc' [] 'AUTO')"
    j, p = jx.rapids(expr), px.rapids(expr)
    # the port's leaderboard frame holds model_id as a categorical column
    assert list(p.vec("model_id").labels()) == \
        list(j.vec("model_id").labels()[:j.nrows])
    for c in ("auc", "logloss", "rmse"):
        np.testing.assert_allclose(p.vec(c).to_numpy(),
                                   j.vec(c).to_numpy(), rtol=1e-5)


def test_reset_threshold_changes_predictions(keyed_models):
    jf, pf = keyed_models["frames"]
    expr = "(model.reset.threshold rm_gbm 0.6)"
    assert px.rapids(expr) == jx.rapids(expr) == 0.5
    jp, pp = JDKV["rm_gbm"].predict(jf), DKV["rm_gbm"].predict(pf)
    p1 = pp.vec("pyes").to_numpy()
    np.testing.assert_allclose(p1, jp.vec("pyes").to_numpy(), rtol=1e-5)
    assert list(pp.vec("predict").labels()) == \
        ["yes" if q >= 0.6 else "no" for q in p1]
    assert px.rapids("(model.reset.threshold rm_gbm 0.5)") == 0.6


@pytest.mark.parametrize("model,eps", [("rm_gbm", "1e-5"),
                                       ("rm_gbm", "1e-9")])
def test_test_java_scoring(keyed_models, model, eps):
    """The generated standalone scorer against ``predict``, within eps:
    both engines agree (a float64 scorer against float32 predictions
    differs past 1e-9)."""
    expr = f"(model.testJavaScoring {model} rmfr 'predict' {eps})"
    assert px.rapids(expr) == jx.rapids(expr) == \
        (1.0 if eps == "1e-5" else 0.0)


def test_permutation_varimp(keyed_models):
    for expr in ("(PermutationVarImp rm_gbm rmfr 'auc' -1 1 [] 42)",
                 "(PermutationVarImp rm_glm rmfr 'logloss' 100 3 "
                 "['x0' 'sex'] 7)"):
        j, p = jx.rapids(expr), px.rapids(expr)
        assert p.names == j.names
        assert list(p.vec("Variable").host_values) == \
            list(j.vec("Variable").host_values)
        for n in p.names[1:]:
            np.testing.assert_allclose(p.vec(n).to_numpy(),
                                       j.vec(n).to_numpy(), rtol=1e-3,
                                       atol=1e-5)


def test_result_transform_and_fairness(keyed_models):
    same_value(jx.rapids("(result rm_ms)"), px.rapids("(result rm_ms)"),
               rtol=1e-5, atol=1e-6)
    same_value(jx.rapids("(transform rm_te rmfr)"),
               px.rapids("(transform rm_te rmfr)"), rtol=1e-6)
    expr = "(fairnessMetrics rm_gbm rmfr ['sex'] ['m'] 'yes')"
    j, p = jx.rapids(expr), px.rapids(expr)
    assert p.names == j.names and p.nrows == j.nrows
    for n in p.names:
        if p.vec(n).data is not None and not p.vec(n).is_categorical:
            np.testing.assert_allclose(p.vec(n).to_numpy(),
                                       j.vec(n).to_numpy()[:j.nrows],
                                       rtol=1e-4, atol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="no result frame"):
        px.rapids("(result rm_gbm)")


def test_segment_models_as_frame(keyed_models):
    from h2o3_tpu.orchestration.segments import SegmentModels as JSM
    from h2o3_tpu_torch.orchestration.segments import SegmentModels
    rows = [{"segment": {"sex": "m"}, "model_id": "rm_gbm",
             "status": "SUCCEEDED", "errors": None},
            {"segment": {"sex": "f"}, "model_id": None, "status": "FAILED",
             "errors": "too few rows"}]
    JSM("segs", ["sex"], rows)
    SegmentModels("segs", ["sex"], rows)
    same_value(jx.rapids("(segment_models_as_frame segs)"),
               px.rapids("(segment_models_as_frame segs)"))
