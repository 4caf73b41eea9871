"""Validation-frame early stopping and the scoring history in the port,
and a reference GBM stopped early carried through ``convert``, against
the JAX reference (the cases of tests/test_torch_stopping.py with a
validation frame, at its tolerances: metric values within rtol 1e-5,
1e-3 for a model's AUC history, the stop point, the kept trees' splits
and the history's shape exactly): a file of its own so that
pytest-xdist's ``--dist loadfile`` spreads the stopping cases over its
workers."""

import numpy as np
import pytest

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_stopping import _alike, _cpu_port, stop_cols  # noqa: F401


@pytest.mark.parametrize("metric", ["logloss", "AUC", "misclassification"])
def test_validation_stopping_and_history_match_reference(metric):
    cols, vcols = stop_cols(3, 1200), stop_cols(4, 500)
    kw = dict(ntrees=60, max_depth=3, learn_rate=0.3, stopping_rounds=2,
              stopping_metric=metric, stopping_tolerance=1e-3, seed=3)
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols),
                          validation_frame=JFrame.from_arrays(vcols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols),
                         validation_frame=Frame.from_arrays(vcols))
    assert pm.output["ntrees"] == jm.output["ntrees"] < 60
    _alike(jm.output["trees"], pm.output["trees"])
    for k in ("auc", "logloss", "mse"):
        np.testing.assert_allclose(getattr(pm.validation_metrics, k),
                                   getattr(jm.validation_metrics, k),
                                   rtol=1e-5)
    jcols, jrows = jm.scoring_history
    pcols, prows = pm.scoring_history
    assert pcols == jcols
    assert [c[0] for c in pcols][2:] == [
        "number_of_trees", f"training_{GBM._HIST_NAMES[metric]}",
        f"validation_{GBM._HIST_NAMES[metric]}"]
    assert len(prows) == len(jrows) == pm.output["ntrees"]
    # AUC credits tied scores at half: after a few shallow trees whole leaf
    # groups tie, and whether two groups' margins tie turns on the last ulp
    # of a leaf value (the port's leaf totals sum in float64 on the CPU,
    # the reference's in float32)
    np.testing.assert_allclose(np.array([r[2:] for r in prows], float),
                               np.array([r[2:] for r in jrows], float),
                               rtol=1e-3 if metric == "AUC" else 1e-5,
                               atol=1e-7)


def test_reference_stopped_model_scores_through_convert():
    """A GBM the JAX package stopped early, carried into the port, scores
    its validation frame as the reference does (rtol 1e-5), with the
    reference's varimp (rtol 1e-12) and contributions that sum to its
    margin (rtol 1e-5: the margin is float32)."""
    cols, vcols = stop_cols(11, 1200), stop_cols(12, 400)
    jm = JGBM(ntrees=60, max_depth=3, learn_rate=0.3, stopping_rounds=2,
              stopping_tolerance=1e-3, seed=11).train(
        y="y", training_frame=JFrame.from_arrays(cols),
        validation_frame=JFrame.from_arrays(vcols))
    assert jm.output["ntrees"] < 60
    o = jm.output
    cm = convert.gbm_model(
        dict(trees=[{k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
                    for t in o["trees"]],
             edges=np.asarray(o["edges"]), f0=o["f0"],
             learn_rate=o["learn_rate"], distribution=o["distribution"],
             x_cols=o["x_cols"], feat_domains=o["feat_domains"],
             ntrees=o["ntrees"]),
        response_column="y", response_domain=jm.response_domain,
        device="cpu")
    vf = Frame.from_arrays(vcols)
    want = jm.predict(JFrame.from_arrays(vcols)).vec("pa").to_numpy()
    np.testing.assert_allclose(cm.predict(vf).vec("pa").to_numpy(),
                               want[: vf.nrows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cm.model_performance(vf).logloss,
                               jm.validation_metrics.logloss, rtol=1e-5)
    # the carried model's varimp is the reference's, and its SHAP rows sum
    # to its logit margin
    want_vi = jm.varimp()
    assert [r[0] for r in cm.varimp()] == [r[0] for r in want_vi]
    np.testing.assert_allclose([r[1] for r in cm.varimp()],
                               [r[1] for r in want_vi], rtol=1e-12)
    p1 = cm._score_raw(vf)[:, 1].double().numpy()
    np.testing.assert_allclose(cm.contributions(vf).numpy().sum(1),
                               np.log(p1 / (1 - p1)), rtol=1e-5, atol=1e-5)
