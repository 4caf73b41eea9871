"""Cross-validation of the port's GLM-based and other builders (NaiveBayes,
DeepLearning, GAM, ModelSelection, ANOVAGLM, IsotonicRegression, HGLM,
PSVM, CoxPH through its own train, the sparse GLM's refusal) against the
JAX package's, on tests/test_torch_cv.py's frame and at its tolerances
(its ``check_builder_cv`` holds each case; CoxPH's CV MSE at rtol 1e-3:
its fits stop where the float32 log-likelihood stops moving): a file of
its own so that pytest-xdist's ``--dist loadfile`` spreads the
cross-validation cases over its workers."""

import numpy as np
import pytest

from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_cv import (_cpu_port, check_builder_cv,  # noqa: F401
                           frames)
from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import GLM


@pytest.mark.parametrize("case", ["naive_bayes", "deeplearning", "gam",
                                  "model_selection", "anova_glm",
                                  "isotonic", "hglm", "psvm"])
def test_every_supervised_builder_cross_validates(frames, case, monkeypatch):
    check_builder_cv(frames, case, monkeypatch)


def test_coxph_cross_validates_through_its_own_train():
    from h2o3_tpu.models.coxph import CoxPH as JCoxPH
    from h2o3_tpu_torch.models.coxph import CoxPH
    rng = np.random.default_rng(4)
    n = 512
    x1, x2 = rng.normal(size=(2, n)).astype(np.float32)
    t = np.ceil(rng.exponential(1.0 / np.exp(0.7 * x1)) * 8).astype(
        np.float32)
    cols = {"x1": x1, "x2": x2, "t": t,
            "event": (rng.random(n) > 0.3).astype(np.float32)}
    kw = dict(stop_column="t", nfolds=3)
    pm = CoxPH(**kw).train(y="event", training_frame=Frame.from_arrays(cols))
    jm = JCoxPH(**kw).train(y="event",
                            training_frame=JFrame.from_arrays(cols))
    np.testing.assert_allclose(pm.cross_validation_metrics.mse,
                               jm.cross_validation_metrics.mse, rtol=1e-3)
    assert pm.cv_metrics_summary[0] == jm.cv_metrics_summary[0]




def test_sparse_glm_refuses_cv():
    from h2o3_tpu_torch.frame.sparse import SparseFrame, SparseMatrix
    from h2o3_tpu_torch.frame.vec import Vec
    sf = SparseFrame(SparseMatrix.from_scipy_like(
        np.array([0, 1]), np.array([0, 1]), np.ones(2), 2, 2),
        {"C0": Vec.from_numpy(np.array([0.0, 1.0], np.float32))})
    with pytest.raises(NotImplementedError, match="cross-validation"):
        GLM(family="binomial", nfolds=2).train(training_frame=sf)
