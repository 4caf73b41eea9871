"""The port's Leaderboard (``h2o3_tpu_torch/orchestration/
leaderboard.py``) against the JAX package's, on the same models: JAX
GBMs, a DRF and a GLM trained with CV and kept out-of-fold predictions,
carried into the port by ``convert`` (tests/test_torch_carry.py), whose CV
metrics the port recomputes from the carried predictions. The rank,
``leader``, ``as_frame`` and ``table()`` equal the reference's, for a
binomial and a regression response, with and without a leaderboard frame.

Row counts are multiples of 64 (no pad rows). Metrics at rtol 1e-5 (the
same predictions through each package's metric code: float32 sums in
other orders; AUC from the same 400-bin histogram) and, with a
leaderboard frame, at rtol 1e-4 (each package scores the same trees,
in float32 ulps apart). ``as_frame``'s ``model_id`` and ``algo`` are
compared by value, whatever type each package's ``Frame.from_arrays``
gives their strings.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import DRF as JDRF, GBM as JGBM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.orchestration.leaderboard import Leaderboard as JLeaderboard
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.orchestration.leaderboard import Leaderboard
from h2o3_tpu_torch.utils.registry import DKV
from test_torch_carry import carry
from jax_reference import _jax_compile_cache  # noqa: F401

N = 512


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _clear_port_dkv():
    """The module starts and ends with an empty port DKV (other files'
    models may share this process; the module's fixtures train models
    that its tests share)."""
    DKV.clear()
    yield
    DKV.clear()


def lb_cols(n=N, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    logit = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.9 * X[:, 2] * X[:, 3]
    yb = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    yg = (logit + 0.5 * rng.normal(size=n)).astype(np.float32)
    return {**{f"x{i}": X[:, i] for i in range(4)}, "yb": yb, "yg": yg}


@pytest.fixture(scope="module", params=["yb", "yg"])
def models(request):
    y = request.param
    cols = lb_cols()
    x = [f"x{i}" for i in range(4)]
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    cv = dict(nfolds=3, keep_cross_validation_predictions=True, seed=2)
    family = "binomial" if y == "yb" else "gaussian"
    jms = [JGBM(ntrees=4, max_depth=d, nbins=16, **cv).train(
               x=x, y=y, training_frame=jf) for d in (2, 4)]
    jms.append(JDRF(ntrees=3, max_depth=4, nbins=16, **cv).train(
        x=x, y=y, training_frame=jf))
    jms.append(JGLM(family=family, lambda_=0.0, **cv).train(
        x=x, y=y, training_frame=jf))
    pms = [carry(jm, N, pf) for jm in jms]
    return y, cols, jms, pms


def _boards(jms, pms, jframe=None, pframe=None, sort_metric=None):
    jlb = JLeaderboard(sort_metric, jframe)
    plb = Leaderboard(sort_metric, pframe)
    for jm, pm in zip(jms, pms):
        jlb.add(jm)
        plb.add(pm)
    return jlb, plb


def _same_boards(jlb, plb, rtol):
    assert len(plb) == len(jlb)
    assert [m.key for m in plb.models] == [m.key for m in jlb.models]
    assert plb.leader.key == jlb.leader.key
    jt, pt = jlb.table(["ALL"]), plb.table(["ALL"])
    assert pt[0] == jt[0] and pt[2:4] == jt[2:4] and pt[5] == jt[5]
    np.testing.assert_allclose(pt[4], jt[4], rtol=rtol)
    for prow, jrow in zip(pt[1], jt[1]):
        assert prow[0] == jrow[0] and prow[-1] == jrow[-1]
        np.testing.assert_allclose(np.float64(prow[1:-1]),
                                   np.float64(jrow[1:-1]), rtol=rtol)
    jfr, pfr = jlb.as_frame(), plb.as_frame()
    assert pfr.names == jfr.names and pfr.nrows == jfr.nrows
    for c in pfr.names:
        pv, jv = pfr.vec(c), jfr.vec(c)
        if c in ("model_id", "algo"):
            jvals = jv.labels() if jv.is_categorical else jv.to_numpy()
            assert list(pv.labels()) == list(jvals[: jfr.nrows])
        else:
            np.testing.assert_allclose(pv.to_numpy(),
                                       jv.to_numpy()[: jfr.nrows], rtol=rtol)


def test_ranks_like_the_reference_from_cv_metrics(models):
    _, _, jms, pms = models
    _same_boards(*_boards(jms, pms), rtol=1e-5)


def test_ranks_like_the_reference_on_a_leaderboard_frame(models):
    y, _, jms, pms = models
    held = lb_cols(256, seed=9)
    jlb, plb = _boards(jms, pms, JFrame.from_arrays(held),
                       Frame.from_arrays(held))
    _same_boards(jlb, plb, rtol=1e-4)


@pytest.mark.parametrize("metric", ["logloss", "rmse", "mae"])
def test_an_explicit_sort_metric_ranks_like_the_reference(models, metric):
    y, _, jms, pms = models
    if (metric == "logloss") != (y == "yb"):
        metric = "mse"
    _same_boards(*_boards(jms, pms, sort_metric=metric), rtol=1e-5)


def test_empty_boards_agree():
    jlb, plb = JLeaderboard(), Leaderboard()
    assert plb.leader is None and plb.table() == jlb.table()
    assert plb.as_frame().ncols == 0 == jlb.as_frame().ncols
