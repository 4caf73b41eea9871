"""The port's GBM distributions and offsets (h2o3_tpu_torch/models/gbm.py:
``_grad_hess``, the per-family initial margin, ``offset_column`` and the
log-link scoring) against the JAX reference ``h2o3_tpu.models.gbm``, on the
same numpy inputs.

Gradients are elementwise float32 in both packages: rtol 1e-6, with an
absolute floor of 1e-6 x max|g| (the two libraries' exp may differ by an
ulp, and g is a difference of terms of that size). Whole GBMs
build their histograms in another summation order (the reference sums
per-device partials under tests/conftest.py's 8 virtual devices): trees
must be equal in structure, leaves within rtol 1e-4 (ratios of sums over
as few as min_rows rows) and predictions within atol 1e-5, as in
tests/test_torch_gbm.py's gaussian test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import gbm as jgbm
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import gbm as pgbm
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from jax_reference import _jax_compile_cache  # noqa: F401

DISTS = ("poisson", "gamma", "tweedie", "laplace", "quantile", "huber")
INT_FIELDS = ("feat", "thresh_bin", "na_left", "is_split")
#: non-default family parameters, so that each reaches the gradients
HP = dict(quantile_alpha=0.3, huber_alpha=0.8, tweedie_power=1.3)
ROWS = 6000


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def positive_cols(rows=ROWS, seed=31, F=8):
    """Numeric features and a positive, skewed response (what the log-link
    and robust families are for), plus an offset column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    eta = 0.4 * X[:, 0] - 0.3 * X[:, 1] + 0.2 * X[:, 2] * X[:, 3]
    t = rng.gamma(2.0, np.exp(eta) / 2.0).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["t"] = t
    cols["off"] = (0.1 * rng.normal(size=rows)).astype(np.float32)
    return cols


@pytest.mark.parametrize("dist", DISTS)
def test_grad_hess_matches_reference(dist):
    rng = np.random.default_rng(32)
    n = 5000
    F = rng.normal(size=n).astype(np.float32)
    y = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    w = (rng.random(n) < 0.9) * (rng.random(n) + 0.5)
    w = w.astype(np.float32)
    jg, jh = jgbm._grad_hess(dist, jnp.asarray(F), jnp.asarray(y),
                             jnp.asarray(w), **HP)
    pg, ph = pgbm._grad_hess(dist, torch.from_numpy(F), torch.from_numpy(y),
                             torch.from_numpy(w), **HP)
    for got, want in ((pg, jg), (ph, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_custom_distribution_waits_for_udf():
    """The "custom" distribution takes its (g, h) from the uploaded one it is
    given, and raises without one."""
    with pytest.raises(ValueError, match="custom"):
        pgbm._grad_hess("custom", torch.zeros(3), torch.zeros(3),
                        torch.ones(3))

    class Gauss:
        def link(self):
            return "identity"

        def init(self, w, o, y):
            return [w * (y - o), w]

        def gradient(self, y, f):
            return y - f

        def gamma(self, w, y, z, f):
            return [w * z, w]

    from h2o3_tpu_torch.utils.udf import CustomDistribution
    F, y = torch.tensor([0.5, -1.0, 2.0]), torch.tensor([1.0, 0.0, 2.5])
    w = torch.tensor([1.0, 2.0, 0.0])
    g, h = pgbm._grad_hess("custom", F, y, w,
                           custom=CustomDistribution(Gauss(), "gauss"))
    torch.testing.assert_close(g, torch.tensor([-0.5, -2.0, 0.0]))
    torch.testing.assert_close(h, torch.tensor([1.0, 2.0, 1e-10]))


def _trees_equal(jtrees, ptrees):
    assert len(ptrees) == len(jtrees)
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        for k in INT_FIELDS:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(b.leaf.numpy(), np.asarray(a.leaf),
                                   rtol=1e-4, atol=1e-4, err_msg=f"tree {i}")


def _both(params, cols, x=None):
    jm = jgbm.GBM(**params).train(x=x, y="t",
                                  training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    pm = pgbm.GBM(**params).train(x=x, y="t", training_frame=fr)
    return jm, pm, fr


@pytest.mark.parametrize("dist", DISTS)
def test_distribution_gbm_matches_reference(dist):
    cols = positive_cols()
    cols.pop("off")
    params = dict(ntrees=5, max_depth=4, nbins=32, learn_rate=0.1, seed=42,
                  distribution=dist, **HP)
    jm, pm, fr = _both(params, cols)
    assert pm.output["distribution"] == jm.output["distribution"] == dist
    assert pm.output["f0"] == pytest.approx(jm.output["f0"], rel=1e-6)
    _trees_equal(jm.output["trees"], pm.output["trees"])
    np.testing.assert_allclose(
        pm.predict(fr).vec("predict").to_numpy(),
        jm.predict(JFrame.from_arrays(cols)).vec("predict").to_numpy()[:ROWS],
        atol=1e-5)
    assert pm.training_metrics.mse == pytest.approx(jm.training_metrics.mse,
                                                    rel=1e-5)


@pytest.fixture(scope="module")
def offset_models():
    cols = positive_cols(seed=33)
    params = dict(ntrees=5, max_depth=4, nbins=32, learn_rate=0.1, seed=42,
                  distribution="poisson", offset_column="off")
    jm, pm, fr = _both(params, cols)
    return cols, jm, pm, fr


def test_offset_column_matches_reference_in_training_and_scoring(
        offset_models):
    cols, jm, pm, fr = offset_models
    assert "off" not in pm.output["x_cols"]
    assert pm.output["x_cols"] == jm.output["x_cols"]
    _trees_equal(jm.output["trees"], pm.output["trees"])
    # training metrics come from the boosting margins, which carry the
    # offset; scoring adds it again from the frame
    assert pm.training_metrics.mse == pytest.approx(jm.training_metrics.mse,
                                                    rel=1e-5)
    got = pm.predict(fr).vec("predict").to_numpy()
    np.testing.assert_allclose(
        got, jm.predict(JFrame.from_arrays(cols)).vec("predict")
        .to_numpy()[:ROWS], atol=1e-5)
    assert pm.model_performance(fr).mse == pytest.approx(
        pm.training_metrics.mse, rel=1e-5)
    # the offset moves the log-link prediction by exp(offset)
    shifted = dict(cols, off=cols["off"] + np.float32(0.5))
    np.testing.assert_allclose(
        pm.predict(Frame.from_arrays(shifted)).vec("predict").to_numpy(),
        got * np.exp(np.float32(0.5)), rtol=1e-5)


def test_scoring_without_the_offset_column_raises(offset_models):
    cols, _, pm, _ = offset_models
    lacking = Frame.from_arrays({k: v for k, v in cols.items() if k != "off"})
    with pytest.raises(ValueError, match="offset column 'off'"):
        pm.predict(lacking)


def test_convert_scores_a_reference_offset_model(offset_models):
    cols, jm, _, fr = offset_models
    out = dict(jm.output, trees=[{k: np.asarray(getattr(t, k))
                                  for k in HEAP_FIELDS}
                                 for t in jm.output["trees"]])
    cm = convert.gbm_model(out, response_column="t",
                           params=dict(offset_column="off"))
    np.testing.assert_allclose(
        cm.predict(fr).vec("predict").to_numpy(),
        jm.predict(JFrame.from_arrays(cols)).vec("predict").to_numpy()[:ROWS],
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dist,y", [("poisson", "b"), ("bernoulli", "t"),
                                    ("multinomial", "t")])
def test_distribution_and_response_mismatches_raise_like_reference(dist, y):
    cols = positive_cols(rows=200, seed=34)
    cols["b"] = np.where(cols["x0"] > 0, "u", "v")
    for GBM, F in ((jgbm.GBM, JFrame), (pgbm.GBM, Frame)):
        with pytest.raises(ValueError):
            GBM(ntrees=1, distribution=dist).train(
                x=["x0", "x1"], y=y, training_frame=F.from_arrays(cols))
