"""Uplift DRF in the port (h2o3_tpu_torch/models/uplift.py: ``compute_auuc``,
``ModelMetricsBinomialUplift``, ``UpliftDRFModel``, ``UpliftDRF``) against
the JAX reference (``h2o3_tpu/models/uplift.py``) on the same numpy-seeded
inputs.

The two packages draw their bootstrap weights from different streams, so
a forest is held to the reference's on weights drawn with numpy and
injected into both (one batch of 8 trees and one of 2): trees equal in
structure, leaves within rtol 1e-5 and atol 1e-6 (float32 sums in another
order), the propensity within rtol 1e-6. ``compute_auuc`` on predictions
with many ties (a stable sort in both) equals the reference's within rtol
1e-6 (float32 sums of 1000 bins in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import uplift as jup
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import uplift as pup
from h2o3_tpu_torch.models.tree import HEAP_FIELDS

NTREES = 10


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def uplift_cols(n=4000, F=5, seed=41):
    """Criteo-like: numeric features, a treatment at 85%, a rare visit
    whose lift depends on x0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    treated = rng.random(n) < 0.85
    base = 1 / (1 + np.exp(-(-2.0 + 0.5 * X[:, 1])))
    lift = 0.15 / (1 + np.exp(-2 * X[:, 0]))
    y = rng.random(n) < base + treated * lift
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["treatment"] = np.where(treated, "treatment", "control")
    cols["visit"] = np.where(y, "1", "0")
    return cols


@pytest.fixture(scope="module")
def forests():
    """The reference's forest and the port's, on one set of numpy-drawn
    Poisson(0.632) bootstrap weights."""
    cols = uplift_cols()
    n = len(cols["visit"])
    boot = np.random.default_rng(42).poisson(0.632, (NTREES, n)).astype(
        np.float32)
    kw = dict(treatment_column="treatment", ntrees=NTREES, max_depth=4)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jb = jup.UpliftDRF(**kw)
    drawn = iter(boot)

    def reference_weights(key, w, rate, bootstrap):
        pad = np.zeros(w.shape[0], np.float32)
        pad[:n] = next(drawn)
        return w * jnp.asarray(pad)

    jb._row_weights = reference_weights
    jm = jb.train(y="visit", training_frame=jf)
    pb = pup.UpliftDRF(**kw)
    pb._batch_weights = lambda w, s, k: [w * torch.from_numpy(boot[s + i])
                                         for i in range(k)]
    pm = pb.train(y="visit", training_frame=pf)
    return cols, jf, pf, jm, pm


def test_forest_on_injected_bootstrap_equals_reference(forests):
    cols, jf, pf, jm, pm = forests
    assert pm.output["x_cols"] == jm.output["x_cols"] == \
        [f"x{i}" for i in range(5)]
    assert pm.output["propensity"] == pytest.approx(
        jm.output["propensity"], rel=1e-6)
    assert len(pm.output["trees"]) == len(jm.output["trees"]) == NTREES
    for jt, pt in zip(jm.output["trees"], pm.output["trees"]):
        for k in ("feat", "thresh_bin", "na_left", "is_split"):
            np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                          np.asarray(getattr(jt, k)),
                                          err_msg=k)
        np.testing.assert_allclose(pt.leaf.numpy(), np.asarray(jt.leaf),
                                   rtol=1e-5, atol=1e-6)
    assert sum(int(t.is_split.sum()) for t in pm.output["trees"]) > 20
    n = pf.nrows
    np.testing.assert_allclose(
        pm.predict(pf).vec("uplift_predict").to_numpy(),
        jm.predict(jf).vec("uplift_predict").to_numpy()[:n], rtol=1e-5,
        atol=1e-6)


def test_training_metrics_are_the_auuc_of_the_training_frame(forests):
    cols, jf, pf, jm, pm = forests
    tm, scored = pm.training_metrics, pm.model_performance(pf)
    assert isinstance(tm, pup.ModelMetricsBinomialUplift) and tm.nbins == 1000
    for k in ("auuc", "qini", "auuc_normalized"):
        assert np.isfinite(getattr(tm, k))
        assert getattr(scored, k) == getattr(tm, k)
        assert getattr(tm, k) == pytest.approx(getattr(jm.training_metrics, k),
                                               rel=1e-4)


def _auuc_inputs(n=5000, seed=43, levels=7):
    rng = np.random.default_rng(seed)
    # few distinct predictions: long runs of ties, as averaged leaves give
    u = (rng.integers(0, levels, n) / levels - 0.3).astype(np.float32)
    y = (rng.random(n) < 0.05 + 0.1 * (u > 0)).astype(np.float32)
    t = (rng.random(n) < 0.85).astype(np.float32)
    mask = rng.random(n) > 0.02
    return u, y, t, mask


@pytest.mark.parametrize("nbins", [1000, 37])
def test_compute_auuc_with_ties_matches_reference(nbins):
    u, y, t, mask = _auuc_inputs()
    want = jup.compute_auuc(jnp.asarray(u), jnp.asarray(y), jnp.asarray(t),
                            jnp.asarray(mask), nbins)
    got = pup.compute_auuc(*map(torch.from_numpy, (u, y, t, mask)), nbins)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the order of tied rows moves the bins: the sort must be stable
    order = np.argsort(-np.where(mask, u, -np.inf), kind="stable")
    rev = order[::-1].copy()
    perm = lambda a: torch.from_numpy(np.ascontiguousarray(a[rev]))
    shuffled = pup.compute_auuc(perm(u), perm(y), perm(t), perm(mask), nbins)
    assert shuffled != got


def test_reference_uplift_model_scores_through_convert(forests):
    cols, jf, pf, jm, _ = forests
    o = dict(jm.output, trees=[{k: np.asarray(getattr(t, k))
                                for k in HEAP_FIELDS}
                               for t in jm.output["trees"]])
    cm = convert.uplift_model(o, response_column="visit",
                              response_domain=jm.response_domain,
                              params=jm.params, device="cpu")
    n = pf.nrows
    np.testing.assert_allclose(
        cm.predict(pf).vec("uplift_predict").to_numpy(),
        jm.predict(jf).vec("uplift_predict").to_numpy()[:n], atol=1e-6)
    got, want = cm.model_performance(pf), jm.model_performance(jf)
    np.testing.assert_allclose(
        [got.auuc, got.qini, got.auuc_normalized],
        [want.auuc, want.qini, want.auuc_normalized], rtol=1e-6)
    phi = cm.contributions(pf).numpy()
    np.testing.assert_allclose(phi.sum(1), cm._score_raw(pf).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_uplift_refusals():
    cols = uplift_cols(400, seed=44)
    fr = Frame.from_arrays(cols)
    with pytest.raises(ValueError, match="treatment_column is required"):
        pup.UpliftDRF(ntrees=2).train(y="visit", training_frame=fr)
    bad = Frame.from_arrays(dict(cols, treatment=np.array(["a", "b", "c"])[
        np.random.default_rng(1).integers(0, 3, 400)]))
    with pytest.raises(ValueError, match="2-level categorical"):
        pup.UpliftDRF(ntrees=2, treatment_column="treatment").train(
            y="visit", training_frame=bad)
    with pytest.raises(ValueError, match="uplift_metric"):
        pup.UpliftDRF(ntrees=2, treatment_column="treatment",
                      uplift_metric="Euclidean").train(y="visit",
                                                       training_frame=fr)
    with pytest.raises(ValueError, match="does not take calibrate_model"):
        pup.UpliftDRF(ntrees=2, treatment_column="treatment",
                      calibrate_model=True).train(y="visit",
                                                  training_frame=fr)
    with pytest.raises(ValueError, match="2-level categorical"):
        pup.UpliftDRF(ntrees=2, treatment_column="treatment").train(
            y="x0", training_frame=fr)


def test_trees_grow_eight_to_a_histogram_launch(monkeypatch):
    """Each level of a batch is one histogram call for its K trees: 10
    trees of depth 3 make 2 batches (K = 8 and 2) x 3 levels."""
    from h2o3_tpu_torch.models import tree as ptree
    calls = []
    real = ptree._histograms

    def counting(binned_T, node, g, h, w, N, Bt):
        calls.append((tuple(node.shape), tuple(w.shape)))
        return real(binned_T, node, g, h, w, N, Bt)

    monkeypatch.setattr(ptree, "_histograms", counting)
    cols = uplift_cols(1000, seed=45)
    pup.UpliftDRF(treatment_column="treatment", ntrees=10, max_depth=3) \
        .train(y="visit", training_frame=Frame.from_arrays(cols))
    assert [c[0][0] for c in calls] == [8, 8, 8, 2, 2, 2]
    assert all(len(c[1]) == 2 for c in calls)     # a weight row per tree
