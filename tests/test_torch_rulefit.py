"""RuleFit in the port (h2o3_tpu_torch/models/rulefit.py) against the JAX
reference (``h2o3_tpu/models/rulefit.py``) on the same numpy-seeded
frames: five numeric features (a few missing) and a categorical one read
as ordinal codes, a binary and a numeric response.

The depth ladder's GBMs run without sampling, so both packages grow the
same trees (their leaves differ in the last bits, ROADMAP queue C), and
the node masks, rule names and kept rules are held exactly: on the
reference's own trees, and on each package's trees in a whole fit. The
level-1 GLM's coefficients are not unique (a split's two rules sum to the
intercept's column), so fits are held by their predictions: regression
at rtol 1e-5 with a floor of 1e-5 x the largest (8e-7 of 1.95 seen), and
binomial probabilities at 1e-2 with the training logloss at rtol 1e-4:
ten proximal L1 steps on the singular design move the port's own
probabilities by 7.3e-3 when its six linear columns move by one float32
ulp, and the two packages' by 2.2e-3 (logloss 4e-5 apart). The reference
fails with ``max_num_rules`` (it writes into a read-only fetched array),
so the port's cut is held to the first rules the reference keeps
without it.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import rulefit as jrf
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.gbm import tree_matrix as j_tree_matrix
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import rulefit as prf
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from jax_reference import _jax_compile_cache  # noqa: F401

N = 640
X = [f"x{i}" for i in range(5)] + ["c"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def rf_cols(n=N, seed=0, binomial=True):
    rng = np.random.default_rng(seed)
    Xm = rng.normal(size=(n, 5)).astype(np.float32)
    c = rng.choice(np.array(["lo", "mid", "hi", "top"]), n)
    eta = 1.5 * (Xm[:, 0] > 0.3) - 1.2 * (Xm[:, 1] < -0.5) * (Xm[:, 2] > 0) \
        + 0.8 * Xm[:, 3] + 0.7 * (c == "top")
    cols = {f"x{i}": Xm[:, i].copy() for i in range(5)}
    cols["x0"][rng.random(n) < 0.03] = np.nan
    cols["x3"][rng.random(n) < 0.03] = np.nan
    cols["c"] = c
    if binomial:
        cols["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "pos",
                             "neg")
    else:
        cols["y"] = (eta + rng.normal(scale=0.3, size=n)).astype(np.float32)
    return cols


def fields_of(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in prf.RULE_FIELDS}


@pytest.fixture(scope="module")
def ref_trees():
    cols = rf_cols()
    jf = JFrame.from_arrays(cols)
    gbm = JGBM(ntrees=3, max_depth=3, categorical_encoding="ordinal").train(
        x=X, y="y", training_frame=jf)
    return cols, jf, gbm.output["trees"]


def test_node_masks_and_rule_names_match_reference_exactly(ref_trees):
    cols, jf, trees = ref_trees
    domains = {"c": jf.vec("c").domain}
    jX = j_tree_matrix(jf, X, domains)
    XT = prf._feature_rows(Frame.from_arrays(cols), X, domains)
    for ti, tr in enumerate(trees):
        want = np.asarray(jrf._node_masks(jX, tr))[:N]
        got = prf._node_masks(XT, fields_of(tr)).numpy()
        np.testing.assert_array_equal(got.T, want)
        assert prf._rule_names_for_tree(fields_of(tr), X, ti) == \
            jrf._rule_names_for_tree(tr, X, ti)


def test_host_fields_read_every_tree_in_one_fetch(ref_trees):
    _, _, trees = ref_trees
    pt = [type("T", (), {f: torch.as_tensor(np.asarray(getattr(t, f)))
                         for f in prf.RULE_FIELDS}) for t in trees]
    for got, tr in zip(prf._host_fields(pt), trees):
        for f in prf.RULE_FIELDS:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(tr, f)))


_FITS: dict = {}


def fit_pair(binomial=True, **kw):
    """(columns, reference fit, port fit), each configuration fitted once
    in the module."""
    key = (binomial, tuple(sorted(kw.items())))
    if key not in _FITS:
        cols = rf_cols(binomial=binomial)
        jm = jrf.RuleFit(**kw).train(x=X, y="y",
                                     training_frame=JFrame.from_arrays(cols))
        pm = prf.RuleFit(**kw).train(x=X, y="y",
                                     training_frame=Frame.from_arrays(cols))
        _FITS[key] = cols, jm, pm
    return _FITS[key]


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("binomial,params", [
    (True, dict(rule_generation_ntrees=3, min_rule_length=2)),
    (False, dict(rule_generation_ntrees=3, model_type="rules",
                 max_rule_length=2)),
    (True, dict(rule_generation_ntrees=3, min_rule_length=2,
                model_type="linear")),
])
def test_fit_matches_reference(binomial, params):
    cols, jm, pm = fit_pair(binomial, **params)
    jo, po = jm.output, pm.output
    assert po["rule_names"] == jo["rule_names"]
    np.testing.assert_array_equal(po["rule_keep"], np.asarray(jo["rule_keep"]))
    if params.get("model_type") != "linear":
        fr = Frame.from_arrays(cols)
        XT = prf._feature_rows(fr, X, po["feat_domains"])
        for a, b in zip(prf._host_fields(po["trees"]), jo["trees"]):
            np.testing.assert_array_equal(
                prf._node_masks(XT, a).numpy(),
                prf._node_masks(XT, fields_of(b)).numpy())
    _close(po["lin_mean"], jo["lin_mean"], 1e-5)
    _close(po["lin_sd"], jo["lin_sd"], 1e-5)
    got = pm.predict(Frame.from_arrays(cols))
    want = jm.predict(JFrame.from_arrays(cols))
    if binomial:
        np.testing.assert_allclose(got.vec("ppos").to_numpy(),
                                   want.vec("ppos").to_numpy()[:N], atol=1e-2)
        np.testing.assert_allclose(pm.training_metrics.logloss,
                                   jm.training_metrics.logloss, rtol=1e-4)
    else:
        _close(got.vec("predict").to_numpy(),
               want.vec("predict").to_numpy()[:N], 1e-5)
    names = set(po["rule_names"])
    assert {n for n, _ in pm.rule_importance()} <= names


def test_max_num_rules_keeps_the_first_rules():
    cols, jm, _ = fit_pair(False, rule_generation_ntrees=3,
                           model_type="rules", max_rule_length=2)
    pm = prf.RuleFit(rule_generation_ntrees=3, model_type="rules",
                     max_rule_length=2, max_num_rules=12).train(
        x=X, y="y", training_frame=Frame.from_arrays(cols))
    assert pm.output["rule_names"] == jm.output["rule_names"][:12]
    assert int(pm.output["rule_keep"].sum()) == 12
    assert len(pm.output["beta"]) == 13


def test_reference_model_scores_alike_through_convert():
    cols = rf_cols(seed=2)
    jm = jrf.RuleFit(rule_generation_ntrees=3, min_rule_length=2).train(
        x=X, y="y", training_frame=JFrame.from_arrays(cols))
    out = dict(jm.output, trees=[{k: np.asarray(getattr(t, k))
                                  for k in HEAP_FIELDS}
                                 for t in jm.output["trees"]])
    pm = convert.rulefit_model(out, "y", jm.response_domain, dict(jm.params),
                               device="cpu")
    test = rf_cols(seed=5)
    # the reference's own coefficients: only float32 rounding differs
    _close(pm.predict(Frame.from_arrays(test)).vec("ppos").to_numpy(),
           jm.predict(JFrame.from_arrays(test)).vec("ppos").to_numpy()[:N],
           1e-5)


def test_refusals():
    fr = Frame.from_arrays(dict(rf_cols(), k=np.array(list("abc") * 213
                                                       + ["a"])))
    with pytest.raises(ValueError, match="binary classification"):
        prf.RuleFit().train(x=X, y="k", training_frame=fr)
    with pytest.raises(ValueError, match="model_type"):
        prf.RuleFit(model_type="trees").train(x=X, y="y", training_frame=fr)


def _ridge_spy(monkeypatch, fails_below: float):
    """The GLM's Gram made indefinite while its ridge is below
    ``fails_below``; returns the list of ridges it was built with."""
    from h2o3_tpu_torch.models import glm as pglm
    seen, orig = [], pglm._weighted_gram

    def gram(X, W, z, l2, nobs, jitter):
        seen.append(jitter)
        g, rhs = orig(X, W, z, l2, nobs, jitter)
        if jitter < fails_below:
            g = g - 1e6 * torch.eye(g.shape[0])
        return g, rhs

    monkeypatch.setattr(pglm, "_weighted_gram", gram)
    return seen


def test_a_failed_factorisation_is_retried_with_ten_times_the_ridge(
        monkeypatch):
    """The level-1 GLM's Gram is singular (complementary rules), and in
    float32 can round below the ridge: the step is taken again with ten
    times the ridge, and the fit then equals one that started there."""
    from h2o3_tpu_torch.models import glm as pglm
    fr = Frame.from_arrays(rf_cols(binomial=False))
    kw = dict(alpha=1.0, lambda_=1e-3)
    seen = _ridge_spy(monkeypatch, 1e-3)
    got = pglm.GLM(**kw).train(x=X[:5], y="y", training_frame=fr)
    assert seen[:3] == pytest.approx([1e-5, 1e-4, 1e-3])
    assert all(j == pytest.approx(1e-3) for j in seen[2:])
    monkeypatch.undo()
    monkeypatch.setattr(pglm, "JITTER", 1e-3)
    want = pglm.GLM(**kw).train(x=X[:5], y="y", training_frame=fr)
    np.testing.assert_array_equal(got.output["coef"], want.output["coef"])
    _ridge_spy(monkeypatch, 1.0)
    with pytest.raises(ValueError, match="not positive definite"):
        pglm.GLM(**kw).train(x=X[:5], y="y", training_frame=fr)
