"""The port's DRF (h2o3_tpu_torch/models/gbm.py:DRF, DRFModel) and its row
and column samplers against the JAX reference ``h2o3_tpu.models.gbm.DRF``.

The two packages draw their bootstrap counts and feature masks from
different random streams (``torch.Generator`` against ``jax.random``), so
one DRF tree is held to the reference's ``_grow_tree_device`` on the same
bootstrap weights drawn with numpy (integer heap arrays equal, float ones
allclose at rtol 1e-5, atol 1e-5), whole forests at their default sampling
to metric tolerances only (stated at each check), and the samplers to
their contracts within stated statistical tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import tree as jtree
from h2o3_tpu.models.gbm import DRF as JDRF
from h2o3_tpu.ops import quantile as jquantile
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import tree as ptree
from h2o3_tpu_torch.models.gbm import DRF, SharedTreeBuilder
from h2o3_tpu_torch.models.tree import HEAP_FIELDS

INT_FIELDS = ("feat", "thresh_bin", "na_left", "is_split")
ROWS = 20_000
#: forests small enough for the test budget, at DRF's default sampling
#: (sample_rate 0.632, mtries sqrt(F) or F/3, min_rows 1)
FOREST = dict(ntrees=5, max_depth=5)
#: each package grows one forest per seed and the metrics' means are
#: compared: one forest's training AUC varied with its seed by sd 0.006
#: (port) and 0.008 (reference) on this frame, its MSE by 1%, its logloss
#: by 0.3%, so the means of four differ by sd 0.005 in AUC by chance alone
SEEDS = (42, 43, 44, 45)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def forest_cols(rows=ROWS, seed=41, F=12):
    """Numeric features with a binomial, a 3-class and a numeric response.
    The signal is spread over every feature, so that a forest's metric
    depends little on which features its levels happen to draw: with it on
    two features, one forest's MSE varied by 14% (sd) from seed to seed in
    either package, too much for a one-forest comparison."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    coef = np.linspace(0.6, 0.3, F) * np.where(np.arange(F) % 2, -1, 1)
    logit = X @ coef.astype(np.float32) + 0.3 * X[:, 0] * X[:, 1]
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["b"] = np.where(rng.random(rows) < 1 / (1 + np.exp(-logit)), "s", "b")
    scores = np.stack([X[:, 0::3].sum(1), X[:, 1::3].sum(1),
                       X[:, 2::3].sum(1)], 1) * 0.5
    cols["c"] = np.array(["c0", "c1", "c2"])[
        (scores + rng.gumbel(size=(rows, 3))).argmax(1)]
    cols["t"] = (logit + 0.3 * rng.normal(size=rows)).astype(np.float32)
    return cols


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


_jax_grow = jax.jit(jtree._grow_tree_device,
                    static_argnames=("depth", "n_bins", "do_col_sample",
                                     "mesh"))


@pytest.mark.parametrize("response", ["binomial", "regression"])
def test_one_drf_tree_matches_reference_on_the_same_bootstrap(response):
    rng = np.random.default_rng(42)
    R, F, nbins, depth = 5000, 6, 32, 5
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    edges = jquantile.compute_bin_edges(X, nbins)
    binned = np.asarray(jquantile.bin_features(jnp.asarray(X),
                                               jnp.asarray(edges)))
    z = np.nan_to_num(X[:, 0]) - 0.7 * np.nan_to_num(X[:, 1])
    y = ((rng.random(R) < 1 / (1 + np.exp(-2 * z))) if response == "binomial"
         else z + 0.2 * rng.normal(size=R)).astype(np.float32)
    # the bootstrap, drawn with numpy and given to both packages
    wt = rng.poisson(0.632, R).astype(np.float32)
    g, h = (-y * wt).astype(np.float32), wt
    hp = (1.0, 0.0, 0.0, 0.0, 1e-5)     # DRF: min_rows 1, no regularisation
    fmask = np.ones(F, bool)
    want = _jax_grow(
        jnp.asarray(binned), jnp.asarray(binned.T), jnp.asarray(edges),
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(wt), jnp.asarray(fmask),
        jax.random.PRNGKey(0), depth, nbins, *hp, 1.0, do_col_sample=False,
        mesh=None)
    got = ptree._grow_tree_device(
        _t(binned), _t(binned.T), _t(edges), _t(g), _t(h), _t(wt), _t(fmask),
        depth, nbins, *hp)
    for name, a, b in zip(HEAP_FIELDS + ("row_leaf",), want, got):
        a, b = np.asarray(a), b.numpy()
        if name in INT_FIELDS:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)
    assert got[HEAP_FIELDS.index("is_split")].sum() >= 7


@pytest.fixture(scope="module")
def forests():
    cols = forest_cols()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    x = [c for c in cols if c.startswith("x")]
    out = {}
    for y in ("b", "c", "t"):
        out[y] = [(JDRF(seed=s, **FOREST).train(x=x, y=y, training_frame=jf),
                   DRF(seed=s, **FOREST).train(x=x, y=y, training_frame=pf))
                  for s in SEEDS]
    return cols, jf, pf, out


def _means(pairs, metric):
    """The metric's mean over the seeds' forests: (reference, port)."""
    return tuple(float(np.mean([getattr(m[i].training_metrics, metric)
                                for m in pairs])) for i in (0, 1))


def test_binomial_forest_auc_within_0015_of_reference(forests):
    _, _, _, out = forests
    pm = out["b"][0][1]
    assert pm.output["binomial"] and len(pm.output["trees"]) == 5
    ref, port = _means(out["b"], "auc")
    # three standard deviations of the difference of the two means
    assert abs(port - ref) < 0.015
    assert port > 0.74


def test_multinomial_forest_logloss_within_2pct_of_reference(forests):
    _, _, pf, out = forests
    pm = out["c"][0][1]
    assert len(pm.output["trees_multi"]) == 3
    assert all(len(ts) == 5 for ts in pm.output["trees_multi"])
    ref, port = _means(out["c"], "logloss")
    assert port == pytest.approx(ref, rel=0.02)
    ref, port = _means(out["c"], "mean_per_class_error")
    assert abs(port - ref) < 0.02
    probs = torch.stack([v.data for v in pm.predict(pf).vecs[1:]], 1)
    torch.testing.assert_close(probs.sum(1), torch.ones(ROWS))


def test_regression_forest_mse_within_5pct_of_reference(forests):
    _, _, _, out = forests
    ref, port = _means(out["t"], "mse")
    assert port == pytest.approx(ref, rel=0.05)


@pytest.mark.parametrize("y,convert_as", [("b", "binomial"),
                                          ("c", "multinomial")])
def test_convert_scores_a_reference_forest(forests, y, convert_as):
    cols, jf, pf, out = forests
    jm = out[y][0][0]
    tree_dict = lambda t: {k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
    o = dict(jm.output)
    if convert_as == "multinomial":
        o["trees_multi"] = [[tree_dict(t) for t in ts]
                            for ts in jm.output["trees_multi"]]
    else:
        o["trees"] = [tree_dict(t) for t in jm.output["trees"]]
    cm = convert.drf_model(o, response_column=y,
                           response_domain=jm.response_domain)
    jp, pp = jm.predict(jf), cm.predict(pf)
    assert pp.names == jp.names
    for name in pp.names[1:]:
        np.testing.assert_allclose(pp.vec(name).to_numpy(),
                                   jp.vec(name).to_numpy()[:ROWS], atol=1e-6)


# -- the samplers' contracts -------------------------------------------------

def test_bootstrap_weights_are_poisson_counts_of_the_sample_rate():
    gen = torch.Generator().manual_seed(1)
    w = torch.ones(200_000)
    wt = SharedTreeBuilder._row_weights(gen, w, 0.632, bootstrap=True)
    assert torch.equal(wt, wt.round()) and bool((wt >= 0).all())
    # mean 0.632 (sd of the mean 0.0018) and a share 1 - e^-0.632 = 0.4685
    # of rows drawn at least once (sd 0.0011): five-sigma tolerances
    assert abs(float(wt.mean()) - 0.632) < 0.01
    assert abs(float((wt > 0).float().mean()) - (1 - np.exp(-0.632))) < 0.006
    # weights scale the counts; a zero-weight row stays out
    w2 = torch.full((1000,), 2.0)
    w2[:10] = 0.0
    wt2 = SharedTreeBuilder._row_weights(gen, w2, 0.632, bootstrap=True)
    assert bool((wt2[:10] == 0).all()) and bool((wt2 % 2 == 0).all())


def test_row_sampling_keeps_the_sample_rate_share():
    gen = torch.Generator().manual_seed(2)
    w = torch.ones(200_000)
    wt = SharedTreeBuilder._row_weights(gen, w, 0.7, bootstrap=False)
    assert set(wt.unique().tolist()) <= {0.0, 1.0}
    # sd of the share 0.001: five-sigma tolerance
    assert abs(float(wt.mean()) - 0.7) < 0.005
    assert SharedTreeBuilder._row_weights(gen, w, 1.0, False) is w


def test_feature_masks_force_one_feature_and_are_never_empty():
    gen = torch.Generator().manual_seed(3)
    F = 8
    forced = torch.zeros(F)
    for _ in range(400):
        m = SharedTreeBuilder._feat_mask(gen, F, 0.0, torch.device("cpu"))
        assert int(m.sum()) == 1          # rate 0: only the forced feature
        forced += m.float()
    assert bool((forced > 0).all())       # every feature can be the one
    # per tree: the draw never re-enables a banned feature, never empties
    base = torch.zeros(F, dtype=torch.bool)
    base[[2, 5]] = True
    b = DRF()
    for _ in range(200):
        m = b._sample_fmask(gen, base, 0.2)
        assert bool(m.any()) and not bool((m & ~base).any())
    # per level and tree of a class batch: the same contract
    base_k = torch.stack([base, torch.ones(F, dtype=torch.bool)])
    for _ in range(200):
        m = ptree._level_feat_mask(base_k, 0.1, gen)
        assert bool(m.any(1).all()) and not bool((m & ~base_k).any())
    # and a share of about the rate survives (1/8 forced plus 7/8 x 0.5)
    shares = torch.stack([ptree._level_feat_mask(
        torch.ones((1, F), dtype=torch.bool), 0.5, gen)[0].float()
        for _ in range(2000)]).mean()
    assert abs(float(shares) - (1 / 8 + 7 / 8 * 0.5)) < 0.02


def test_one_seed_grows_the_same_forest_twice():
    cols = forest_cols(rows=3000, seed=43)
    fr = Frame.from_arrays(cols)
    x = [c for c in cols if c.startswith("x")]

    def heaps(seed):
        m = DRF(ntrees=3, max_depth=4, seed=seed).train(x=x, y="b",
                                                       training_frame=fr)
        return [getattr(t, k) for t in m.output["trees"] for k in HEAP_FIELDS]

    a, b, c = heaps(7), heaps(7), heaps(8)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(torch.equal(u, v) for u, v in zip(a, c))
