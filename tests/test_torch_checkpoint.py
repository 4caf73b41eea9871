"""Checkpoint resume in the port (h2o3_tpu_torch/models/gbm.py:
``_check_checkpoint``, the resumed ``GBM._fit``, ``_fit_multinomial`` and
``DRF._fit``; models/model_base.py: ``checkpoint=``), mirroring
tests/test_checkpoint_segments.py.

The contract (the reference's ``test_gbm_checkpoint_matches_straight_run``):
a run resumed from a checkpoint grows the trees an uninterrupted run grows,
bit for bit — its margins are refolded in the loop's order and each tree's
random numbers come from that tree's own generator. Within the port that
is held exactly, with sampling on too; against the JAX reference (whose
sums differ in the last bits) splits exactly and predictions within rtol
1e-5.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.models.xgboost import XGBoost


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def cols3(seed=0, n=1500):
    """Four numeric features (with missing values), a categorical, and a
    binary, a 3-class and a numeric response."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.random((n, 4)) < 0.03] = np.nan
    c = rng.integers(0, 6, n)
    z = np.nan_to_num(X[:, 0]) - 0.6 * np.nan_to_num(X[:, 1]) + 0.4 * (c % 2)
    return {**{f"x{i}": X[:, i] for i in range(4)},
            "c": np.array(list("uvwxyz"), dtype=object)[c],
            "b": np.where(rng.random(n) < 1 / (1 + np.exp(-2 * z)), "s", "n"),
            "k": np.array(["p", "q", "r"], dtype=object)[
                np.digitize(z + rng.normal(scale=0.7, size=n), [-0.5, 0.5])],
            "t": (z + 0.3 * rng.normal(size=n)).astype(np.float32)}


def _tree_sets(m):
    out = m.output
    return out["trees_multi"] if "trees_multi" in out else [out["trees"]]


def _bitwise_equal(a, b):
    """Every heap field (and left mask) of every tree, bit for bit."""
    sa, sb = _tree_sets(a), _tree_sets(b)
    assert [len(s) for s in sa] == [len(s) for s in sb]
    for ta, tb in zip(sa, sb):
        for i, (x, y) in enumerate(zip(ta, tb)):
            for f in HEAP_FIELDS + ("left_mask",):
                u, v = getattr(x, f), getattr(y, f)
                assert (u is None) == (v is None), (i, f)
                if u is not None:
                    assert torch.equal(u, v), (i, f)


CASES = {
    "binomial": (GBM, "b", dict(max_depth=3, seed=5)),
    "sampled": (GBM, "b", dict(max_depth=3, seed=6, sample_rate=0.7,
                               col_sample_rate=0.6,
                               col_sample_rate_per_tree=0.8)),
    "multinomial": (GBM, "k", dict(max_depth=3, seed=7, nbins=16,
                                   sample_rate=0.8)),
    "gaussian": (GBM, "t", dict(max_depth=3, seed=8)),
    "xgboost": (XGBoost, "b", dict(max_depth=3, seed=9, max_bin=32,
                                   subsample=0.8)),
    "drf": (DRF, "b", dict(max_depth=5, seed=10)),
    "drf double trees": (DRF, "b", dict(max_depth=5, seed=11,
                                        binomial_double_trees=True)),
    "drf multinomial": (DRF, "k", dict(max_depth=5, seed=12)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_run_equals_the_straight_run_bit_for_bit(case):
    cls, y, kw = CASES[case]
    fr = Frame.from_arrays(cols3())
    straight = cls(ntrees=8, **kw).train(y=y, training_frame=fr)
    half = cls(ntrees=4, **kw).train(y=y, training_frame=fr)
    resumed = cls(ntrees=8, checkpoint=half, **kw).train(y=y,
                                                         training_frame=fr)
    _bitwise_equal(straight, resumed)
    assert resumed.output["ntrees"] == 8
    mets = [m.training_metrics for m in (straight, resumed)]
    for k in ("auc", "logloss", "mse"):
        if hasattr(mets[0], k):
            assert getattr(mets[0], k) == getattr(mets[1], k), k
    # the parameters keep the checkpoint's key, not its trees
    assert resumed.params["checkpoint"] == half.key


def test_resume_with_a_validation_frame_and_stopping_equals_straight():
    cols, vcols = cols3(1), cols3(2, 600)
    kw = dict(max_depth=3, learn_rate=0.3, seed=13, stopping_rounds=3,
              stopping_tolerance=1e-9)
    fr, vf = Frame.from_arrays(cols), Frame.from_arrays(vcols)
    straight = GBM(ntrees=10, **kw).train(y="b", training_frame=fr,
                                          validation_frame=vf)
    half = GBM(ntrees=5, **kw).train(y="b", training_frame=fr,
                                     validation_frame=vf)
    resumed = GBM(ntrees=10, checkpoint=half, **kw).train(
        y="b", training_frame=fr, validation_frame=vf)
    _bitwise_equal(straight, resumed)
    # the resumed series covers the new trees, scored on margins that
    # include the checkpoint's trees
    sv = [r[-1] for r in straight.scoring_history[1]]
    rv = [r[-1] for r in resumed.scoring_history[1]]
    np.testing.assert_allclose(rv, sv[5:], rtol=1e-5)


def _tree_dict(t):
    return {k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}


def test_reference_checkpoint_resumes_in_the_port():
    """A 4-tree model trained by the JAX package, carried over by
    convert.py, resumed in the port to 8 trees: the same splits as the
    reference's own resume; and the reference's resumed model scores in
    the port as it does in the reference."""
    cols = cols3(3)
    x = [f"x{i}" for i in range(4)]
    kw = dict(max_depth=3, seed=14, nbins=32)
    jf = JFrame.from_arrays(cols)
    jhalf = JGBM(ntrees=4, **kw).train(x=x, y="b", training_frame=jf)
    jres = JGBM(ntrees=8, checkpoint=jhalf, **kw).train(x=x, y="b",
                                                        training_frame=jf)

    def carried(jm):
        o = jm.output
        out = dict(trees=[_tree_dict(t) for t in o["trees"]],
                   edges=np.asarray(o["edges"]), f0=o["f0"],
                   learn_rate=o["learn_rate"],
                   distribution=o["distribution"], x_cols=o["x_cols"],
                   feat_domains=o["feat_domains"], ntrees=o["ntrees"])
        return convert.gbm_model(out, response_column="b",
                                 response_domain=jm.response_domain,
                                 params=dict(kw, learn_rate=0.1, ntrees=4),
                                 device="cpu")

    fr = Frame.from_arrays(cols)
    pres = GBM(ntrees=8, checkpoint=carried(jhalf), **kw).train(
        x=x, y="b", training_frame=fr)
    for a, b in zip(jres.output["trees"], pres.output["trees"]):
        for k in ("feat", "thresh_bin", "na_left", "is_split"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)))
    want = jres.predict(jf).vec("ps").to_numpy()[: fr.nrows]
    got = carried(jres).predict(fr).vec("ps").to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_every_immutability_check_raises():
    cols = cols3(4, 500)
    fr = Frame.from_arrays(cols)
    kw = dict(max_depth=3, seed=15)
    feats = ["x0", "x1", "x2", "x3", "c"]
    half = GBM(ntrees=3, **kw).train(x=feats, y="b", training_frame=fr)

    def resume(**over):
        p = dict(kw, ntrees=6, checkpoint=half)
        p.update(over)
        y = p.pop("y", "b")
        x = p.pop("x", feats)
        cls = p.pop("cls", GBM)
        return cls(**p).train(x=x, y=y, training_frame=fr)

    with pytest.raises(ValueError, match="ntrees must exceed"):
        resume(ntrees=3)
    with pytest.raises(ValueError, match="max_depth"):
        resume(max_depth=4)
    with pytest.raises(ValueError, match="nbins"):
        resume(nbins=32)
    with pytest.raises(ValueError, match="learn_rate"):
        resume(learn_rate=0.2)
    with pytest.raises(ValueError, match="feature columns"):
        resume(x=["x0", "x1"])
    with pytest.raises(ValueError, match="categorical encoding"):
        resume(categorical_encoding="ordinal")
    with pytest.raises(ValueError, match="nbins_cats"):
        resume(nbins_cats=4)
    with pytest.raises(ValueError, match="distribution"):
        resume(y="t")
    with pytest.raises(ValueError, match="is a 'gbm' model"):
        resume(cls=DRF)
    with pytest.raises(ValueError, match="not found in DKV"):
        resume(checkpoint="gbm_some_key")
    single = DRF(ntrees=2, **kw).train(y="b", training_frame=fr)
    double = DRF(ntrees=2, binomial_double_trees=True, **kw).train(
        y="b", training_frame=fr)
    with pytest.raises(ValueError, match="without binomial_double_trees"):
        DRF(ntrees=4, binomial_double_trees=True, checkpoint=single,
            **kw).train(y="b", training_frame=fr)
    with pytest.raises(ValueError, match="with binomial_double_trees"):
        DRF(ntrees=4, checkpoint=double, **kw).train(y="b", training_frame=fr)
    # DART renormalises prior trees: it cannot resume (the reference's
    # refusal)
    xgb = XGBoost(ntrees=2).train(y="b", training_frame=fr)
    with pytest.raises(ValueError, match="dart"):
        XGBoost(ntrees=4, booster="dart", checkpoint=xgb).train(
            y="b", training_frame=fr)
