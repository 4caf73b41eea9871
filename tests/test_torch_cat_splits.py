"""Categorical group splits in the port (h2o3_tpu_torch/models/tree.py:
``_find_splits`` with ``cat_feats``, the masked traversals,
``cat_bins_for_codes``; models/gbm.py: the categorical binning and the
domain remap at scoring; convert.py: group-split models) against the JAX
reference on the same numpy-seeded inputs (mirrors tests/test_cat_splits.py);
the DRF, class-batch and range-grouping cases are in
tests/test_torch_cat_splits_drf.py.

Split choices, masks and integer heap fields are held exactly; float
outputs within rtol 1e-5 (the reference's level histograms are float32
partial sums over tests/conftest.py's 8 virtual devices, the port's one
``index_add_``), predictions within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import tree as jtree
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import tree as ptree
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from jax_reference import _jax_compile_cache  # noqa: F401

SPLIT_KEYS = ("feat", "thresh_bin", "na_left", "is_split")


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def interleaved(rng, n=2000, card=8):
    """A categorical whose predictive levels interleave with the others in
    code order (one group split separates them, no threshold does), a
    numeric feature with missing values, and a binary response."""
    codes = rng.integers(0, card, size=n)
    p = np.where(codes % 2 == 0, 0.85, 0.2)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.05] = np.nan
    y = rng.random(n) < np.clip(p + 0.1 * np.nan_to_num(x), 0, 1)
    return {"c": np.array([f"lv{i:02d}" for i in range(card)],
                          dtype=object)[codes],
            "x": x, "y": np.array(["no", "yes"], dtype=object)[y.astype(int)]}


def _hists(seed, F, N, B, cat_ties=False):
    """Random level histograms [F, N*(B+1), 3]: integer-valued stats (exact
    in float32 either way), some empty bins (w = 0) and, with
    ``cat_ties``, bins whose G/H ratios tie."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 40, size=(F, N, B + 1)).astype(np.float32)
    w[rng.random(w.shape) < 0.2] = 0.0
    h = w.copy()
    g = np.round(rng.normal(size=w.shape) * w * 0.5)
    if cat_ties:
        # every bin's G/H is one of three values
        g = np.round(rng.choice([-0.5, 0.25, 1.0], size=w.shape) * h)
    g = np.where(w > 0, g, 0.0).astype(np.float32)
    return np.stack([g, h, w], -1).reshape(F, N * (B + 1), 3)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_find_splits_with_cat_feats_matches_reference(ties, masked):
    """The split search with group splits on some features: the same split,
    direction, threshold rank and left-membership mask at every node,
    including bins that tie on G/H (stable order: bin order) and empty bins
    (ranked last)."""
    F, N, B = 5, 6, 12
    hists = _hists(3, F, N, B, cat_ties=ties)
    cat = np.array([True, False, True, True, False])
    fmask = np.ones(F, bool)
    if masked:
        fmask[2] = False
    hp = (2.0, 1.0, 0.0, 0.0)
    want = jtree._find_splits(jnp.asarray(hists), B, *hp, jnp.asarray(fmask),
                              cat_feats=jnp.asarray(cat))
    got = ptree._find_splits(_t(hists), B, *hp, _t(fmask),
                             cat_feats=_t(cat))
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"output {i}")
    # some chosen split is a group split whose left bins are not a prefix
    member, feat = got[-1].numpy(), got[1].numpy()
    grouped = [n for n in range(N) if cat[feat[n]]
               and not np.array_equal(member[n],
                                      np.arange(B) < got[2].numpy()[n])]
    assert grouped


@pytest.mark.parametrize("card,n_bins", [(8, 16), (40, 8), (300, 64),
                                         (64, 64), (65, 64)])
def test_cat_bins_for_codes_matches_reference(card, n_bins):
    """Codes to bins: the code where the cardinality fits, ranges of code x
    n_bins // card above it; missing codes read 0 (the NA bin is set by
    the caller)."""
    rng = np.random.default_rng(card)
    X = rng.integers(0, card, size=(500, 2)).astype(np.float32)
    X[:5, 0] = np.nan
    cc = np.array([card, 0], np.int32)
    want = np.asarray(jtree.cat_bins_for_codes(jnp.asarray(X),
                                               jnp.asarray(cc), n_bins))
    got = ptree.cat_bins_for_codes(_t(X), _t(cc), n_bins).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].max() < min(card, n_bins) or card > n_bins


def _heaps_alike(jtrees, ptrees, masks=True):
    for i, (a, b) in enumerate(zip(jtrees, ptrees)):
        for k in SPLIT_KEYS:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"tree {i} {k}")
        if masks:
            np.testing.assert_array_equal(b.left_mask.numpy(),
                                          np.asarray(a.left_mask),
                                          err_msg=f"tree {i} left_mask")
        np.testing.assert_allclose(b.leaf.numpy(), np.asarray(a.leaf),
                                   rtol=1e-4, atol=1e-5, err_msg=f"tree {i}")


@pytest.fixture(scope="module")
def gbm_pair():
    cols = interleaved(np.random.default_rng(5), n=3000, card=12)
    kw = dict(ntrees=4, max_depth=4, nbins=16, learn_rate=0.2, seed=3)
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    pm = GBM(**kw).train(y="y", training_frame=fr)
    return cols, jm, pm, fr


def test_gbm_group_split_trees_equal_the_reference(gbm_pair):
    cols, jm, pm, fr = gbm_pair
    assert pm.output["trees"][0].left_mask is not None
    np.testing.assert_array_equal(pm.output["cat_card"].numpy(),
                                  np.asarray(jm.output["cat_card"]))
    assert pm.output["cat_bins"] == int(jm.output["cat_bins"]) == 16
    _heaps_alike(jm.output["trees"], pm.output["trees"])
    want = jm.predict(JFrame.from_arrays(cols)).vec("pyes").to_numpy()
    got = pm.predict(fr).vec("pyes").to_numpy()
    np.testing.assert_allclose(got, want[: len(got)], rtol=1e-5, atol=1e-6)
    # the binned (training) and raw (scoring) traversals agree
    assert abs(pm.training_metrics.auc
               - pm.model_performance(fr).auc) < 1e-6
    assert pm.training_metrics.auc > 0.8


def test_ordinal_encoding_keeps_threshold_splits(gbm_pair):
    cols = gbm_pair[0]
    kw = dict(ntrees=2, max_depth=3, nbins=16, seed=3,
              categorical_encoding="ordinal")
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    assert pm.output["trees"][0].left_mask is None
    assert "cat_card" not in pm.output
    _heaps_alike(jm.output["trees"], pm.output["trees"], masks=False)
    with pytest.raises(ValueError, match="categorical_encoding"):
        GBM(categorical_encoding="one_hot").train(
            y="y", training_frame=Frame.from_arrays(cols))


def _tree_dict(t):
    d = {k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
    d["left_mask"] = np.asarray(t.left_mask)
    return d


def test_reference_group_split_model_scores_through_convert(gbm_pair):
    """A JAX-trained group-split GBM carried into the port scores as the
    reference does, also on a frame whose categorical domain differs (a
    subset in another order, and a level the training never saw)."""
    cols, jm, _, _ = gbm_pair
    o = jm.output
    out = dict(trees=[_tree_dict(t) for t in o["trees"]],
               edges=np.asarray(o["edges"]), f0=o["f0"],
               learn_rate=o["learn_rate"], distribution=o["distribution"],
               x_cols=o["x_cols"], feat_domains=o["feat_domains"],
               ntrees=o["ntrees"], cat_card=np.asarray(o["cat_card"]),
               cat_bins=o["cat_bins"])
    cm = convert.gbm_model(out, response_column="y",
                           response_domain=jm.response_domain, device="cpu")
    rng = np.random.default_rng(23)
    n = 400
    levels = np.array(["lv09", "zz_new", "lv03", "lv00", "lv05"],
                      dtype=object)
    other = {"c": levels[rng.integers(0, 5, n)],
             "x": rng.normal(size=n).astype(np.float32),
             "y": np.array(["no", "yes"], dtype=object)[rng.integers(0, 2, n)]}
    for frame_cols in (cols, other):
        want = jm.predict(JFrame.from_arrays(frame_cols)).vec(
            "pyes").to_numpy()
        got = cm.predict(Frame.from_arrays(frame_cols)).vec(
            "pyes").to_numpy()
        np.testing.assert_allclose(got, want[: len(got)], rtol=1e-5,
                                   atol=1e-6)


def test_scoring_frame_with_another_domain_remaps_codes(gbm_pair):
    """The port's own model on a frame with another domain: a row scores as
    the same row in the training domain, and an unseen level as missing."""
    cols, _, pm, _ = gbm_pair
    rows = 200
    sub = {k: v[:rows] for k, v in cols.items()}
    base = pm.predict(Frame.from_arrays(sub)).vec("pyes").to_numpy()
    # drop one level from the data: the domain shrinks and codes shift
    keep = sub["c"] != "lv00"
    shifted = {k: v[keep] for k, v in sub.items()}
    got = pm.predict(Frame.from_arrays(shifted)).vec("pyes").to_numpy()
    np.testing.assert_allclose(got, base[keep], rtol=1e-6)
    unseen = dict(sub, c=np.where(sub["c"] == "lv00", "never", sub["c"]))
    as_na = dict(sub, c=np.where(sub["c"] == "lv00", None, sub["c"]))
    np.testing.assert_allclose(
        pm.predict(Frame.from_arrays(unseen)).vec("pyes").to_numpy(),
        pm.predict(Frame.from_arrays(as_na)).vec("pyes").to_numpy(),
        rtol=1e-6)
