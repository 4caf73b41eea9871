"""TreeSHAP and varimp in the port (h2o3_tpu_torch/genmodel/treeshap.py,
``SharedTreeModel.varimp``, ``contributions`` and
``predict_contributions``) against the JAX reference
(``h2o3_tpu/genmodel/treeshap.py``, ``SharedTreeModel.varimp``) on the same
numpy-seeded inputs.

The reference's trees are carried into the port through convert.py, so
both packages explain the same trees. Contributions are float64 sums in
another order (the port merges a recurring feature into one path element
and sums paths in one product, the reference unwinds and re-extends):
held at rtol 1e-9, with an absolute floor of 1e-12 x the largest
contribution for values that cancel to near 0. Brute-force Shapley values
(the reference's own test) at the same tolerance. varimp's float64 sums
run in the reference's order: equal to rtol 1e-12.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.genmodel import treeshap as jshap
from h2o3_tpu.models.gbm import DRF as JDRF, GBM as JGBM
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.genmodel import treeshap as pshap
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * max(1.0, np.abs(want).max()))


def numeric_cols(n=2000, F=5, seed=3):
    """Features with missing values, an interaction and a binary and a
    numeric response."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    logit = Z[:, 0] - 0.8 * Z[:, 1] + 0.6 * Z[:, 0] * Z[:, 2]
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "p", "n")
    cols["t"] = (logit + 0.3 * rng.normal(size=n)).astype(np.float32)
    return cols


def cat_cols(n=2000, card=9, seed=4):
    """A categorical whose predictive levels interleave in code order (a
    group split separates them), a numeric feature with missing values."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, card, size=n)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.05] = np.nan
    p = np.clip(np.where(codes % 2 == 0, 0.8, 0.25)
                + 0.15 * np.nan_to_num(x), 0, 1)
    return {"c": np.array([f"lv{i}" for i in range(card)], dtype=object)[codes],
            "x": x, "z": rng.normal(size=n).astype(np.float32),
            "y": np.where(rng.random(n) < p, "p", "n")}


def _tree_dict(t):
    d = {k: np.asarray(getattr(t, k)) for k in HEAP_FIELDS}
    if t.left_mask is not None:
        d["left_mask"] = np.asarray(t.left_mask)
    return d


def _carried(jm, kind):
    """The reference model in the port (convert.py), on the CPU."""
    o = dict(jm.output, trees=[_tree_dict(t) for t in jm.output["trees"]])
    if o.get("cat_card") is not None:
        o["cat_card"] = np.asarray(o["cat_card"])
    fn = convert.drf_model if kind == "drf" else convert.gbm_model
    return fn(o, response_column="y", response_domain=jm.response_domain,
              device="cpu")


@pytest.fixture(scope="module")
def models():
    num, cat = numeric_cols(), cat_cols()
    x = [f"x{i}" for i in range(5)]
    out = {
        "gbm": (num, JGBM(ntrees=6, max_depth=4, learn_rate=0.3, seed=1)
                .train(x=x, y="y", training_frame=JFrame.from_arrays(num)),
                "gbm"),
        "drf": (num, JDRF(ntrees=4, max_depth=5, seed=2)
                .train(x=x, y="y", training_frame=JFrame.from_arrays(num)),
                "drf"),
        "group_split": (cat, JGBM(ntrees=5, max_depth=4, learn_rate=0.3,
                                  seed=1).train(
            y="y", training_frame=JFrame.from_arrays(cat)), "gbm"),
    }
    return {k: (cols, jm, _carried(jm, kind)) for k, (cols, jm, kind)
            in out.items()}


def _X(model, cols, rows):
    from h2o3_tpu_torch.models.gbm import tree_matrix
    return tree_matrix(Frame.from_arrays({k: v[:rows] for k, v in cols.items()}),
                       model.output["x_cols"], model.output["feat_domains"])


# 300 rows: every path's table (2^L patterns) is read by the rows; 6 rows
# are fewer than a depth-4 or 5 path's patterns, so the rows' own patterns
# run through the same arithmetic
@pytest.mark.parametrize("rows", [300, 6])
@pytest.mark.parametrize("which", ["gbm", "drf", "group_split"])
def test_ensemble_contributions_match_reference(models, which, rows):
    cols, jm, pm = models[which]
    X = _X(pm, cols, rows)
    got = pshap.ensemble_contributions(
        pm.output["trees"], X, cat_card=pm.output.get("cat_card"),
        n_bins=int(pm.output.get("cat_bins") or 0)).numpy()
    want = jshap.ensemble_contributions(
        jm.output["trees"], X.numpy(), cat_card=jm.output.get("cat_card"),
        n_bins=int(jm.output.get("cat_bins") or 0))
    _close(got, want)
    if which == "group_split":
        assert any(t.left_mask is not None for t in pm.output["trees"])


def test_blocks_and_row_chunks_give_the_same_sums(models, monkeypatch):
    """Paths cut into many blocks and rows into many chunks (a tiny
    budget) sum to what one block and one chunk give."""
    cols, _, pm = models["gbm"]
    X = _X(pm, cols, 300)
    whole = pshap.ensemble_contributions(pm.output["trees"], X).numpy()
    monkeypatch.setattr(pshap, "_BLOCK_ENTRIES", 2 ** 9)
    assert len(pshap._blocks(np.array([2, 3, 3, 4, 4, 4]), 300)) > 1
    cut = pshap.ensemble_contributions(pm.output["trees"], X).numpy()
    _close(cut, whole)


def test_one_tree_matches_brute_force_shapley_values():
    """Exact Shapley values by enumeration of feature subsets under the
    tree's cover distribution (the reference's
    ``test_treeshap_matches_bruteforce``), on a tree whose path repeats a
    feature."""
    rng = np.random.default_rng(5)
    n = 600
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 2.0, -1.0) + np.where(X[:, 1] > 0.5, 1.0, 0.0) \
        + np.where(X[:, 0] > 1.0, 1.5, 0.0)
    cols = {f"x{i}": X[:, i] for i in range(3)} | {"y": y.astype(np.float32)}
    m = GBM(ntrees=1, max_depth=3, learn_rate=1.0, min_rows=1.0) \
        .train(y="y", training_frame=Frame.from_arrays(cols))
    tree = m.output["trees"][0]
    feat, tv, nal, isp = (getattr(tree, k).numpy() for k in
                          ("feat", "thresh_val", "na_left", "is_split"))
    leaf = tree.leaf.double().numpy()
    cover = tree.cover.double().numpy()

    def cond_exp(x, known, node=0):
        if not isp[node]:
            return leaf[node]
        d = int(feat[node])
        l, r = 2 * node + 1, 2 * node + 2
        if d in known:
            go_l = nal[node] if np.isnan(x[d]) else x[d] < tv[node]
            return cond_exp(x, known, l if go_l else r)
        wl = cover[l] / max(cover[node], 1e-12)
        return wl * cond_exp(x, known, l) + (1 - wl) * cond_exp(x, known, r)

    rows = X[:8]
    phi = pshap.tree_shap(tree, torch.from_numpy(rows)).numpy()
    assert len({int(f) for f in feat[:7][isp[:7]]}) < int(isp[:7].sum())
    for ri, x in enumerate(rows):
        for j in range(3):
            val = 0.0
            others = [k for k in range(3) if k != j]
            for size in range(3):
                for S in itertools.combinations(others, size):
                    wgt = (math.factorial(len(S)) * math.factorial(2 - len(S))
                           / math.factorial(3))
                    val += wgt * (cond_exp(x, set(S) | {j})
                                  - cond_exp(x, set(S)))
            np.testing.assert_allclose(phi[ri, j], val, rtol=1e-9,
                                       atol=1e-12)


@pytest.mark.parametrize("which", ["gbm", "drf", "group_split"])
def test_predict_contributions_match_reference_and_sum_to_margin(models,
                                                                 which):
    cols, jm, pm = models[which]
    want = jm.predict_contributions(JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    got = pm.predict_contributions(fr)
    assert got.names == want.names and got.names[-1] == "BiasTerm"
    n = fr.nrows
    for name in got.names:
        np.testing.assert_allclose(got.vec(name).to_numpy(),
                                   want.vec(name).to_numpy()[:n], rtol=1e-5,
                                   atol=1e-6)
    # local accuracy: the rows sum to the raw margin (logit for GBM, the
    # class-1 mean for DRF), within float32 rounding of the margin
    phi = pm.contributions(fr).numpy()
    p = pm.predict(fr).vec("pp").to_numpy().astype(np.float64)
    margin = np.log(p / (1 - p)) if which != "drf" else p
    np.testing.assert_allclose(phi.sum(1), margin, rtol=1e-5, atol=1e-5)


def test_contributions_of_port_trained_models_sum_to_margin():
    cols = numeric_cols(seed=8)
    fr = Frame.from_arrays(cols)
    m = GBM(ntrees=5, max_depth=3, distribution="gaussian").train(
        y="t", training_frame=fr)
    phi = m.contributions(fr)
    torch.testing.assert_close(phi.sum(1).float(), m.predict(fr).vec(
        "predict").data, rtol=1e-5, atol=1e-5)
    multi = dict(cols, y=np.array(["a", "b", "c"])[
        np.random.default_rng(1).integers(0, 3, len(cols["t"]))])
    mm = GBM(ntrees=2, max_depth=2).train(y="y",
                                          training_frame=Frame.from_arrays(multi))
    with pytest.raises(ValueError, match="single-tree-set"):
        mm.predict_contributions(fr)


@pytest.mark.parametrize("which", ["gbm", "drf", "group_split"])
def test_varimp_matches_reference(models, which):
    _, jm, pm = models[which]
    want, got = jm.varimp(), pm.varimp()
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got]),
                               np.array([r[1:] for r in want]), rtol=1e-12)
    df = pm.varimp(use_pandas=True)
    assert list(df.columns) == ["variable", "relative_importance",
                                "scaled_importance", "percentage"]
    assert df["percentage"].sum() == pytest.approx(1.0)


def test_varimp_of_a_multinomial_model_counts_every_class_tree():
    cols = numeric_cols(seed=9)
    cols["y"] = np.array(["a", "b", "c"])[
        np.random.default_rng(2).integers(0, 3, len(cols["t"]))]
    cols["y"] = np.where(cols["x0"] > 0.5, "c", cols["y"])
    x = [f"x{i}" for i in range(5)]
    pm = DRF(ntrees=3, max_depth=3, seed=1).train(
        x=x, y="y", training_frame=Frame.from_arrays(cols))
    rows = pm.varimp()
    per_class = np.zeros(5)
    for ts in pm.output["trees_multi"]:
        for t in ts:
            f, g = t.feat.numpy(), t.gain.numpy()
            np.add.at(per_class, f[f >= 0], np.maximum(g[f >= 0], 0.0))
    got = {r[0]: r[1] for r in rows}
    np.testing.assert_allclose([got[c] for c in x], per_class, rtol=1e-12)
    assert rows[0][0] == "x0"
