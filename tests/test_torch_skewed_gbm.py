"""The port's GBM on skewed stats with the fixed kernel's arithmetic: the
level histograms of h2o3_tpu_torch/models/tree.py taken from
``hist.level_histograms_fixed_plain`` (the fixed kernel's bit-exact
emulation) at the plan's qbits, as on the card, against the plain float32
path of the CPU. A few outlier rows (a gradient of 1e4, weights of 1e3)
once coarsened every row's quantisation step, and trees split otherwise
than on either float path; with the two-tier scale every split node must
match."""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import tree as ptree
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.ops import hist

ROWS = 200_000
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


def skewed_cols(case, rows=ROWS):
    """28 normal features from default_rng(11) and the case's response:
    (a) gaussian, y = x0 + 0.5 x1^2 + 0.3 N(0, 1) with 5 rows at 1e4;
    (b) bernoulli with the logit 1.2 x0 - 0.8 x1 + 0.5 x2 + 0.3 x3 and
    weights uniform in [0.05, 1] with 5 rows at 1e3; (c) (a) without the
    outliers."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((28, rows), dtype=np.float32)
    cols = {f"x{i}": X[i] for i in range(28)}
    logit = np.array([1.2, -0.8, 0.5, 0.3], np.float32) @ X[:4]
    out = rng.choice(rows, 5, replace=False)
    if case in "ac":
        y = (X[0] + 0.5 * X[1] ** 2
             + 0.3 * rng.normal(size=rows)).astype(np.float32)
        if case == "a":
            y[out] = 1e4
        cols["y"] = y
    else:
        p = 1 / (1 + np.exp(-logit))
        cols["y"] = np.where(rng.random(rows) < p, "s", "b")
        w = rng.uniform(0.05, 1, rows).astype(np.float32)
        w[out] = 1e3
        cols["w"] = w
    return cols


def _fixed_histograms(binned_T, node, g, h, w, n_nodes, n_bins_tot):
    K = node.shape[0] if node.dim() == 2 else 1
    qbits = hist._plan(binned_T.shape[1], binned_T.shape[0], n_nodes,
                       n_bins_tot, binned_T.element_size(), 132, 1, None,
                       K)["qbits"]
    return hist.level_histograms_fixed_plain(binned_T, node, g, h, w,
                                             n_nodes, n_bins_tot, qbits)


@pytest.mark.parametrize("case", ["a", "b", "c"])
def test_fixed_arithmetic_splits_as_the_float_path(case, monkeypatch):
    """Every split node of the fixed arithmetic's trees is the float32
    path's, walking each tree from the root; a node where the float path
    itself ties two candidates exactly (a node of a few rows between empty
    bins) may take either, and its subtree is not compared."""
    cols = skewed_cols(case)
    fr = Frame.from_arrays(cols)
    x = [f"x{i}" for i in range(28)]
    kw = dict(ntrees=3, max_depth=6, nbins=64, learn_rate=0.1, seed=42,
              weights_column="w" if case == "b" else None)
    ties = []
    find = ptree._find_splits

    def recording(hists, n_bins, min_rows, reg_lambda, reg_alpha, gamma,
                  feat_mask, **kw_):
        ties.append(ptree.tied_splits(hists, n_bins, min_rows, reg_lambda,
                                      reg_alpha, gamma, feat_mask, **kw_))
        return find(hists, n_bins, min_rows, reg_lambda, reg_alpha, gamma,
                    feat_mask, **kw_)

    monkeypatch.setattr(ptree, "_find_splits", recording)
    plain = GBM(**kw).train(x=x, y="y", training_frame=fr)
    monkeypatch.setattr(ptree, "_find_splits", find)
    monkeypatch.setattr(ptree, "_histograms", _fixed_histograms)
    fixed = GBM(**kw).train(x=x, y="y", training_frame=fr)
    depth = kw["max_depth"]
    differ, tied = [], []
    for t, (a, b) in enumerate(zip(plain.output["trees"],
                                   fixed.output["trees"])):
        alike = torch.stack([getattr(a, k) == getattr(b, k)
                             for k in SPLIT_KEYS]).all(0)
        todo = [0]
        while todo:
            i = todo.pop()
            d = int(np.log2(i + 1))
            if d >= depth:
                continue
            if not alike[i]:
                (tied if ties[t * depth + d][i - (2 ** d - 1)]
                 else differ).append((t, i))
                continue
            if a.is_split[i]:
                todo += [2 * i + 1, 2 * i + 2]
    assert not differ, (differ, tied)
