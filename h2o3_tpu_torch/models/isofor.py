"""Isolation forest and extended isolation forest — the port of
``h2o3_tpu/models/isofor.py``.

Reference: ``hex/tree/isofor/IsolationForest.java`` (random-split trees on
per-tree subsamples; the anomaly score normalised by the least and most
mean path length of the training rows) and
``hex/tree/isoforextended/ExtendedIsolationForest.java`` (random
hyperplane splits, score ``2^(-E[h]/c(psi))``).

The trees grow on the host in numpy from ``np.random.default_rng(seed)``,
the reference's code step for step, so from the same float32 subsample
they equal the reference's bit for bit. The frame is not copied to the
host: the host draws each tree's row positions, the card gathers those
rows, and only they are copied (``sample_size`` x F values a tree).
Scoring runs on the card: axis-parallel trees are dense heaps scored by
:func:`~h2o3_tpu_torch.models.tree.predict_raw` (leaf = path length),
extended trees walk their levels by projecting each row on its node's
normal in float32, feature by feature (the same bits on the CPU and the
card), rows in chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.gbm import tree_matrix
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key
from h2o3_tpu_torch.models.tree import Tree, predict_raw

EULER_GAMMA = 0.5772156649015329
#: float32 entries of one chunk's gathered normals (512 MiB)
_CHUNK_ENTRIES = 2 ** 27


def _avg_path_norm(n):
    """c(n): the expected unsuccessful-search path length in a binary
    search tree of n points."""
    n = np.asarray(n, np.float64)
    c = 2.0 * (np.log(np.maximum(n - 1, 1)) + EULER_GAMMA) \
        - 2.0 * (n - 1) / np.maximum(n, 1)
    return np.where(n > 2, c, np.where(n == 2, 1.0, 0.0))


class IsolationForestModel(Model):
    algo = "isolationforest"

    def _mean_length(self, frame: Frame) -> torch.Tensor:
        X = tree_matrix(frame, self.output["x_cols"],
                        self.output["feat_domains"])
        total = predict_raw(X, self.output["trees"])
        # a tensor divisor: CUDA divides by a host scalar as a product with
        # its reciprocal, a last bit apart from the CPU's quotient
        return total / total.new_full((), max(self.output["ntrees"], 1))

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        return self._mean_length(frame)

    def predict(self, frame: Frame) -> Frame:
        """Columns ``predict`` (the normalised anomaly score) and
        ``mean_length`` (reference: ``IsolationForestModel.score0``)."""
        mean_len = self._mean_length(frame)
        lo, hi = self.output["min_path_length"], self.output["max_path_length"]
        score = torch.clamp((hi - mean_len) / max(hi - lo, 1e-12), 0.0, 1.0)
        return Frame(["predict", "mean_length"],
                     [Vec.from_device(score, VecType.NUM),
                      Vec.from_device(mean_len, VecType.NUM)])

    def model_performance(self, frame: Frame):
        return None


class _IsoForBase(ModelBuilder):
    unsupervised = True
    supports_classification = False

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), ntrees=50, sample_size=256,
                    max_depth=8)

    def _matrix(self, frame: Frame, x: list[str], weights: torch.Tensor):
        """The raw feature matrix on the card, the positions of its rows of
        positive weight (on the card; their count is the one value
        fetched) and the categorical domains."""
        self._refuse_checkpoint()
        X = tree_matrix(frame, x, {})
        valid = torch.nonzero(weights > 0)[:, 0]
        if valid.shape[0] == 0:
            raise ValueError("no rows with positive weight")
        domains = {c: frame.vec(c).domain for c in x
                   if frame.vec(c).is_categorical}
        return X, valid, domains

    @staticmethod
    def _subsample(X: torch.Tensor, valid: torch.Tensor, size: int,
                   rng: np.random.Generator) -> np.ndarray:
        """One tree's rows on the host: ``size`` positions drawn without
        replacement among the valid rows, as the reference's
        ``rng.choice(valid, size, replace=False)`` draws them (the draw
        depends on the count alone), gathered on the card and copied."""
        pos = rng.choice(valid.shape[0], size=size, replace=False)
        rows = valid[torch.as_tensor(pos).to(valid.device)]
        return X[rows].cpu().numpy()


def _grow_iso_tree(Xs: np.ndarray, max_depth: int,
                   rng: np.random.Generator) -> dict:
    """One random-split tree over the subsample, level by level on the
    host (reference ``_grow_iso_tree``); NaNs route to a per-node random
    side. Returns its heap arrays (numpy)."""
    n, F = Xs.shape
    heap = 2 ** (max_depth + 1) - 1
    hf = np.full(heap, -1, np.int32)
    htv = np.zeros(heap, np.float32)
    hna = np.zeros(heap, bool)
    hsp = np.zeros(heap, bool)
    hlf = np.zeros(heap, np.float32)
    node = np.zeros(n, np.int64)  # heap position per row; -1 = frozen
    for d in range(max_depth + 1):
        off = 2 ** d - 1
        N = 2 ** d
        live = node >= 0
        if not live.any():
            break
        ids = np.where(live, node - off, 0)
        counts = np.bincount(ids[live], minlength=N)
        if d == max_depth:
            hlf[off:off + N] = d + _avg_path_norm(counts)
            break
        feats = rng.integers(0, F, N)
        fv = Xs[np.arange(n), feats[ids]]
        fv_ok = live & ~np.isnan(fv)
        big = np.where(fv_ok, fv, np.inf)
        small = np.where(fv_ok, fv, -np.inf)
        mins = np.full(N, np.inf)
        maxs = np.full(N, -np.inf)
        np.minimum.at(mins, ids[live], big[live])
        np.maximum.at(maxs, ids[live], small[live])
        can = (counts > 1) & np.isfinite(mins) & np.isfinite(maxs) \
            & (maxs > mins)
        lo = np.where(can, mins, 0.0)
        hi = np.where(can, maxs, 0.0)
        thr = (rng.uniform(0, 1, N) * (hi - lo) + lo).astype(np.float32)
        na_left = rng.integers(0, 2, N).astype(bool)
        hf[off:off + N] = np.where(can, feats, -1)
        htv[off:off + N] = thr
        hna[off:off + N] = na_left
        hsp[off:off + N] = can
        hlf[off:off + N] = np.where(can, 0.0, d + _avg_path_norm(counts))
        # rows of splitting nodes go on to their children
        go = live & can[ids]
        left = np.where(np.isnan(fv), na_left[ids], fv < thr[ids])
        child = (off + ids) * 2 + np.where(left, 1, 2)
        node = np.where(go, child, -1)
    return dict(feat=hf, thresh_val=htv, na_left=hna, is_split=hsp, leaf=hlf)


def iso_tree(heap: dict, device) -> Tree:
    """A Tree of the heap arrays of :func:`_grow_iso_tree` on ``device``."""
    t = lambda k: torch.as_tensor(heap[k]).to(device)
    return Tree(feat=t("feat"), thresh_bin=torch.zeros_like(t("feat")),
                thresh_val=t("thresh_val"), na_left=t("na_left"),
                is_split=t("is_split"), leaf=t("leaf"))


class IsolationForest(_IsoForBase):
    """h2o-py surface: ``H2OIsolationForestEstimator``."""

    algo = "isolationforest"

    def _fit(self, job: Job, frame: Frame, x, y,
             weights) -> IsolationForestModel:
        p = self.params
        X, valid, domains = self._matrix(frame, x, weights)
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xC0FFEE
        rng = np.random.default_rng(seed)
        ntrees = int(p["ntrees"])
        size = min(int(p["sample_size"]), valid.shape[0])
        trees: list[Tree] = []
        for m in range(ntrees):
            Xs = self._subsample(X, valid, size, rng)
            trees.append(iso_tree(_grow_iso_tree(Xs, int(p["max_depth"]),
                                                 rng), X.device))
            job.update((m + 1) / ntrees, f"tree {m + 1}/{ntrees}")
        model = IsolationForestModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=None, response_domain=None,
            output=dict(trees=trees, ntrees=len(trees), x_cols=list(x),
                        feat_domains=domains, min_path_length=0.0,
                        max_path_length=1.0))
        # the training rows' path-length range normalises the score
        # (reference: the IsolationForest driver's min/max path length)
        mean_len = model._mean_length(frame)[valid]
        lo, hi = torch.stack([mean_len.min(), mean_len.max()]).tolist()
        model.output.update(min_path_length=lo, max_path_length=hi)
        return model


# -- extended isolation forest ---------------------------------------------

class ExtendedIsolationForestModel(Model):
    algo = "extendedisolationforest"

    def _mean_length(self, frame: Frame) -> torch.Tensor:
        X = torch.nan_to_num(tree_matrix(frame, self.output["x_cols"],
                                         self.output["feat_domains"]))
        o = self.output
        return eif_path_lengths(X, o["normals"], o["offsets"], o["is_split"],
                                o["leaf"]) / max(o["ntrees"], 1)

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        return self._mean_length(frame)

    def predict(self, frame: Frame) -> Frame:
        """Columns ``anomaly_score`` (2^(-E[h]/c(psi))) and ``mean_length``
        (reference: ``ExtendedIsolationForestModel.score0``)."""
        mean_len = self._mean_length(frame)
        score = torch.exp2(-mean_len / max(self.output["cn"], 1e-12))
        return Frame(["anomaly_score", "mean_length"],
                     [Vec.from_device(score, VecType.NUM),
                      Vec.from_device(mean_len, VecType.NUM)])

    def model_performance(self, frame: Frame):
        return None


def eif_path_lengths(X: torch.Tensor, normals: torch.Tensor,
                     offsets: torch.Tensor, is_split: torch.Tensor,
                     leaf: torch.Tensor) -> torch.Tensor:
    """Sum over the trees of each row's path length (float32): X [rows, F]
    float32 without NaN, normals [T, heap, F], offsets, is_split and leaf
    [T, heap] (reference ``_eif_path_lengths``). Each level gathers every
    row's node normal and projects the row on it in float32, feature by
    feature as separately rounded products and sums: the same bits on the
    CPU and the card, so both send every row to the same side."""
    rows, F = X.shape
    T, H = offsets.shape
    depth = int(np.log2(H + 1)) - 1
    acc = torch.zeros(rows, dtype=torch.float32, device=X.device)
    chunk = max(1, _CHUNK_ENTRIES // max(F, 1))
    nvT = normals.transpose(1, 2).contiguous()            # [T, F, heap]
    for r0 in range(0, rows, chunk):
        XT = X[r0:r0 + chunk].T.contiguous()              # [F, chunk]
        part = torch.zeros(XT.shape[1], dtype=torch.float32, device=X.device)
        for t in range(T):
            idx = torch.zeros(XT.shape[1], dtype=torch.long, device=X.device)
            for _ in range(depth):
                nv = nvT[t][:, idx]                       # [F, chunk]
                proj = XT[0] * nv[0]
                for f in range(1, F):
                    proj = proj + XT[f] * nv[f]
                proj = proj - offsets[t][idx]
                nxt = idx * 2 + torch.where(proj <= 0, 1, 2)
                idx = torch.where(is_split[t][idx], nxt, idx)
            part = part + leaf[t][idx]
        acc[r0:r0 + chunk] = part
    return acc


def _grow_eif_tree(Xs: np.ndarray, max_depth: int, ext_level: int,
                   rng: np.random.Generator):
    """One extended tree: at each node a random hyperplane, its normal with
    ``ext_level + 1`` nonzero coordinates, its intercept uniform in the
    node's bounding box (reference ``_grow_eif_tree``)."""
    n, F = Xs.shape
    heap = 2 ** (max_depth + 1) - 1
    normals = np.zeros((heap, F), np.float32)
    offsets = np.zeros(heap, np.float32)
    hsp = np.zeros(heap, bool)
    hlf = np.zeros(heap, np.float32)
    node = np.zeros(n, np.int64)
    for d in range(max_depth + 1):
        off = 2 ** d - 1
        N = 2 ** d
        live = node >= 0
        if not live.any():
            break
        ids = np.where(live, node - off, 0)
        counts = np.bincount(ids[live], minlength=N)
        if d == max_depth:
            hlf[off:off + N] = d + _avg_path_norm(counts)
            break
        # each node's bounding box
        mins = np.full((N, F), np.inf)
        maxs = np.full((N, F), -np.inf)
        np.minimum.at(mins, ids[live], Xs[live])
        np.maximum.at(maxs, ids[live], Xs[live])
        can = counts > 1
        # normals: N(0, 1) with F - 1 - ext_level coordinates zeroed
        nv = rng.normal(size=(N, F)).astype(np.float32)
        keep = np.argsort(rng.uniform(size=(N, F)), axis=1) <= ext_level
        nv = nv * keep
        box = np.where(np.isfinite(mins) & np.isfinite(maxs), maxs - mins, 0.0)
        p = np.where(np.isfinite(mins), mins, 0.0) \
            + rng.uniform(size=(N, F)) * box
        ofs = np.einsum("nf,nf->n", nv, p).astype(np.float32)
        normals[off:off + N] = np.where(can[:, None], nv, 0.0)
        offsets[off:off + N] = np.where(can, ofs, 0.0)
        hsp[off:off + N] = can
        hlf[off:off + N] = np.where(can, 0.0, d + _avg_path_norm(counts))
        proj = np.einsum("rf,rf->r", Xs, nv[ids]) - ofs[ids]
        go = live & can[ids]
        child = (off + ids) * 2 + np.where(proj <= 0, 1, 2)
        node = np.where(go, child, -1)
    return normals, offsets, hsp, hlf


class ExtendedIsolationForest(_IsoForBase):
    """h2o-py surface: ``H2OExtendedIsolationForestEstimator``."""

    algo = "extendedisolationforest"

    @classmethod
    def defaults(cls) -> dict:
        d = dict(super().defaults(), extension_level=0)
        d["ntrees"] = 100
        # the reference EIF has no max_depth: it is ceil(log2(sample_size))
        del d["max_depth"]
        return d

    def _fit(self, job: Job, frame: Frame, x, y,
             weights) -> ExtendedIsolationForestModel:
        p = self.params
        X, valid, domains = self._matrix(frame, x, weights)
        X = torch.nan_to_num(X)
        F = X.shape[1]
        ext = int(p["extension_level"])
        if not 0 <= ext <= F - 1:
            raise ValueError(f"extension_level must be in [0, {F - 1}]")
        sample_size = min(int(p["sample_size"]), valid.shape[0])
        max_depth = int(np.ceil(np.log2(max(sample_size, 2))))
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xC0FFEE
        rng = np.random.default_rng(seed)
        ntrees = int(p["ntrees"])
        parts = []
        for m in range(ntrees):
            Xs = self._subsample(X, valid, sample_size, rng)
            parts.append(_grow_eif_tree(Xs, max_depth, ext, rng))
            job.update((m + 1) / ntrees, f"tree {m + 1}/{ntrees}")
        dev = X.device
        stack = lambda i: torch.as_tensor(np.stack([t[i] for t in parts])
                                          ).to(dev)
        return ExtendedIsolationForestModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=None, response_domain=None,
            output=dict(normals=stack(0), offsets=stack(1),
                        is_split=stack(2), leaf=stack(3), ntrees=ntrees,
                        x_cols=list(x), feat_domains=domains,
                        cn=float(_avg_path_norm(sample_size))))
