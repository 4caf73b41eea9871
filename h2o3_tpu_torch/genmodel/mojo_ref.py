"""Reference-format MOJO importer: real H2O-3 ``.zip`` MOJOs — the port of
``h2o3_tpu/genmodel/mojo_ref.py``.

H2O-3 users arrive with MOJO zips made by ``model.download_mojo()``; this
module reads that format, so that ``import_mojo`` and ``Generic`` take
them. Families: GBM, DRF, IsolationForest (tree bytecode >= 1.20), GLM,
K-means and StackedEnsemble (nested submodels); the long tail is in
:mod:`~h2o3_tpu_torch.genmodel.mojo_ref2`. Format provenance (a
from-scratch Python reader of the documented layout):

- ``model.ini`` grammar: ``hex/genmodel/ModelMojoReader.java:286-333``
  ([info] key=value, [columns] one per line, [domains] ``idx: card file``).
- tree bytecode: ``hex/genmodel/algos/tree/SharedTreeMojoModel.java:134-250``
  (the ScoreTree2 walker: nodeType/colId/naSplitDir headers, sized left
  subtree skips, inline leaf floats) with bitset splits per
  ``hex/genmodel/utils/GenmodelBitSet.java:57-69`` (fill2/fill3) and
  little-endian scalars per ``hex/genmodel/utils/ByteBufferWrapper.java``.
- NA routing codes: ``hex/genmodel/algos/tree/NaSplitDir.java``
  (NAvsREST=1, NALeft=2, NARight=3, Left=4, Right=5).
- tree file layout + per-class grouping: ``SharedTreeMojoReader.java:13-60``
  (``trees/t{class:02d}_{group:03d}.bin``), index =
  ``class * n_groups + group`` (``SharedTreeMojoModel.java:952``).
- GBM assembly: ``GbmMojoReader.java`` (distribution/init_f/link) and
  ``GbmMojoModel.java:37-66`` (unifyPreds: linkInv for bernoulli/regression,
  softmax rescale for multinomial).
- DRF assembly: ``DrfMojoModel.java:31-62`` (average over groups; binomial
  single-tree complement; multinomial vote normalization).
- GLM scoring: ``GlmMojoModel.java:26-78`` (mean imputation, catOffsets
  one-hot indexing, beta layout cats|nums|intercept, link inverse).

Only MOJO versions >= 1.20 use this tree bytecode (ScoreTree2); older
artifacts raise. Each compressed tree is decoded once, at import, into
node tables, and a frame is scored by float64 numpy on the host (a
recursive partition of the rows), as the JAX package scores it;
``_score_raw`` hands the scores to the frame's device as float32. Moving
the walk onto the card is ROADMAP work.
"""

from __future__ import annotations

import io
import struct
import zipfile

import numpy as np
import torch

__all__ = ["is_reference_mojo", "load_ref_mojo"]

# NaSplitDir values (NaSplitDir.java)
_NA_VS_REST = 1
_NA_LEFT = 2
_LEFT = 4


# -- model.ini ---------------------------------------------------------------

def _parse_ini(text: str):
    """(info: dict[str,str], columns: list[str], domain_files: {col: fname})."""
    info: dict = {}
    columns: list[str] = []
    domain_files: dict[int, tuple[int, str]] = {}
    section = 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[info]":
            section = 1
        elif line == "[columns]":
            section = 2
        elif line == "[domains]":
            section = 3
        elif section == 1:
            k, _, v = line.partition("=")
            info[k.strip()] = v.strip()
        elif section == 2:
            columns.append(line)
        elif section == 3:
            # "7: 2 d000.txt"  (col index: cardinality filename)
            idx, _, rest = line.partition(":")
            card, _, fname = rest.strip().partition(" ")
            domain_files[int(idx)] = (int(card), fname.strip())
    return info, columns, domain_files


def _unescape(s: str) -> str:
    """StringEscapeUtils.unescapeNewlines analog for domain values."""
    return s.replace("\\n", "\n").replace("\\r", "\r").replace("\\\\", "\\") \
        if "\\" in s else s


def _kv(info: dict, key: str, default=None):
    v = info.get(key)
    if v is None or v == "null":
        return default
    return v


def _kv_doubles(info: dict, key: str):
    v = _kv(info, key)
    if v is None:
        return None
    v = v.strip()
    if v.startswith("["):
        v = v[1:-1]
    return np.array([float(x) for x in v.split(",") if x.strip()], np.float64)


# -- compressed tree decode --------------------------------------------------

class _Reader:
    """Little-endian cursor over a tree blob (ByteBufferWrapper.java)."""

    __slots__ = ("b", "p")

    def __init__(self, b: bytes):
        self.b, self.p = b, 0

    def u1(self):
        v = self.b[self.p]
        self.p += 1
        return v

    def u2(self):
        v = self.b[self.p] | (self.b[self.p + 1] << 8)
        self.p += 2
        return v

    def u3(self):
        v = self.b[self.p] | (self.b[self.p + 1] << 8) | (self.b[self.p + 2] << 16)
        self.p += 3
        return v

    def i4(self):
        (v,) = struct.unpack_from("<i", self.b, self.p)
        self.p += 4
        return v

    def f4(self):
        (v,) = struct.unpack_from("<f", self.b, self.p)
        self.p += 4
        return v


class _DecodedTree:
    """Structure-of-arrays decode of one compressed tree."""

    __slots__ = ("col", "split", "left", "right", "leaf", "na_vs_rest",
                 "leftward", "bitset")

    def __init__(self):
        self.col: list[int] = []          # -1 for leaves
        self.split: list[float] = []
        self.left: list[int] = []
        self.right: list[int] = []
        self.leaf: list[float] = []
        self.na_vs_rest: list[bool] = []
        self.leftward: list[bool] = []
        self.bitset: list[tuple | None] = []   # (bitoff, nbits, np.uint8 bytes)

    def _add(self, col, split, leaf, navr, lw, bs) -> int:
        i = len(self.col)
        self.col.append(col)
        self.split.append(split)
        self.left.append(-1)
        self.right.append(-1)
        self.leaf.append(leaf)
        self.na_vs_rest.append(navr)
        self.leftward.append(lw)
        self.bitset.append(bs)
        return i


def _decode_tree(blob: bytes) -> _DecodedTree:
    """Expand the ScoreTree2 bytecode (SharedTreeMojoModel.java:134) into
    node tables, once, at import time."""
    t = _DecodedTree()
    r = _Reader(blob)

    def node() -> int:
        node_type = r.u1()
        col = r.u2()
        if col == 65535:                       # whole tree is a single leaf
            return t._add(-1, np.nan, r.f4(), False, False, None)
        na_dir = r.u1()
        na_vs_rest = na_dir == _NA_VS_REST
        leftward = na_dir in (_NA_LEFT, _LEFT)
        lmask = node_type & 51
        equal = node_type & 12                 # 0 float split, 8/12 bitset
        split_val, bs = np.nan, None
        if not na_vs_rest:
            if equal == 0:
                split_val = r.f4()
            elif equal == 8:                   # fill2: inline 32-bit set
                bs = (0, 32, np.frombuffer(r.b, np.uint8, 4, r.p).copy())
                r.p += 4
            else:                              # fill3: offset + sized set
                bitoff = r.u2()
                nbits = r.i4()
                nbytes = ((nbits - 1) >> 3) + 1
                bs = (bitoff, nbits,
                      np.frombuffer(r.b, np.uint8, nbytes, r.p).copy())
                r.p += nbytes
        me = t._add(col, split_val, np.nan, na_vs_rest, leftward, bs)
        if lmask <= 3:
            r.p += lmask + 1                   # left-subtree byte size: unused
        if lmask & 16:
            t.left[me] = t._add(-1, np.nan, r.f4(), False, False, None)
        else:
            t.left[me] = node()
        rmask = (node_type & 0xC0) >> 2
        if rmask & 16:
            t.right[me] = t._add(-1, np.nan, r.f4(), False, False, None)
        else:
            t.right[me] = node()
        return me

    root = node()
    assert root == 0
    return t


def _score_tree(t: _DecodedTree, X: np.ndarray, domain_len: np.ndarray
                ) -> np.ndarray:
    """Vectorized walk: recursive row partitioning over the decoded nodes.
    Exactly the ScoreTree2 routing ternary (SharedTreeMojoModel.java:215)."""
    n = X.shape[0]
    out = np.zeros(n, np.float64)

    def walk(i: int, rows: np.ndarray) -> None:
        if rows.size == 0:
            return
        if t.col[i] < 0:
            out[rows] = t.leaf[i]
            return
        d = X[rows, t.col[i]]
        iv = np.trunc(d)                      # Java (int)d truncation
        nan_or_out = np.isnan(d)
        bs = t.bitset[i]
        if bs is not None:
            bitoff, nbits, bits = bs
            rel = iv - bitoff
            in_range = (rel >= 0) & (rel < nbits)
            nan_or_out |= ~in_range
        dl = domain_len[t.col[i]]
        if dl >= 0:                           # categorical col: unseen level
            nan_or_out |= ~np.isnan(d) & (iv >= dl)
        if bs is not None:
            rel_c = np.clip(np.nan_to_num(iv - bitoff, nan=0), 0, nbits - 1
                            ).astype(np.int64)
            contains = (bits[rel_c >> 3] >> (rel_c & 7)) & 1
            test = contains.astype(bool)
        elif t.na_vs_rest[i]:
            test = np.zeros(d.shape, bool)    # non-NA always goes left
        else:
            test = d >= t.split[i]
        go_right = np.where(nan_or_out, not t.leftward[i],
                            False if t.na_vs_rest[i] else test)
        walk(t.right[i], rows[go_right])
        walk(t.left[i], rows[~go_right])

    walk(0, np.arange(n))
    return out


# -- link inverses (GbmMojoModel.linkInv / GlmMojoModel link functions) ------

def _default_link(family: str | None) -> str:
    """ModelMojoReader.defaultLinkFunction (ModelMojoReader.java:387)."""
    if family in ("bernoulli", "fractionalbinomial", "quasibinomial",
                  "modified_huber", "ordinal"):
        return "logit"
    if family in ("poisson", "gamma", "tweedie", "negativebinomial"):
        return "log"
    return "identity"


def _link_inv(name: str, f: np.ndarray) -> np.ndarray:
    if name in ("identity", None):
        return f
    if name == "log":
        return np.exp(f)
    if name in ("logit", "ologit"):
        return 1.0 / (1.0 + np.exp(-f))
    if name == "ologlog":
        return 1.0 - np.exp(-np.exp(f))
    if name == "inverse":
        xx = np.where(np.abs(f) < 1e-5, np.where(f < 0, -1e-5, 1e-5), f)
        return 1.0 / xx
    raise ValueError(f"unsupported MOJO link function {name!r}")


# -- imported model wrappers -------------------------------------------------

class _RefModelBase:
    """The surface the ``Generic`` wrapper reads (as the port's own MOJO
    models have it): response_column, response_domain, _score_raw."""

    algo = "ref_mojo"

    def __init__(self, info, columns, domains):
        self.info = info
        self.columns = columns
        self.domains = domains                  # per-column list[str] | None
        self.n_features = int(_kv(info, "n_features"))
        self.nclasses = max(1, int(_kv(info, "n_classes", 1)))
        self.supervised = _kv(info, "supervised") == "true"
        self.response_column = columns[-1] if self.supervised else None
        rd = domains[len(columns) - 1] if self.supervised else None
        self.response_domain = tuple(rd) if rd else None
        thr = _kv(info, "default_threshold")
        self._default_threshold = float(thr) if thr else 0.5

    @property
    def is_classifier(self) -> bool:
        return self.response_domain is not None

    def _design(self, frame) -> np.ndarray:
        """Frame -> (n, n_features) float64 row matrix in MOJO column order.
        CAT columns map through the MOJO's own domain (EasyPredict semantics:
        unseen level behaves as out-of-domain, NA stays NaN)."""
        from h2o3_tpu_torch.frame.types import VecType
        X = np.full((frame.nrows, self.n_features), np.nan, np.float64)
        for j in range(self.n_features):
            name = self.columns[j]
            if name not in frame:
                continue                        # missing column = all NA
            v = frame.vec(name)
            dom = self.domains[j]
            if dom is not None:
                index = {lv: k for k, lv in enumerate(dom)}
                if v.type is VecType.CAT:
                    labels = v.labels()
                else:                           # numeric-coded categories
                    labels = np.array(
                        [None if np.isnan(x) else _fmt_num(x)
                         for x in v.to_numpy().astype(np.float64)],
                        dtype=object)
                col = np.array([np.nan if lv is None
                                else index.get(lv, len(dom)) for lv in labels],
                               np.float64)
            else:
                col = np.asarray(v.to_numpy(), np.float64)[: frame.nrows]
                if v.type is VecType.CAT:       # codes; negative = NA
                    col = np.where(col < 0, np.nan, col)
            X[:, j] = col
        return X

    def _score_raw(self, frame) -> torch.Tensor:
        """Predictions on the frame's device ([rows], or [rows, nclasses]
        probabilities), scored in float64 on the host."""
        raw = self.score(self._design(frame)).astype(np.float32)
        return torch.as_tensor(raw).to(frame.device)

    def predict(self, frame):
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.types import VecType
        from h2o3_tpu_torch.frame.vec import Vec
        raw = self.score(self._design(frame)).astype(np.float32)
        dev = frame.device
        if not self.is_classifier:
            return Frame(["predict"], [Vec.from_numpy(raw, device=dev)])
        if self.nclasses == 2:
            labels = (raw[:, 1] >= self._default_threshold).astype(np.int32)
        else:
            labels = np.argmax(raw, axis=1).astype(np.int32)
        names = ["predict"] + [f"p{d}" for d in self.response_domain]
        vecs = [Vec.from_numpy(labels, type=VecType.CAT,
                               domain=self.response_domain, device=dev)]
        for k in range(raw.shape[1]):
            vecs.append(Vec.from_numpy(raw[:, k], device=dev))
        return Frame(names, vecs)


def _fmt_num(x: float) -> str:
    """Numeric category label formatting: integral floats render as ints
    (matches how the reference parses numeric-looking factor levels)."""
    return str(int(x)) if float(x).is_integer() else str(x)


class RefTreeModel(_RefModelBase):
    """Imported GBM/DRF MOJO (SharedTreeMojoModel + Gbm/Drf unifyPreds)."""

    def __init__(self, info, columns, domains, trees, algo: str):
        super().__init__(info, columns, domains)
        self.algo = algo
        self.n_groups = int(_kv(info, "n_trees"))
        tpc = _kv(info, "n_trees_per_class")
        if tpc is None:
            bdt = _kv(info, "binomial_double_trees") == "true"
            tpc = 1 if (self.nclasses == 2 and not bdt) else self.nclasses
        self.trees_per_group = int(tpc)
        self.trees = trees                      # [class][group] -> tree|None
        self.family = _kv(info, "distribution")
        # link_function first appears in mojo 1.40; older artifacts default
        # by family (ModelMojoReader.readLinkFunction/defaultLinkFunction)
        self.link = _kv(info, "link_function") or _default_link(self.family)
        self.init_f = float(_kv(info, "init_f", 0.0) or 0.0)
        self.binomial_double_trees = _kv(info, "binomial_double_trees") == "true"
        self._domain_len = np.array(
            [len(d) if d is not None else -1 for d in self.domains], np.int64)

    def score(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        sums = np.zeros((n, self.trees_per_group), np.float64)
        for k in range(self.trees_per_group):
            for t in self.trees[k]:
                if t is not None:
                    sums[:, k] += _score_tree(t, X, self._domain_len)
        if self.algo == "drf":
            return self._unify_drf(sums)
        return self._unify_gbm(sums)

    def _unify_gbm(self, sums):
        """GbmMojoModel.unifyPreds (GbmMojoModel.java:43-66)."""
        fam = self.family
        if fam in ("bernoulli", "quasibinomial", "modified_huber"):
            p1 = _link_inv(self.link, sums[:, 0] + self.init_f)
            return np.stack([1.0 - p1, p1], 1)
        if fam == "multinomial":
            z = sums.copy()
            if self.nclasses == 2:              # 1-tree binomial optimization
                z = np.stack([sums[:, 0] + self.init_f,
                              -(sums[:, 0] + self.init_f)], 1)
            z -= z.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        return _link_inv(self.link, sums[:, 0] + self.init_f)   # regression

    def _unify_drf(self, sums):
        """DrfMojoModel.unifyPreds (DrfMojoModel.java:38-62)."""
        if self.nclasses == 1:
            return sums[:, 0] / self.n_groups
        if self.nclasses == 2 and not self.binomial_double_trees:
            p0 = sums[:, 0] / self.n_groups
            return np.stack([p0, 1.0 - p0], 1)
        s = sums.sum(axis=1, keepdims=True)
        return np.where(s > 0, sums / np.where(s == 0, 1, s), sums)


class RefGlmModel(_RefModelBase):
    """Imported GLM MOJO (GlmMojoModelBase + GlmMojoModel.glmScore0)."""

    algo = "glm"

    def __init__(self, info, columns, domains):
        super().__init__(info, columns, domains)
        self.beta = _kv_doubles(info, "beta")
        self.cats = int(_kv(info, "cats", 0))
        self.nums = int(_kv(info, "nums", 0))
        co = _kv_doubles(info, "cat_offsets")
        self.cat_offsets = (co if co is not None else np.zeros(1)
                            ).astype(np.int64)
        self.use_all_levels = _kv(info, "use_all_factor_levels") == "true"
        self.mean_imputation = _kv(info, "mean_imputation") == "true"
        self.num_means = _kv_doubles(info, "num_means")
        self.cat_modes = (_kv_doubles(info, "cat_modes")
                          if _kv(info, "cat_modes") is not None
                          else np.zeros(0)).astype(np.int64)
        self.family = _kv(info, "family")
        self.link = _kv(info, "link", "identity")

    def score(self, X: np.ndarray) -> np.ndarray:
        X = X.copy()
        if self.mean_imputation:                # GlmMojoModelBase.imputeMissingWithMeans
            for i in range(self.cats):
                m = np.isnan(X[:, i])
                X[m, i] = self.cat_modes[i]
            for i in range(self.nums):
                m = np.isnan(X[:, self.cats + i])
                X[m, self.cats + i] = self.num_means[i]
        if self.family == "multinomial":
            return self._score_multinomial(X)
        eta = np.zeros(X.shape[0], np.float64)
        for i in range(self.cats):
            ok, idx = self._cat_beta_index(X, i, len(self.beta))
            eta += np.where(ok, self.beta[idx], 0.0)
        noff = int(self.cat_offsets[self.cats]) - self.cats
        for i in range(self.cats, self.cats + self.nums):
            eta += self.beta[noff + i] * X[:, i]
        eta += self.beta[-1]                    # intercept
        mu = _link_inv("logit" if self.link == "logit" else self.link, eta)
        if self.family in ("binomial", "fractionalbinomial", "quasibinomial"):
            return np.stack([1.0 - mu, mu], 1)
        return mu

    def _cat_beta_index(self, X: np.ndarray, i: int, clip_bound: int):
        """(ok, idx) for categorical column i's beta entry — the ONE copy of
        the decoding rules: Java (int)NaN == 0 (GlmMojoModel.java:40 without
        imputation; numpy NaN->int64 is undefined), level-0 skip without
        use_all_factor_levels, catOffsets shift, upper-bound mask."""
        ival = np.trunc(np.nan_to_num(X[:, i], nan=0.0)).astype(np.int64)
        if not self.use_all_levels:             # skip level 0 of each factor
            ok = ival != 0
            ival = ival - 1
        else:
            ok = np.ones(ival.shape, bool)
        ival = ival + self.cat_offsets[i]
        ok &= ival < self.cat_offsets[i + 1]
        return ok, np.clip(ival, 0, clip_bound - 1)

    def _score_multinomial(self, X: np.ndarray) -> np.ndarray:
        """GlmMultinomialMojoModel.glmScore0: flat beta of nclasses blocks of
        P (cat one-hots | nums | intercept), per-class eta, softmax."""
        K = self.nclasses
        P = len(self.beta) // K
        if P * K != len(self.beta):
            raise ValueError("incorrect multinomial beta coding")
        B = self.beta.reshape(K, P)
        noff = int(self.cat_offsets[self.cats]) if self.cats else 0
        eta = np.zeros((X.shape[0], K), np.float64)
        for i in range(self.cats):
            ok, idx = self._cat_beta_index(X, i, P)
            eta += np.where(ok[:, None], B[:, idx].T, 0.0)
        for i in range(self.nums):
            eta += np.outer(X[:, self.cats + i], B[:, noff + i])
        eta += B[:, P - 1][None, :]             # intercepts
        z = eta - eta.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)


class RefIsoForModel(RefTreeModel):
    """Imported IsolationForest MOJO (IsolationForestMojoReader/-MojoModel):
    trees sum path lengths; score = (max − sum)/(max − min), plus the mean
    path length (and the anomaly flag when the artifact outputs one)."""

    def __init__(self, info, columns, domains, trees):
        super().__init__(info, columns, domains, trees, "isolationforest")
        self.min_path = float(_kv(info, "min_path_length", 0) or 0)
        self.max_path = float(_kv(info, "max_path_length", 0) or 0)
        self.anomaly_flag = _kv(info, "output_anomaly_flag") == "true"

    def _score_raw(self, frame) -> torch.Tensor:
        """The Model contract's 1-D scores on the frame's device; the whole
        [score, mean_length(, flag)] table is predict()'s."""
        raw = self.score(self._design(frame)).astype(np.float32)
        score = raw[:, 1] if self.anomaly_flag else raw[:, 0]
        return torch.as_tensor(np.ascontiguousarray(score)).to(frame.device)

    def score(self, X: np.ndarray) -> np.ndarray:
        sums = np.zeros(X.shape[0], np.float64)
        for t in self.trees[0]:
            if t is not None:
                sums += _score_tree(t, X, self._domain_len)
        mean_len = sums / max(self.n_groups, 1)
        if self.max_path > self.min_path:
            score = (self.max_path - sums) / (self.max_path - self.min_path)
        else:
            score = np.ones_like(sums)
        if self.anomaly_flag:
            # >= : the threshold convention everywhere else (EasyPredict,
            # model_base.py binomial labels)
            return np.stack([(score >= self._default_threshold) * 1.0,
                             score, mean_len], 1)
        return np.stack([score, mean_len], 1)

    def predict(self, frame):
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.vec import Vec
        raw = self.score(self._design(frame)).astype(np.float32)
        names = (["predict", "score", "mean_length"] if self.anomaly_flag
                 else ["predict", "mean_length"])
        return Frame(names, [Vec.from_numpy(np.ascontiguousarray(raw[:, j]),
                                            device=frame.device)
                             for j in range(raw.shape[1])])


class RefKMeansModel(_RefModelBase):
    """Imported K-means MOJO (KMeansMojoReader/KMeansMojoModel +
    GenModel.KMeans_distance: Euclidean on numerics, 0/1 mismatch on
    categoricals, NA-dimension upscaling)."""

    algo = "kmeans"

    def __init__(self, info, columns, domains):
        super().__init__(info, columns, domains)
        k = int(_kv(info, "center_num"))
        self.centers = np.stack([_kv_doubles(info, f"center_{i}")
                                 for i in range(k)])
        self.standardize = _kv(info, "standardize") == "true"
        if self.standardize:
            self.means = _kv_doubles(info, "standardize_means")
            self.mults = _kv_doubles(info, "standardize_mults")
            self.modes = _kv_doubles(info, "standardize_modes").astype(np.int64)
        self.is_cat = np.array([domains[j] is not None
                                for j in range(self.n_features)])

    def score(self, X: np.ndarray) -> np.ndarray:
        X = X.copy()
        if self.standardize:                 # Kmeans_preprocessData
            for j in range(self.n_features):
                m = np.isnan(X[:, j])
                if self.modes[j] == -1:      # numeric: impute + scale
                    X[m, j] = self.means[j]
                    X[:, j] = (X[:, j] - self.means[j]) * self.mults[j]
                else:
                    X[m, j] = self.modes[j]
        n, P = X.shape
        d2 = np.zeros((n, len(self.centers)))
        valid = ~np.isnan(X)
        pts = valid.sum(axis=1)
        for c, ctr in enumerate(self.centers):
            diff = np.where(self.is_cat[None, :], (X != ctr[None, :]) * 1.0,
                            (X - ctr[None, :]) ** 2)
            d2[:, c] = np.where(valid, diff, 0.0).sum(axis=1)
        scale = np.where((pts > 0) & (pts < P), P / np.maximum(pts, 1), 1.0)
        d2 *= scale[:, None]
        return np.argmin(d2, axis=1).astype(np.float64)


class RefStackedEnsembleModel(_RefModelBase):
    """Imported StackedEnsemble MOJO (StackedEnsembleMojoReader /
    StackedEnsembleMojoModel.score0): base-model predictions feed the
    metalearner, with per-submodel column remapping by feature name."""

    algo = "stackedensemble"

    def __init__(self, info, columns, domains, base_models, metalearner,
                 mappings):
        super().__init__(info, columns, domains)
        self.base_models = base_models          # list[_RefModelBase | None]
        self.metalearner = metalearner
        self.mappings = mappings                # per-base int[] into parent X
        self.logit_transform = \
            _kv(info, "metalearner_transform", "NONE") == "Logit"

    def score(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        nb = len(self.base_models)
        if self.nclasses > 2:
            base = np.zeros((n, nb * self.nclasses))
            for i, (m, mp) in enumerate(zip(self.base_models, self.mappings)):
                if m is None:
                    continue
                base[:, i * self.nclasses:(i + 1) * self.nclasses] = \
                    m.score(X[:, mp])
        elif self.nclasses == 2:
            base = np.zeros((n, nb))
            for i, (m, mp) in enumerate(zip(self.base_models, self.mappings)):
                if m is not None:
                    base[:, i] = m.score(X[:, mp])[:, 1]
        else:
            base = np.zeros((n, nb))
            for i, (m, mp) in enumerate(zip(self.base_models, self.mappings)):
                if m is not None:
                    base[:, i] = m.score(X[:, mp])
        if self.logit_transform:
            # StackedEnsembleMojoModel.logit: p clipped to [1e-9, 1-1e-9],
            # then max(-19, log odds) — the LOWER side clamps to -19, the
            # upper does not (Java: x==0 ? -19 : max(-19, log(x)))
            b = np.clip(base, 1e-9, 1 - 1e-9)
            base = np.maximum(-19.0, np.log(b / (1 - b)))
        return self.metalearner.score(base)


# -- zip-level entry ---------------------------------------------------------

def is_reference_mojo(path: str) -> bool:
    """True when the zip is an H2O-3 MOJO (model.ini with [info] algo=...)."""
    try:
        with zipfile.ZipFile(path) as z:
            if "model.ini" not in z.namelist():
                return False
            info, _, _ = _parse_ini(z.read("model.ini").decode())
        return "algo" in info and "format" not in info
    except (OSError, zipfile.BadZipFile, KeyError, UnicodeDecodeError):
        return False


def load_ref_mojo(path_or_bytes):
    """Load a reference H2O-3 MOJO zip into a scoring model.

    Supported algos: gbm, drf, isolationforest (tree families, MOJO
    >= 1.20), glm, kmeans, stackedensemble (nested submodels,
    MultiModelMojoReader layout), plus via ``mojo_ref2``: deeplearning,
    pca, glrm, coxph, word2vec, rulefit, targetencoder,
    isotonicregression, xgboost (boosterBytes parsed natively),
    extendedisolationforest.
    Raises with a clear message otherwise — matching ``ModelMojoFactory``'s
    algo dispatch (``hex/genmodel/ModelMojoFactory.java``).
    """
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) \
        else path_or_bytes
    with zipfile.ZipFile(src) as z:
        return _load_from_zip(z, "")


def _load_from_zip(z: zipfile.ZipFile, prefix: str):
    """Load the model rooted at ``prefix`` inside the (possibly shared)
    zip — submodels of a StackedEnsemble live under ``models/...`` in the
    parent archive (MultiModelMojoReader.NestedMojoReaderBackend)."""
    info, columns, domain_files = _parse_ini(
        z.read(prefix + "model.ini").decode())
    escape = _kv(info, "escape_domain_values") == "true"
    domains: list = [None] * len(columns)
    for ci, (_card, fname) in domain_files.items():
        lines = z.read(prefix + "domains/" + fname).decode().splitlines()
        domains[ci] = [(_unescape(s) if escape else s).strip()
                       for s in lines]
    algo = _kv(info, "algo")
    mojo_version = float(_kv(info, "mojo_version", 0))
    if algo in ("gbm", "drf", "isolationforest"):
        if mojo_version < 1.20:
            raise ValueError(
                f"tree MOJO version {mojo_version} predates the "
                "ScoreTree2 bytecode; re-export with H2O-3 >= 3.22")
        nclasses = max(1, int(_kv(info, "n_classes", 1)))
        tpc = _kv(info, "n_trees_per_class")
        if tpc is None:
            bdt = _kv(info, "binomial_double_trees") == "true"
            tpc = 1 if (nclasses == 2 and not bdt) else nclasses
        tpc = int(tpc)
        n_groups = int(_kv(info, "n_trees"))
        trees = [[None] * n_groups for _ in range(tpc)]
        names = set(z.namelist())
        for k in range(tpc):
            for g in range(n_groups):
                name = f"{prefix}trees/t{k:02d}_{g:03d}.bin"
                if name in names:
                    trees[k][g] = _decode_tree(z.read(name))
        if algo == "isolationforest":
            return RefIsoForModel(info, columns, domains, trees)
        return RefTreeModel(info, columns, domains, trees, algo)
    if algo == "glm":
        return RefGlmModel(info, columns, domains)
    if algo == "kmeans":
        return RefKMeansModel(info, columns, domains)
    if algo == "stackedensemble":
        subs: dict = {}
        n_sub = int(_kv(info, "submodel_count", 0))
        for i in range(n_sub):
            key = _kv(info, f"submodel_key_{i}")
            sub_dir = _kv(info, f"submodel_dir_{i}")
            subs[key] = _load_from_zip(z, prefix + sub_dir)
        meta_key = _kv(info, "metalearner")
        meta = subs.get(meta_key)
        if meta is None:
            raise ValueError(
                f"stackedensemble MOJO names metalearner {meta_key!r} but "
                f"the archive's submodels are {sorted(subs)}")
        nb = int(_kv(info, "base_models_num", 0))
        base_models, mappings = [], []
        n_feat = int(_kv(info, "n_features"))
        col_index = {c: j for j, c in enumerate(columns[:n_feat])}
        for i in range(nb):
            bkey = _kv(info, f"base_model{i}")
            m = subs.get(bkey)
            base_models.append(m)
            if m is None:
                mappings.append(None)
                continue
            # remap by feature NAME: submodels may order columns differently
            # (StackedEnsembleMojoReader.createMapping)
            feats = m.columns[: m.n_features]
            try:
                mappings.append(np.array([col_index[f] for f in feats],
                                         np.int64))
            except KeyError as e:
                raise ValueError(f"base model {bkey!r} input column {e} "
                                 "missing from the ensemble frame") from None
        return RefStackedEnsembleModel(info, columns, domains, base_models,
                                       meta, mappings)
    # long-tail families (DL/PCA/GLRM/CoxPH/Word2Vec/RuleFit/TargetEncoder/
    # Isotonic) live in mojo_ref2 — same archive grammar, separate module
    from h2o3_tpu_torch.genmodel.mojo_ref2 import load_ext_family
    model = load_ext_family(algo, z, prefix, info, columns, domains,
                            lambda p: _load_from_zip(z, p))
    if model is not None:
        return model
    raise ValueError(
        f"unsupported reference MOJO algo {algo!r}; this importer handles "
        "gbm, drf, isolationforest, glm, kmeans, stackedensemble, "
        "deeplearning, pca, glrm, coxph, word2vec, rulefit, targetencoder, "
        "isotonicregression, xgboost, extendedisolationforest (export other "
        "families from this framework's "
        "own MOJO v2 instead)")
