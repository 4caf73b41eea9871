"""Reference-format MOJO importer, part 2: the long-tail families — the port
of ``h2o3_tpu/genmodel/mojo_ref2.py``.

Extends ``mojo_ref`` (which handles GBM/DRF/IF/GLM/KMeans/SE) with readers
for the remaining reference artifact families (VERDICT r4 missing #1):
DeepLearning, PCA, GLRM, CoxPH, Word2Vec, RuleFit, TargetEncoder and
IsotonicRegression.  Format provenance (studied, not copied — these are
from-scratch Python readers of the documented container layout):

- kv store: scalars and numeric arrays live in ``model.ini`` ``[info]``
  as ``Arrays.toString`` text (``hex/genmodel/AbstractMojoWriter.java:61-80``);
  binary blobs are separate zip entries written through ``ByteBuffer``,
  which is **big-endian** regardless of the ``endianness`` info key
  (``ModelMojoReader.java:208-235`` readRectangularDoubleArray).
- DeepLearning: ``hex/deeplearning/DeepLearningMojoWriter.java:34-95``
  (weight_layer{i}/bias_layer{i} kv arrays, float-truncated weights) and
  the scoring stack ``DeeplearningMojoModel.java:62-130`` +
  ``NeuralNetwork.java:37-95`` + ``ActivationUtils.java`` +
  ``GenModel.setInput/setCats`` (``GenModel.java:707-770``).
- PCA: ``PCAMojoWriter.java:23-40`` / ``PCAMojoModel.java:25-52``
  (eigenvectors_raw big-endian double blob [size][k], permutation,
  level-skip rules for unseen/NA categoricals).
- GLRM: ``GlrmMojoReader.java:18-74`` / ``GlrmMojoModel.java:88-360``
  (per-row prox-prox X solve seeded ``seed + row``), with
  ``GlrmLoss.java`` / ``GlrmRegularizer.java`` reproduced exactly and
  ``java.util.Random`` re-implemented for init/tie-break parity.
- CoxPH: ``CoxPHMojoWriter.java:31-54`` / ``CoxPHMojoModel.java:75-170``
  (x_mean rectangular blobs, strata kv map, lpBase subtraction).
- Word2Vec: ``Word2VecMojoWriter.java:27-45`` (vocabulary text file +
  big-endian float32 ``vectors`` blob) / ``Word2VecMojoModel.java``.
- RuleFit: ``RuleFitMojoWriter.java:34-147`` kv-encoded rule ensemble over
  a nested GLM (MultiModelMojoReader layout shared with StackedEnsemble),
  scoring per ``RuleFitMojoModel.java:25-63`` + ``MojoRuleEnsemble.java``
  (note the writer's bug-compatible ``cat_treshold_length_{i}_{cond}``
  key carrying the i-th categorical threshold VALUE).
- TargetEncoder: ``ai/h2o/targetencoding/TargetEncoderMojoWriter.java``
  four ini-style files under ``feature_engineering/target_encoding/`` and
  blended-encoding math per ``TargetEncoderMojoModel.java:10-205`` /
  ``EncodingMap.java``.
- Isotonic: ``IsotonicRegressionMojoWriter`` → calibrator blobs
  (``AbstractMojoWriter.java:82-95``: int32 length + doubles) scored per
  ``IsotonicRegressionUtils.java:7-43``.

Like part 1, decoding happens once at import; scoring is vectorized
float64 numpy over rows on the host (GLRM's per-row iterative solve is the
one reference-mandated scalar loop), as in the JAX package, and the
results are handed to the frame's device.
"""

from __future__ import annotations

import math
import re
import struct

import numpy as np
import torch

from h2o3_tpu_torch.genmodel.mojo_ref import (
    _RefModelBase, _kv, _kv_doubles, _unescape,
)

__all__ = ["load_ext_family", "EXT_ALGOS"]


# -- kv / blob helpers -------------------------------------------------------

def _kv_ints(info: dict, key: str, default=None):
    v = _kv_doubles(info, key)
    if v is None:
        return default
    return v.astype(np.int64)


def _kv_bool(info: dict, key: str, default: bool = False) -> bool:
    v = _kv(info, key)
    return default if v is None else v == "true"


def _be_doubles(blob: bytes, n: int) -> np.ndarray:
    """ByteBuffer.putDouble stream — big-endian, no length header."""
    return np.frombuffer(blob, ">f8", n).astype(np.float64)


def _be_len_doubles(blob: bytes) -> np.ndarray:
    """readblobDoubles layout: int32 count then doubles (big-endian)."""
    (n,) = struct.unpack_from(">i", blob, 0)
    return np.frombuffer(blob, ">f8", n, 4).astype(np.float64)


def _read_text(z, name: str, unescape: bool = False) -> list[str]:
    lines = z.read(name).decode().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return [_unescape(s) if unescape else s for s in lines]


def _rect(z, prefix: str, info: dict, title: str) -> np.ndarray:
    """writeRectangularDoubleArray: {title}_size1/_size2 kv + blob."""
    s1 = int(_kv(info, f"{title}_size1"))
    s2 = int(_kv(info, f"{title}_size2"))
    return _be_doubles(z.read(prefix + title), s1 * s2).reshape(s1, s2)


# -- java.util.Random (LCG) for GLRM init/tie-break parity -------------------

class _JavaRandom:
    """Bit-exact ``java.util.Random``: 48-bit LCG, Marsaglia-polar
    nextGaussian — GlrmMojoModel seeds one per row (seed + row index)."""

    __slots__ = ("_s", "_g")
    _M = (1 << 48) - 1

    def __init__(self, seed: int):
        self._s = (seed ^ 0x5DEECE66D) & self._M
        self._g = None

    def _next(self, bits: int) -> int:
        self._s = (self._s * 0x5DEECE66D + 0xB) & self._M
        return self._s >> (48 - bits)

    def next_int(self, n: int) -> int:
        if n <= 0:
            raise ValueError("n must be positive")
        if (n & -n) == n:                       # power of two
            return (n * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % n
            if bits - val + (n - 1) < (1 << 31):   # no int32 overflow
                return val

    def next_double(self) -> float:
        return ((self._next(26) << 27) + self._next(27)) * (2.0 ** -53)

    def next_gaussian(self) -> float:
        if self._g is not None:
            g, self._g = self._g, None
            return g
        while True:
            v1 = 2 * self.next_double() - 1
            v2 = 2 * self.next_double() - 1
            s = v1 * v1 + v2 * v2
            if 0 < s < 1:
                break
        mult = math.sqrt(-2 * math.log(s) / s)
        self._g = v2 * mult
        return v1 * mult


# -- DeepLearning ------------------------------------------------------------

def _dl_linkinv(family: str | None, f: np.ndarray) -> np.ndarray:
    """DeeplearningMojoModel.linkInv: exp capped at 1e19."""
    if family in ("bernoulli", "quasibinomial", "modified_huber", "ordinal"):
        return 1.0 / (1.0 + np.minimum(1e19, np.exp(-f)))
    if family in ("multinomial", "poisson", "gamma", "tweedie"):
        return np.minimum(1e19, np.exp(f))
    return f


class RefDeepLearningModel(_RefModelBase):
    """Imported DeepLearning MOJO: kv weights, exact fprop semantics."""

    algo = "deeplearning"

    def __init__(self, info, columns, domains):
        super().__init__(info, columns, domains)
        self.cats = int(_kv(info, "cats", 0))
        self.nums = int(_kv(info, "nums", 0))
        self.cat_offsets = _kv_ints(info, "cat_offsets", np.zeros(1, np.int64))
        self.norm_mul = _kv_doubles(info, "norm_mul")
        self.norm_sub = _kv_doubles(info, "norm_sub")
        self.norm_resp_mul = _kv_doubles(info, "norm_resp_mul")
        self.norm_resp_sub = _kv_doubles(info, "norm_resp_sub")
        self.use_all_levels = _kv_bool(info, "use_all_factor_levels")
        # mean_imputation / cat_modes are read by the reference reader but
        # NEVER used in its scoring path: DeeplearningMojoModel.score0
        # hardcodes replaceMissingWithZero=true (NaN num -> 0 AFTER
        # standardization, which IS the training mean; NA cat -> the
        # factor's extra last level).  Matching that exactly.
        self.activation = _kv(info, "activation")
        self.family = _kv(info, "distribution")
        if self.family == "modified_huber":
            raise ValueError(
                "modified_huber DeepLearning MOJOs score a constant in the "
                "reference (DeeplearningMojoModel.java:108 reads preds[0] "
                "right after zeroing it) — refusing to reproduce that")
        self.units = _kv_ints(info, "neural_network_sizes")
        self.dropout = _kv_doubles(info, "hidden_dropout_ratios")
        if self.dropout is None:
            self.dropout = np.zeros(len(self.units) - 1)
        self.balance_classes = _kv_bool(info, "balance_classes")
        self.prior_distrib = _kv_doubles(info, "prior_class_distrib")
        self.model_distrib = _kv_doubles(info, "model_class_distrib")
        n_layers = len(self.units) - 1
        self.weights: list[np.ndarray] = []
        self.biases: list[np.ndarray] = []
        self.maxk = 1
        if self.activation in ("Maxout", "MaxoutWithDropout"):
            b0 = _kv_doubles(info, "bias_layer0")
            self.maxk = len(b0) // int(self.units[1])
        for i in range(n_layers):
            w = _kv_doubles(info, f"weight_layer{i}")
            b = _kv_doubles(info, f"bias_layer{i}")
            # convertDouble2Float: weights round-trip through float32
            self.weights.append(w.astype(np.float32).astype(np.float64))
            self.biases.append(b)

    # layer activations: hidden layers use the parameter activation, the
    # output layer Softmax (classifier) / Linear (DeeplearningMojoModel.init)
    def _layer_activation(self, layer: int) -> str:
        if layer == len(self.units) - 2:
            return "Softmax" if self.is_classifier else "Linear"
        return self.activation

    def _net_input(self, X: np.ndarray) -> np.ndarray:
        """GenModel.setInput(DL variant): one-hot cats (NA -> the factor's
        last level), standardized nums with NaN->0."""
        n = X.shape[0]
        width = int(self.cat_offsets[self.cats]) + self.nums
        out = np.zeros((n, width))
        for i in range(self.cats):
            d = X[:, i]
            lo, hi = int(self.cat_offsets[i]), int(self.cat_offsets[i + 1])
            c = np.trunc(np.nan_to_num(d, nan=0.0)).astype(np.int64)
            if self.use_all_levels:
                idx = c + lo
            else:
                idx = np.where(c != 0, c - 1 + lo, -1)
            idx = np.where(np.isnan(d), hi - 1, np.minimum(idx, hi - 1))
            rows = np.arange(n)
            hit = idx >= 0
            out[rows[hit], idx[hit]] = 1.0
        for j in range(self.nums):
            d = X[:, self.cats + j]
            if self.norm_mul is not None and len(self.norm_mul) > 0:
                d = (d - self.norm_sub[j]) * self.norm_mul[j]
            out[:, int(self.cat_offsets[self.cats]) + j] = \
                np.nan_to_num(d, nan=0.0)
        return out

    def _fprop(self, h: np.ndarray, layer: int) -> np.ndarray:
        w, b = self.weights[layer], self.biases[layer]
        out_size = int(self.units[layer + 1])
        in_size = h.shape[1]
        act = self._layer_activation(layer)
        if act in ("Maxout", "MaxoutWithDropout"):
            # wValues[maxK*(row*inSize+col)+k] (NeuralNetwork.java:81-93)
            W = w.reshape(out_size, in_size, self.maxk)
            B = b.reshape(out_size, self.maxk)
            z = np.einsum("ni,oik->nok", h, W) + B[None, :, :]
            # MaxoutOut.eval walks countInd = index*maxK then += k — for
            # maxK<=2 that is a plain max over k (the supported case)
            v = z.max(axis=2)
        else:
            W = w.reshape(out_size, in_size)
            z = h @ W.T + b[None, :]
            v = z
        if act == "Linear":
            pass
        elif act == "Softmax":
            e = np.exp(v - v.max(axis=1, keepdims=True))
            v = e / e.sum(axis=1, keepdims=True)
        elif act.startswith("ExpRectifier"):
            v = np.where(v >= 0, v, np.exp(np.minimum(v, 0)) - 1)
        elif act.startswith("Rectifier"):
            v = 0.5 * (v + np.abs(v))
        elif act.startswith("Tanh"):
            v = 1.0 - 2.0 / (1.0 + np.exp(2.0 * v))
        elif act.startswith("Maxout"):
            pass
        else:
            raise ValueError(f"unsupported DL activation {act!r}")
        if act.endswith("WithDropout"):
            v = v * (1.0 - self.dropout[layer])
        return v

    def score(self, X: np.ndarray) -> np.ndarray:
        h = self._net_input(X)
        for layer in range(len(self.units) - 1):
            h = self._fprop(h, layer)
        if self.is_classifier:
            if self.balance_classes and self.model_distrib is not None:
                # GenModel.correctProbabilities
                h = h * (self.prior_distrib / self.model_distrib)[None, :]
                s = h.sum(axis=1, keepdims=True)
                h = np.where(s > 0, h / s, h)
            return h
        out = h[:, 0]
        if self.norm_resp_mul is not None and len(self.norm_resp_mul) > 0:
            out = out / self.norm_resp_mul[0] + self.norm_resp_sub[0]
        return _dl_linkinv(self.family, out)


# -- PCA ---------------------------------------------------------------------

class RefPCAModel(_RefModelBase):
    """Imported PCA MOJO: project rows onto k eigenvectors."""

    algo = "pca"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.k = int(_kv(info, "k"))
        self.permutation = _kv_ints(info, "permutation")
        self.ncats = int(_kv(info, "ncats", 0))
        self.nnums = int(_kv(info, "nnums", 0))
        self.norm_sub = _kv_doubles(info, "normSub")
        self.norm_mul = _kv_doubles(info, "normMul")
        self.cat_offsets = _kv_ints(info, "catOffsets", np.zeros(1, np.int64))
        self.use_all_levels = _kv_bool(info, "use_all_factor_levels")
        size = int(_kv(info, "eigenvector_size"))
        self.eig = _be_doubles(z.read(prefix + "eigenvectors_raw"),
                               size * self.k).reshape(size, self.k)

    @property
    def is_classifier(self) -> bool:
        return False

    def score(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        out = np.zeros((n, self.k))
        num_start = int(self.cat_offsets[self.ncats])
        for j in range(self.ncats):
            d = X[:, self.permutation[j]]
            last = int(self.cat_offsets[j + 1] - self.cat_offsets[j]) - 1
            lvl = np.trunc(np.nan_to_num(d, nan=0.0)).astype(np.int64) \
                - (0 if self.use_all_levels else 1)
            ok = ~np.isnan(d) & (lvl >= 0) & (lvl <= last)
            idx = np.clip(lvl, 0, last) + int(self.cat_offsets[j])
            out += np.where(ok[:, None], self.eig[idx, :], 0.0)
        for j in range(self.nnums):
            d = (X[:, self.permutation[self.ncats + j]]
                 - self.norm_sub[j]) * self.norm_mul[j]
            out += d[:, None] * self.eig[num_start + j, :][None, :]
        return out

    def predict(self, frame):
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.vec import Vec
        dev = frame.device
        raw = self.score(self._design(frame))
        return Frame([f"PC{i + 1}" for i in range(self.k)],
                     [Vec.from_numpy(raw[:, i].astype(np.float32), device=dev)
                      for i in range(self.k)])


# -- GLRM --------------------------------------------------------------------

_GLRM_NUM_ALPHAS = 10
_GLRM_ITERS = 100
_GLRM_EPS = 1e-10


class RefGlrmModel(_RefModelBase):
    """Imported GLRM MOJO: per-row prox-prox solve for the X factors."""

    algo = "glrm"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.ncolA = int(_kv(info, "ncolA"))
        self.ncolX = int(_kv(info, "ncolX"))
        self.ncolY = int(_kv(info, "ncolY"))
        self.nrowY = int(_kv(info, "nrowY"))
        self.gammax = float(_kv(info, "gammaX", 0.0) or 0.0)
        self.regx = _kv(info, "regularizationX", "None")
        self.ncats = int(_kv(info, "num_categories", 0))
        self.nnums = int(_kv(info, "num_numeric", 0))
        self.norm_sub = _kv_doubles(info, "norm_sub")
        if self.norm_sub is None:
            self.norm_sub = np.zeros(self.nnums)
        self.norm_mul = _kv_doubles(info, "norm_mul")
        if self.norm_mul is None:
            self.norm_mul = np.ones(self.nnums)
        self.permutation = _kv_ints(info, "cols_permutation")
        self.num_levels = _kv_ints(info, "num_levels_per_category",
                                   np.zeros(0, np.int64))
        self.seed = int(_kv(info, "seed", 0) or 0)
        losses = _read_text(z, prefix + "losses")
        for name in losses:
            if name.startswith("Periodic"):
                # GlrmLoss.valueOf("Periodic(p)") throws in the reference
                # reader too (GlrmMojoReader.java:36) — these MOJOs never
                # loaded anywhere
                raise ValueError("Periodic GLRM loss is unreadable in the "
                                 "reference MOJO format")
        self.losses = losses
        # archetypes blob is [nrowY=rank][ncolY] (GlrmMojoWriter.java:63-70)
        self.arch = _be_doubles(z.read(prefix + "archetypes"),
                                self.nrowY * self.ncolY
                                ).reshape(self.nrowY, self.ncolY)

    @property
    def is_classifier(self) -> bool:
        return False

    # loss primitives (GlrmLoss.java) — u is xY, a the (standardized) datum
    def _loss(self, kind: str, u: float, a: float) -> float:
        if kind == "Quadratic":
            return (u - a) * (u - a)
        if kind == "Absolute":
            return abs(u - a)
        if kind == "Huber":
            x = u - a
            return x - 0.5 if x > 1 else (-x - 0.5 if x < -1 else 0.5 * x * x)
        if kind == "Poisson":
            return math.exp(u) + (0.0 if a == 0
                                  else -a * u + a * math.log(a) - a)
        if kind == "Logistic":
            return math.log1p(math.exp((1 - 2 * a) * u))
        if kind == "Hinge":
            return max(1 + (1 - 2 * a) * u, 0.0)
        raise ValueError(f"unsupported GLRM numeric loss {kind!r}")

    def _lgrad(self, kind: str, u: float, a: float) -> float:
        if kind == "Quadratic":
            return 2 * (u - a)
        if kind == "Absolute":
            return float(np.sign(u - a))
        if kind == "Huber":
            x = u - a
            return 1.0 if x > 1 else (-1.0 if x < -1 else x)
        if kind == "Poisson":
            return math.exp(u) - a
        if kind == "Logistic":
            s = 1 - 2 * a
            return s / (1 + math.exp(-s * u))
        if kind == "Hinge":
            s = 1 - 2 * a
            return s if 1 + s * u > 0 else 0.0
        raise ValueError(f"unsupported GLRM numeric loss {kind!r}")

    def _mloss(self, kind: str, u: np.ndarray, a: int) -> float:
        if kind == "Categorical":
            s = float(np.maximum(1 + u, 0).sum())
            return s + max(1 - u[a], 0) - max(1 + u[a], 0)
        if kind == "Ordinal":
            idx = np.arange(len(u) - 1)
            return float(np.where(a > idx, np.maximum(1 - u[:-1], 0), 1.0
                                  ).sum())
        raise ValueError(f"unsupported GLRM categorical loss {kind!r}")

    def _mlgrad(self, kind: str, u: np.ndarray, a: int) -> np.ndarray:
        if kind == "Categorical":
            g = (1 + u > 0).astype(np.float64)
            g[a] = -1.0 if 1 - u[a] > 0 else 0.0
            return g
        if kind == "Ordinal":
            g = np.zeros_like(u)
            idx = np.arange(len(u) - 1)
            g[:-1] = np.where((a > idx) & (1 - u[:-1] > 0), -1.0, 0.0)
            return g
        raise ValueError(f"unsupported GLRM categorical loss {kind!r}")

    # regularizer (GlrmRegularizer.java)
    def _regularize(self, u: np.ndarray) -> float:
        r = self.regx
        if r == "None":
            return 0.0
        if r == "Quadratic":
            return float((u * u).sum())
        if r == "L2":
            return float(np.sqrt((u * u).sum()))
        if r == "L1":
            return float(np.abs(u).sum())
        if r == "NonNegative":
            return math.inf if (u < 0).any() else 0.0
        if r == "OneSparse":
            if (u < 0).any():
                return math.inf
            return 0.0 if (u > 0).sum() == 1 else math.inf
        if r == "UnitOneSparse":
            ones = (u == 1).sum()
            zeros = (u == 0).sum()
            return 0.0 if ones == 1 and zeros == len(u) - 1 else math.inf
        if r == "Simplex":
            if (u < 0).any():
                return math.inf
            return 0.0 if abs(u.sum() - 1.0) <= 1e-8 * max(len(u), 1) \
                else math.inf
        raise ValueError(f"unsupported GLRM regularizer {r!r}")

    def _max_index(self, u: np.ndarray, rng: _JavaRandom) -> int:
        """ArrayUtils.maxIndex(u, rand): reservoir tie-break."""
        result, max_count = 0, 0
        for i in range(1, len(u)):
            if u[i] > u[result]:
                result, max_count = i, 1
            elif u[i] == u[result]:
                max_count += 1
                if rng.next_int(max_count) == 0:
                    result = i
        return result

    def _rproxgrad(self, u: np.ndarray, delta: float, rng: _JavaRandom
                   ) -> np.ndarray:
        r = self.regx
        if r == "None" or delta == 0:
            return u
        if r == "Quadratic":
            return u / (1 + 2 * delta)
        if r == "L2":
            w = 1 - delta / np.sqrt((u * u).sum())
            return np.zeros_like(u) if w < 0 else w * u
        if r == "L1":
            return np.maximum(u - delta, 0) + np.minimum(u + delta, 0)
        if r == "NonNegative":
            return np.maximum(u, 0)
        if r == "OneSparse":
            v = np.zeros_like(u)
            i = self._max_index(u, rng)
            v[i] = u[i] if u[i] > 0 else 1e-6
            return v
        if r == "UnitOneSparse":
            v = np.zeros_like(u)
            v[self._max_index(u, rng)] = 1.0
            return v
        if r == "Simplex":
            n = len(u)
            order = np.argsort(u, kind="stable")
            us = u[order]
            ucsum = np.cumsum(us[::-1])[::-1]
            t = (ucsum[0] - 1) / n
            for i in range(n - 1, 0, -1):
                tmp = (ucsum[i] - 1) / (n - i)
                if tmp >= us[i - 1]:
                    t = tmp
                    break
            return np.maximum(u - t, 0)
        raise ValueError(f"unsupported GLRM regularizer {r!r}")

    def _project(self, u: np.ndarray, rng: _JavaRandom) -> np.ndarray:
        if self.regx in ("None", "Quadratic", "L2", "L1"):
            return u
        if self.regx == "Simplex" and self._regularize(u) == 0:
            return u
        return self._rproxgrad(u, 1.0, rng)

    def _adapt_row(self, row: np.ndarray) -> np.ndarray:
        """GlrmMojoModel.getRowData: permute, unseen cat level -> NaN."""
        a = np.empty(self.ncolA)
        for i in range(self.ncats):
            t = row[self.permutation[i]]
            a[i] = np.nan if (not np.isnan(t) and t >= self.num_levels[i]) \
                else t
        for i in range(self.ncats, self.ncolA):
            a[i] = row[self.permutation[i]]
        return a

    def _xy_cat(self, x: np.ndarray, j: int, cat_offset: int) -> np.ndarray:
        nl = int(self.num_levels[j])
        return x @ self.arch[:, cat_offset:cat_offset + nl]

    def _objective(self, x: np.ndarray, a: np.ndarray) -> float:
        res = 0.0
        cat_offset = 0
        for j in range(self.ncats):
            nl = int(self.num_levels[j])
            if not np.isnan(a[j]):
                res += self._mloss(self.losses[j],
                                   self._xy_cat(x, j, cat_offset), int(a[j]))
            cat_offset += nl
        for j in range(self.ncats, self.ncolA):
            js = j - self.ncats
            if np.isnan(a[j]):
                continue
            xy = float(x @ self.arch[:, js + cat_offset])
            res += self._loss(self.losses[j], xy,
                              (a[j] - self.norm_sub[js]) * self.norm_mul[js])
        res += self.gammax * self._regularize(x)
        return res

    def _gradientL(self, x: np.ndarray, a: np.ndarray) -> np.ndarray:
        grad = np.zeros(self.ncolX)
        cat_offset = 0
        for j in range(self.ncats):
            nl = int(self.num_levels[j])
            if not np.isnan(a[j]):
                xy = self._xy_cat(x, j, cat_offset)
                gl = self._mlgrad(self.losses[j], xy, int(a[j]))
                grad += self.arch[:, cat_offset:cat_offset + nl] @ gl
            cat_offset += nl
        for j in range(self.ncats, self.ncolA):
            js = j - self.ncats
            if np.isnan(a[j]):
                continue
            y = self.arch[:, js + cat_offset]
            xy = float(x @ y)
            gl = self._lgrad(self.losses[j], xy,
                             (a[j] - self.norm_sub[js]) * self.norm_mul[js])
            grad += gl * y
        return grad

    def _score_row(self, row: np.ndarray, seed: int) -> np.ndarray:
        a = self._adapt_row(row)
        rng = _JavaRandom(seed)
        x = np.array([rng.next_gaussian() for _ in range(self.ncolX)])
        x = self._project(x, rng)
        old_obj = self._objective(x, a)
        alphas = 0.5 ** np.arange(1, _GLRM_NUM_ALPHAS + 1)
        iters = 0
        while iters < _GLRM_ITERS:
            iters += 1
            grad = self._gradientL(x, a)
            # applyBestAlpha (GlrmMojoModel.java:152-189)
            if old_obj == 0:
                break
            scale = 1.0 / old_obj if old_obj > 10 else 1.0
            lowest, best_x = math.inf, None
            for al in alphas * scale:
                xnew = self._rproxgrad(x - al * grad, al * self.gammax, rng)
                nobj = self._objective(xnew, a)
                if nobj < lowest:
                    lowest, best_x = nobj, xnew
                if nobj == 0:
                    break
            if lowest < old_obj:
                x = best_x
            obj = lowest
            improvement = 1 - obj / old_obj
            old_obj = obj
            if improvement < _GLRM_EPS:
                break
        return x

    def score(self, X: np.ndarray) -> np.ndarray:
        # seed + rcnt: row i of a fresh scoring pass uses seed + i
        return np.stack([self._score_row(X[i], self.seed + i)
                         for i in range(X.shape[0])])

    def predict(self, frame):
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.vec import Vec
        dev = frame.device
        raw = self.score(self._design(frame))
        return Frame([f"Arch{i + 1}" for i in range(self.ncolX)],
                     [Vec.from_numpy(raw[:, i].astype(np.float32), device=dev)
                      for i in range(self.ncolX)])


# -- CoxPH -------------------------------------------------------------------

class RefCoxPHModel(_RefModelBase):
    """Imported CoxPH MOJO: linear predictor relative to the per-stratum
    training mean (lp - lpBase)."""

    algo = "coxph"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        if _kv(info, "interaction_targets") is not None:
            raise ValueError("CoxPH MOJOs with interaction terms are not "
                             "supported by this importer yet")
        self.coef = _kv_doubles(info, "coef")
        self.cats = int(_kv(info, "cats", 0))
        self.nums = int(_kv(info, "num_numerical_columns", 0))
        self.cat_offsets = _kv_ints(info, "cat_offsets", np.zeros(1, np.int64))
        self.num_offsets = _kv_ints(info, "num_offsets", np.zeros(0, np.int64))
        self.use_all_levels = _kv_bool(info, "use_all_factor_levels")
        self.x_mean_cat = _rect(z, prefix, info, "x_mean_cat")
        self.x_mean_num = _rect(z, prefix, info, "x_mean_num")
        n_strata = int(_kv(info, "strata_count", 0))
        self.strata: dict[tuple, int] = {}
        self.strata_len = 0
        for i in range(n_strata):
            s = _kv_doubles(info, f"strata_{i}")
            self.strata_len = len(s)
            self.strata[tuple(int(v) for v in s)] = i
        self.lp_base = self._compute_lp_base()

    @property
    def is_classifier(self) -> bool:
        return False

    def _compute_lp_base(self) -> np.ndarray:
        num_start = self.x_mean_cat.shape[1] if len(self.x_mean_cat) else 0
        size = max(len(self.strata), 1)
        lp = np.zeros(size)
        for s in range(size):
            lp[s] += self.x_mean_cat[s] @ self.coef[:num_start]
            lp[s] += self.x_mean_num[s] @ \
                self.coef[num_start:num_start + self.x_mean_num.shape[1]]
        return lp

    def score(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        sl = self.strata_len
        lp = np.zeros(n)
        # categorical contribution (CoxPHMojoModel.forCategories)
        n_cat_cols = self.cats if not self.use_all_levels \
            else len(self.cat_offsets) - 1
        lowest = 1 if not self.use_all_levels else 0
        for c in range(n_cat_cols):
            val = X[:, sl + c]
            v = np.trunc(np.nan_to_num(val, nan=0.0)).astype(np.int64) - lowest
            x = v + int(self.cat_offsets[c])
            ok = (v >= 0) & (x < int(self.cat_offsets[c + 1])) & ~np.isnan(val)
            contrib = np.where(ok, self.coef[np.clip(x, 0, len(self.coef) - 1)],
                               0.0)
            lp += np.where(np.isnan(val), np.nan, contrib)
        # numeric contribution (forOtherColumns)
        for i in range(self.nums):
            if int(self.num_offsets[i]) >= len(self.coef):
                break
            lp += self.coef[int(self.num_offsets[i])] * X[:, sl + self.cats + i]
        # per-row stratum base; an NA or training-unseen stratum yields an
        # NA prediction for THAT row (the reference NPEs the whole batch —
        # CoxPHMojoModel.strataForRow unboxes a null — which no batch
        # scorer should reproduce)
        base = np.zeros(n)
        if self.strata:
            for r in range(n):
                svals = X[r, :sl]
                if np.isnan(svals).any():
                    base[r] = np.nan
                    continue
                idx = self.strata.get(tuple(int(v) for v in svals))
                base[r] = np.nan if idx is None else self.lp_base[idx]
        else:
            base[:] = self.lp_base[0]
        return lp - base


# -- Word2Vec ----------------------------------------------------------------

class RefWord2VecModel(_RefModelBase):
    """Imported Word2Vec MOJO: word -> embedding lookup (no score0 in the
    reference either — Word2VecMojoModel.java:31 throws)."""

    algo = "word2vec"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.vec_size = int(_kv(info, "vec_size"))
        vocab_size = int(_kv(info, "vocab_size"))
        raw = z.read(prefix + "vectors")
        if len(raw) != vocab_size * self.vec_size * 4:
            raise ValueError("corrupted word2vec vectors blob: "
                             f"{len(raw)} bytes for {vocab_size} words")
        vecs = np.frombuffer(raw, ">f4").reshape(vocab_size, self.vec_size)
        words = _read_text(z, prefix + "vocabulary", unescape=True)
        if len(words) != vocab_size:
            raise ValueError(f"vocabulary has {len(words)} words, "
                             f"expected {vocab_size}")
        self.words = words
        self.vectors = vecs.astype(np.float32)
        self._index = {w: i for i, w in enumerate(words)}

    @property
    def is_classifier(self) -> bool:
        return False

    def transform0(self, word: str) -> np.ndarray | None:
        i = self._index.get(word)
        return None if i is None else self.vectors[i]

    def transform(self, words) -> np.ndarray:
        """Batch lookup; unknown words map to NaN rows (the h2o-py
        ``w2v.transform`` AGGREGATE/NONE surface builds on this)."""
        out = np.full((len(words), self.vec_size), np.nan, np.float32)
        for r, w in enumerate(words):
            i = self._index.get(w)
            if i is not None:
                out[r] = self.vectors[i]
        return out

    def find_synonyms(self, word: str, count: int = 20) -> dict[str, float]:
        v = self.transform0(word)
        if v is None:
            return {}
        norms = np.linalg.norm(self.vectors, axis=1) * np.linalg.norm(v)
        sims = np.where(norms > 0, self.vectors @ v / norms, 0.0)
        order = np.argsort(-sims)
        out = {}
        for i in order:
            if self.words[i] == word:
                continue
            out[self.words[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def predict(self, frame):
        raise ValueError("Word2Vec MOJOs embed words (use .transform); "
                         "they do not predict rows")

    def _score_raw(self, frame):
        self.predict(frame)


# -- Isotonic regression -----------------------------------------------------

class RefIsotonicModel(_RefModelBase):
    """Imported IsotonicRegression MOJO: clip + linear interpolation."""

    algo = "isotonicregression"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.min_x = float(_kv(info, "calib_min_x", "nan"))
        self.max_x = float(_kv(info, "calib_max_x", "nan"))
        self.thresholds_x = _be_len_doubles(z.read(prefix + "calib/thresholds_x"))
        self.thresholds_y = _be_len_doubles(z.read(prefix + "calib/thresholds_y"))

    @property
    def is_classifier(self) -> bool:
        return False

    def score(self, X: np.ndarray) -> np.ndarray:
        x = np.clip(X[:, 0], self.min_x, self.max_x)
        y = np.interp(x, self.thresholds_x, self.thresholds_y)
        return np.where(np.isnan(X[:, 0]), np.nan, y)


# -- RuleFit -----------------------------------------------------------------

class _RefRule:
    __slots__ = ("conditions", "var_name")

    def __init__(self, conditions, var_name):
        self.conditions = conditions
        self.var_name = var_name


class RefRuleFitModel(_RefModelBase):
    """Imported RuleFit MOJO: kv rule ensemble over a nested GLM."""

    algo = "rulefit"

    MODEL_TYPES = {0: "linear", 1: "rules_and_linear", 2: "rules"}

    def __init__(self, info, columns, domains, linear):
        super().__init__(info, columns, domains)
        self.linear = linear
        self.model_type = self.MODEL_TYPES[int(_kv(info, "model_type", 1))]
        self.depth = int(_kv(info, "depth", 0) or 0)
        self.ntrees = int(_kv(info, "ntrees", 0) or 0)
        n = int(_kv(info, "linear_names_len", 0) or 0)
        self.linear_names = [_kv(info, f"linear_names_{i}") for i in range(n)]
        self.rules: dict[tuple, list[_RefRule]] = {}
        if self.model_type != "linear":
            for i in range(self.depth):
                for j in range(self.ntrees):
                    cnt = int(_kv(info, f"num_rules_M{i}T{j}", 0) or 0)
                    self.rules[(i, j)] = [
                        self._read_rule(info, f"{i}_{j}_{k}")
                        for k in range(cnt)]
        # response domain for multinomial class-rule grouping
        rd = self.response_domain
        self.classes = list(rd) if rd else None

    def _read_rule(self, info, rid: str) -> _RefRule:
        ncond = int(_kv(info, f"num_conditions_rule_id_{rid}", 0) or 0)
        conds = []
        for i in range(ncond):
            cid = f"{i}_{rid}"
            ctype = int(_kv(info, f"type_{cid}"))
            cond = {
                "feature_index": int(_kv(info, f"feature_index_{cid}")),
                "operator": int(_kv(info, f"operator_{cid}")),
                "nas_included": _kv_bool(info, f"nas_included_{cid}"),
            }
            if ctype == 0:        # categorical: In over threshold levels
                # bug-compatible key: the i-th threshold VALUE is stored
                # under cat_treshold_length_{i}_{cid}
                # (RuleFitMojoWriter.java:131)
                nth = int(_kv(info, f"cat_treshold_length_{cid}", 0) or 0)
                cond["cat_threshold"] = np.array(
                    [int(_kv(info, f"cat_treshold_length_{t}_{cid}"))
                     for t in range(nth)], np.int64)
            else:
                cond["num_threshold"] = float(_kv(info, f"num_treshold{cid}"))
            conds.append(cond)
        return _RefRule(conds, _kv(info, f"var_name_rule_id_{rid}"))

    def _eval_rules(self, X: np.ndarray, rules: list[_RefRule]) -> np.ndarray:
        """[n, n_rules] 0/1 firing matrix (MojoCondition.map vectorized)."""
        n = X.shape[0]
        out = np.ones((n, len(rules)), bool)
        for r, rule in enumerate(rules):
            for c in rule.conditions:
                col = X[:, c["feature_index"]]
                isna = np.isnan(col)
                if c["operator"] == 0:       # LessThan
                    test = col < c["num_threshold"]
                elif c["operator"] == 1:     # GreaterThanOrEqual
                    test = col >= c["num_threshold"]
                else:                        # In (categorical)
                    test = np.isin(np.nan_to_num(col, nan=-1).astype(np.int64),
                                   c["cat_threshold"])
                ok = np.where(isna, c["nas_included"], test & ~isna)
                out[:, r] &= ok
        return out

    def _decode(self, fired: np.ndarray, rules: list[_RefRule],
                class_id: int = -1) -> np.ndarray:
        """Last-fired rule's domain index in the linear model's matching
        column (MojoRuleEnsemble.decode/getValueByVarName)."""
        n = fired.shape[0]
        val = np.full(n, -1, np.int64)
        lin_names = list(self.linear.columns[: self.linear.n_features])
        for r, rule in enumerate(rules):
            vn = rule.var_name
            var = vn[: vn.index("N")]
            if class_id >= 0:
                var += f"C{class_id}"
            i = lin_names.index(var)
            dom = self.linear.domains[i]
            code = dom.index(vn)
            val = np.where(fired[:, r], code, val)
        return np.where(val >= 0, val.astype(np.float64), np.nan)

    def _transform(self, X: np.ndarray) -> np.ndarray:
        """[n, depth*ntrees(*nclasses)] rule-derived categorical codes."""
        n = X.shape[0]
        multinomial = self.classes is not None and len(self.classes) > 2
        cols = []
        for i in range(self.depth):
            for j in range(self.ntrees):
                rules = self.rules[(i, j)]
                if multinomial:
                    for k, cls in enumerate(self.classes):
                        # varName grammar: M{i}T{j}N{node}_{class}
                        # (RuleFitMojoWriter.java:70-77).  The reference
                        # groups by endsWith(class), which conflates
                        # suffix-overlapping labels ('low'/'verylow');
                        # match the full grammar instead.
                        pat = re.compile(
                            rf"M{i}T{j}N\d+_{re.escape(cls)}$")
                        class_rules = [r for r in rules
                                       if pat.match(r.var_name)]
                        fired = self._eval_rules(X, class_rules)
                        cols.append(self._decode(fired, class_rules, k))
                else:
                    fired = self._eval_rules(X, rules)
                    cols.append(self._decode(fired, rules))
        return np.stack(cols, 1) if cols else np.zeros((n, 0))

    def score(self, X: np.ndarray) -> np.ndarray:
        if self.model_type == "linear":
            test = X
        else:
            rules_part = self._transform(X)
            test = rules_part if self.model_type == "rules" \
                else np.concatenate([rules_part, X], 1)
        # RuleFitMojoModel.map: reorder by the linear model's column order
        lin_names = list(self.linear.columns[: self.linear.n_features])
        lin_X = np.zeros((X.shape[0], self.linear.n_features))
        for i, name in enumerate(self.linear_names):
            lin_X[:, lin_names.index(name)] = test[:, i]
        return self.linear.score(lin_X)


# -- TargetEncoder -----------------------------------------------------------

_TE_DIR = "feature_engineering/target_encoding/"


class RefTargetEncoderModel(_RefModelBase):
    """Imported TargetEncoder MOJO: per-level (blended) posterior means."""

    algo = "targetencoder"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.with_blending = _kv_bool(info, "with_blending")
        self.inflection_point = float(_kv(info, "inflection_point", 0.0) or 0.0)
        self.smoothing = float(_kv(info, "smoothing", 1.0) or 1.0)
        self.keep_original = _kv_bool(info, "keep_original_categorical_columns")
        self.non_predictors = [s for s in
                               (_kv(info, "non_predictors", "") or "").split(";")
                               if s]
        names = set(z.namelist())
        # encodings: {te_column: {category: {target_class: (num, den)}}}
        self.encodings: dict[str, dict[int, dict[int, tuple]]] = {}
        if prefix + _TE_DIR + "encoding_map.ini" in names:
            cur = None
            for line in _read_text(z, prefix + _TE_DIR + "encoding_map.ini"):
                line = line.strip()
                if not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    cur = line[1:-1]
                    self.encodings[cur] = {}
                else:
                    k, _, v = line.partition("=")
                    parts = [float(p) for p in v.split()]
                    cat = int(k.strip())
                    tc = int(parts[2]) if len(parts) > 2 else -1
                    self.encodings[cur].setdefault(cat, {})[tc] = \
                        (parts[0], parts[1])
        self.has_nas: dict[str, bool] = {}
        if prefix + _TE_DIR + "te_column_name_to_missing_values_presence.ini" \
                in names:
            for line in _read_text(
                    z, prefix + _TE_DIR
                    + "te_column_name_to_missing_values_presence.ini"):
                k, _, v = line.partition("=")
                self.has_nas[k.strip()] = v.strip() == "1"
        self.inenc = self._parse_mapping(z, prefix + _TE_DIR
                                         + "input_encoding_columns_map.ini",
                                         names)
        self.inout = self._parse_mapping(z, prefix + _TE_DIR
                                         + "input_output_columns_map.ini",
                                         names)
        if not self.inenc:        # legacy MOJOs: identity mapping
            k = self.nclasses - 1 if self.nclasses > 2 else 1
            for col in self.encodings:
                self.inenc.append(([col], col, None))
                outs = [f"{col}_te"] if k == 1 else \
                    [f"{col}_{i + 1}_te" for i in range(k)]
                self.inout.append(([col], outs, None))
        self._priors: dict[tuple, float] = {}

    @staticmethod
    def _parse_mapping(z, name: str, names: set) -> list:
        """[( [from...], to|[to...], domain|None )] from the [from]/[to]
        ini groups (TargetEncoderMojoReader.parseColumnsMapping)."""
        out = []
        if name not in names:
            return out
        frm = to = dom = None
        for line in _read_text(z, name):
            if line == "[from]":
                if frm is not None and to is not None:
                    out.append((frm, to, dom))
                frm, to, dom = [], None, None
            elif line == "[to]":
                to = []
            elif line == "[to_domain]":
                dom = []
            elif dom is not None:
                dom.append(line)
            elif to is not None:
                to.append(line)
            else:
                frm.append(line)
        if frm is not None and to is not None:
            out.append((frm, to, dom))
        return out

    @property
    def is_classifier(self) -> bool:
        return False

    def _prior(self, te_col: str, target_class: int) -> float:
        key = (te_col, target_class)
        if key not in self._priors:
            num = den = 0.0
            for targets in self.encodings[te_col].values():
                nd = targets[target_class]
                num += nd[0]
                den += nd[1]
            self._priors[key] = num / den
        return self._priors[key]

    def _encode_value(self, nd: tuple, prior: float) -> float:
        post = nd[0] / nd[1]
        if self.with_blending:
            lam = 1.0 / (1.0 + math.exp(
                (self.inflection_point - int(nd[1])) / self.smoothing))
            return lam * post + (1 - lam) * prior
        return post

    def _encode_category(self, te_col: str, cat: int) -> list[float]:
        enc = self.encodings[te_col]
        if self.nclasses > 2:
            return [self._encode_value(enc[cat][t + 1], self._prior(te_col,
                                                                    t + 1))
                    for t in range(self.nclasses - 1)]
        return [self._encode_value(enc[cat][-1], self._prior(te_col, -1))]

    def _encode_na(self, te_col: str) -> list[float]:
        if self.has_nas.get(te_col, False):
            na_cat = len(self.encodings[te_col]) - 1
            return self._encode_category(te_col, na_cat)
        if self.nclasses > 2:
            return [self._prior(te_col, t + 1)
                    for t in range(self.nclasses - 1)]
        return [self._prior(te_col, -1)]

    def _interaction_value(self, X: np.ndarray, cols_idx: list[int],
                           domain: list[str]) -> np.ndarray:
        """TargetEncoderMojoModel.interactionValue vectorized."""
        inter = np.zeros(X.shape[0], np.int64)
        mult = 1
        for ci in cols_idx:
            card = len(self.domains[ci])
            v = X[:, ci]
            v = np.where(np.isnan(v) | (v >= card), card, v).astype(np.int64)
            inter += mult * v
            mult *= card + 1
        dom = np.array([int(d) for d in domain], np.int64)
        pos = np.searchsorted(dom, inter)
        pos_c = np.clip(pos, 0, len(dom) - 1)
        return np.where(dom[pos_c] == inter, pos_c, -1).astype(np.float64)

    def transform(self, frame):
        """Frame -> Frame with the encoded columns appended, in
        _inencMapping order (score0 parity)."""
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.vec import Vec
        dev = frame.device
        X = self._design_all(frame)
        out = Frame(list(frame.names), list(frame.vecs))
        col_index = {c: j for j, c in enumerate(self.columns)}
        for m_idx, (frm, te_col, dom) in enumerate(self.inenc):
            if isinstance(te_col, list):   # ColumnsToSingleMapping.toSingle
                te_col = te_col[0]
            if len(frm) == 1:
                cat = X[:, col_index[frm[0]]]
            else:
                cat = self._interaction_value(
                    X, [col_index[f] for f in frm], dom)
                cat = np.where(cat < 0, np.nan, cat)
            k = self.nclasses - 1 if self.nclasses > 2 else 1
            vals = np.empty((len(cat), k))
            na_enc = self._encode_na(te_col)
            enc = self.encodings[te_col]
            cache: dict[int, list[float]] = {}
            for r, c in enumerate(cat):
                if np.isnan(c) or int(c) not in enc:
                    vals[r] = na_enc
                else:
                    ci = int(c)
                    if ci not in cache:
                        cache[ci] = self._encode_category(te_col, ci)
                    vals[r] = cache[ci]
            names = self.inout[m_idx][1] if m_idx < len(self.inout) else \
                [f"{te_col}_te"]
            for col_i in range(k):
                out.add(names[col_i] if col_i < len(names)
                        else f"{te_col}_{col_i + 1}_te",
                        Vec.from_numpy(vals[:, col_i].astype(np.float32),
                                       device=dev))
            if not self.keep_original:
                # TE replaces the source categorical(s) unless the model
                # was built with keep_original_categorical_columns=true
                for src in frm:
                    if src in out and src not in self.non_predictors:
                        out.remove(src)
        return out

    def _design_all(self, frame) -> np.ndarray:
        """Like _design but over ALL model columns (TE encodes by column
        name, the response/non-predictors just stay NaN if absent)."""
        saved = self.n_features
        try:
            self.n_features = len(self.columns)
            return self._design(frame)
        finally:
            self.n_features = saved

    def predict(self, frame):
        raise ValueError("TargetEncoder MOJOs transform frames (use "
                         ".transform); they do not predict rows")

    def _score_raw(self, frame):
        self.predict(frame)


# -- ExtendedIsolationForest -------------------------------------------------

_EULER_MASCHERONI = 0.5772156649


def _eif_avg_path(n: float) -> float:
    """MathUtils.harmonicNumberEstimation-based c(n) (EIF paper eq. 2)."""
    if n < 2:
        return 0.0
    if n == 2:
        return 1.0
    return 2 * (math.log(n - 1) + _EULER_MASCHERONI) - 2.0 * (n - 1.0) / n


class RefExtendedIsoForModel(_RefModelBase):
    """Imported ExtendedIsolationForest MOJO: little-endian tree blobs of
    heap-indexed records — [i32 node, u8 'N'|'L'] + (NODE: k doubles n,
    k doubles p | LEAF: i32 num_rows); routing by dot(row - p, n) <= 0
    (``ExtendedIsolationForestMojoModel.java:59-122`` scoreTree0)."""

    algo = "extendedisolationforest"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.ntrees = int(_kv(info, "ntrees", 0))
        self.sample_size = int(_kv(info, "sample_size", 0))
        self.trees = [self._parse_tree(z.read(f"{prefix}trees/t{t:02d}.bin"))
                      for t in range(self.ntrees)]

    @staticmethod
    def _parse_tree(blob: bytes):
        """Dense heap-indexed arrays so scoring vectorizes across rows
        like the module's other tree importers: is_leaf mask, split
        normals/intercepts N/P, leaf row counts."""
        (k,) = struct.unpack_from("<i", blob, 0)
        pos = 4
        nodes = {}
        while pos < len(blob):
            num, typ = struct.unpack_from("<iB", blob, pos)
            pos += 5
            if typ == ord("N"):
                n = np.frombuffer(blob, "<f8", k, pos)
                p = np.frombuffer(blob, "<f8", k, pos + 8 * k)
                nodes[num] = ("N", n, p)
                pos += 16 * k
            elif typ == ord("L"):
                (rows,) = struct.unpack_from("<i", blob, pos)
                nodes[num] = ("L", rows)
                pos += 4
            else:
                raise ValueError(f"unknown EIF node type {typ}")
        size = max(nodes) + 1
        is_leaf = np.zeros(size, bool)
        N = np.zeros((size, k))
        P = np.zeros((size, k))
        leaf_rows = np.zeros(size)
        for num, nd in nodes.items():
            if nd[0] == "L":
                is_leaf[num] = True
                leaf_rows[num] = nd[1]
            else:
                N[num], P[num] = nd[1], nd[2]
        return dict(is_leaf=is_leaf, N=N, P=P, rows=leaf_rows, size=size)

    @property
    def is_classifier(self) -> bool:
        return False

    @staticmethod
    def _avg_path_vec(n: np.ndarray) -> np.ndarray:
        out = np.where(n < 2, 0.0, np.where(
            n == 2, 1.0,
            2 * (np.log(np.maximum(n - 1, 1)) + _EULER_MASCHERONI)
            - 2.0 * (n - 1.0) / np.maximum(n, 1)))
        return out

    def _tree_path_lengths(self, t: dict, X: np.ndarray) -> np.ndarray:
        """Vectorized level-by-level heap descent (the
        RefXGBoostModel._tree_scores pattern)."""
        n = X.shape[0]
        node = np.zeros(n, np.int64)
        height = np.zeros(n)
        for _ in range(t["size"] + 1):
            leaf = t["is_leaf"][node]
            if leaf.all():
                return height + self._avg_path_vec(t["rows"][node])
            mul = ((X - t["P"][node]) * t["N"][node]).sum(axis=1)
            nxt = np.where(mul <= 0, 2 * node + 1, 2 * node + 2)
            node = np.where(leaf, node, nxt)
            height = height + (~leaf)
        raise ValueError("cyclic EIF tree structure (corrupt blob)")

    def score(self, X: np.ndarray) -> np.ndarray:
        """[n, 2]: (anomaly_score, mean_length) — EIF paper eq. 1."""
        pl = np.zeros(X.shape[0])
        for t in self.trees:
            pl += self._tree_path_lengths(t, X)
        pl /= max(self.ntrees, 1)
        denom = _eif_avg_path(self.sample_size)
        score = 2.0 ** (-pl / denom) if denom > 0 else np.ones_like(pl)
        return np.stack([score, pl], 1)

    def _score_raw(self, frame) -> torch.Tensor:
        raw = self.score(self._design(frame))[:, 0].astype(np.float32)
        return torch.as_tensor(raw).to(frame.device)

    def predict(self, frame):
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.vec import Vec
        dev = frame.device
        raw = self.score(self._design(frame))
        return Frame(["anomaly_score", "mean_length"],
                     [Vec.from_numpy(raw[:, 0].astype(np.float32), device=dev),
                      Vec.from_numpy(raw[:, 1].astype(np.float32), device=dev)])


# -- XGBoost -----------------------------------------------------------------

class _XgbTree:
    __slots__ = ("cleft", "cright", "split_index", "default_left", "value")

    def __init__(self, cleft, cright, split_index, default_left, value):
        self.cleft, self.cright = cleft, cright
        self.split_index, self.default_left = split_index, default_left
        self.value = value                 # leaf value OR split condition


def _parse_booster(blob: bytes):
    """The pre-1.0 xgboost binary model format (the bytes H2O's
    ``XGBoostMojoWriter`` embeds as ``boosterBytes`` and scores through
    biz.k11i xgboost-predictor — ``XGBoostJavaMojoModel.java:63``):
    LearnerModelParam (136 B: f32 base_score, u32 num_feature, i32
    num_class, reserved), len-prefixed objective + booster names, then for
    gbtree/dart a GBTreeModelParam (160 B) and per tree a TreeParam
    (148 B) + nodes (20 B: parent, cleft, cright, sindex, value) + stats
    (16 B) + tree_info group ids.  Layout probed against the reference's
    own committed boosterBytes (offsets verified in tests)."""
    base_score, num_feature, num_class = struct.unpack_from("<fIi", blob, 0)
    pos = 136
    (ln,) = struct.unpack_from("<Q", blob, pos)
    obj = blob[pos + 8: pos + 8 + ln].decode()
    pos += 8 + ln
    (ln,) = struct.unpack_from("<Q", blob, pos)
    booster = blob[pos + 8: pos + 8 + ln].decode()
    pos += 8 + ln
    if booster not in ("gbtree", "dart"):
        raise ValueError(f"unsupported xgboost booster {booster!r}")
    num_trees, _roots, _nf, _pad = struct.unpack_from("<iiii", blob, pos)
    (num_output_group,) = struct.unpack_from("<i", blob, pos + 24)
    (size_leaf_vector,) = struct.unpack_from("<i", blob, pos + 28)
    pos += 160
    trees = []
    for _ in range(num_trees):
        _r, n_nodes, _d, _md, _nf2, slv = struct.unpack_from("<6i", blob, pos)
        pos += 148
        nodes = np.frombuffer(blob, "<i4", n_nodes * 5, pos).reshape(n_nodes, 5)
        vals = np.frombuffer(blob, "<f4", n_nodes * 5, pos).reshape(n_nodes, 5)
        pos += n_nodes * 20
        pos += n_nodes * 16                     # RTreeNodeStat
        if slv:
            # dmlc vector serialization: the u64 IS the total element
            # count (slv * num_nodes) — skip exactly that many f32s
            (lv,) = struct.unpack_from("<Q", blob, pos)
            pos += 8 + 4 * lv
        sindex = nodes[:, 3].astype(np.uint32)
        trees.append(_XgbTree(
            cleft=nodes[:, 1].copy(), cright=nodes[:, 2].copy(),
            split_index=(sindex & 0x7FFFFFFF).astype(np.int64),
            default_left=(sindex >> 31).astype(bool),
            value=vals[:, 4].copy().astype(np.float64)))
    tree_info = np.frombuffer(blob, "<i4", num_trees, pos)
    pos += 4 * num_trees
    weight_drop = None
    if booster == "dart":
        # std::vector<bst_float>: u64 count + f32 weights
        (lv,) = struct.unpack_from("<Q", blob, pos)
        weight_drop = np.frombuffer(blob, "<f4", lv, pos + 8
                                    ).astype(np.float64)
    return dict(base_score=float(base_score), num_feature=int(num_feature),
                num_class=int(num_class), objective=obj,
                trees=trees, tree_info=tree_info,
                num_output_group=max(1, int(num_output_group)),
                weight_drop=weight_drop)


class RefXGBoostModel(_RefModelBase):
    """Imported XGBoost MOJO: parse boosterBytes, score like the
    reference's xgboost-predictor path (``XGBoostJavaMojoModel.score0`` +
    ``OneHotEncoderFactory``: cats one-hot through GenModel.setCats, then
    nums; sparse mode maps 0/not-hot to NaN so they take default paths)."""

    algo = "xgboost"

    def __init__(self, z, prefix, info, columns, domains):
        super().__init__(info, columns, domains)
        self.cats = int(_kv(info, "cats", 0))
        self.nums = int(_kv(info, "nums", 0))
        self.cat_offsets = _kv_ints(info, "cat_offsets", np.zeros(1, np.int64))
        self.use_all_levels = _kv_bool(info, "use_all_factor_levels")
        self.sparse = _kv_bool(info, "sparse")
        self.booster = _parse_booster(z.read(prefix + "boosterBytes"))

    def _encode(self, X: np.ndarray) -> np.ndarray:
        """[n, catOffsets[cats] + nums] one-hot + raw nums; not-hot = 0
        (dense) or NaN (sparse), num 0 -> NaN under sparse."""
        n = X.shape[0]
        not_hot = np.nan if self.sparse else 0.0
        width = int(self.cat_offsets[self.cats]) + self.nums
        out = np.full((n, width), not_hot)
        for i in range(self.cats):
            d = X[:, i]
            lo, hi = int(self.cat_offsets[i]), int(self.cat_offsets[i + 1])
            c = np.trunc(np.nan_to_num(d, nan=0.0)).astype(np.int64)
            if self.use_all_levels:
                idx = c + lo
            else:
                idx = np.where(c != 0, c - 1 + lo, -1)
            idx = np.where(np.isnan(d), hi - 1, np.minimum(idx, hi - 1))
            rows = np.arange(n)
            hit = idx >= 0
            out[rows[hit], idx[hit]] = 1.0
        for j in range(self.nums):
            v = X[:, self.cats + j]
            if self.sparse:
                v = np.where(v == 0, np.nan, v)
            out[:, int(self.cat_offsets[self.cats]) + j] = v
        return out

    def _tree_scores(self, F: np.ndarray, t: _XgbTree) -> np.ndarray:
        n = F.shape[0]
        node = np.zeros(n, np.int64)
        # loop until every row reaches a leaf; each step strictly descends
        # the tree, so > num_nodes iterations means a cycle (corrupt blob)
        for _ in range(len(t.value) + 1):
            leaf = t.cleft[node] == -1
            if leaf.all():
                return t.value[node]
            f = F[np.arange(n), t.split_index[node]]
            is_na = np.isnan(f)
            go_left = np.where(is_na, t.default_left[node],
                               f < t.value[node])
            nxt = np.where(go_left, t.cleft[node], t.cright[node])
            node = np.where(leaf, node, nxt)
        raise ValueError("cyclic xgboost tree structure (corrupt booster)")

    def score(self, X: np.ndarray) -> np.ndarray:
        F = self._encode(X)
        b = self.booster
        k = b["num_output_group"]
        margins = np.full((X.shape[0], k), b["base_score"])
        for ti, t in enumerate(b["trees"]):
            w = 1.0 if b["weight_drop"] is None else b["weight_drop"][ti]
            margins[:, int(b["tree_info"][ti])] += w * self._tree_scores(F, t)
        obj = b["objective"]
        if obj.startswith(("binary:logistic", "reg:logistic")):
            p1 = 1.0 / (1.0 + np.exp(-margins[:, 0]))
            return np.stack([1 - p1, p1], 1)
        if obj.startswith("multi:"):
            z = margins - margins.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        if obj.startswith("count:") or obj.startswith("reg:gamma") \
                or obj.startswith("reg:tweedie"):
            return np.exp(margins[:, 0])
        return margins[:, 0]                    # reg:squarederror/linear


# -- dispatch ----------------------------------------------------------------

EXT_ALGOS = ("deeplearning", "pca", "glrm", "coxph", "word2vec",
             "isotonicregression", "rulefit", "targetencoder", "xgboost",
             "extendedisolationforest")


def load_ext_family(algo, z, prefix, info, columns, domains, load_sub):
    """Dispatch hook called from ``mojo_ref._load_from_zip`` for the
    part-2 families.  ``load_sub(prefix)`` loads a nested submodel from the
    same archive (MultiModelMojoReader layout)."""
    if algo == "deeplearning":
        return RefDeepLearningModel(info, columns, domains)
    if algo == "pca":
        return RefPCAModel(z, prefix, info, columns, domains)
    if algo == "glrm":
        return RefGlrmModel(z, prefix, info, columns, domains)
    if algo == "coxph":
        return RefCoxPHModel(z, prefix, info, columns, domains)
    if algo == "word2vec":
        return RefWord2VecModel(z, prefix, info, columns, domains)
    if algo == "isotonicregression":
        return RefIsotonicModel(z, prefix, info, columns, domains)
    if algo == "rulefit":
        # MultiModelMojoReader layout (same grammar as StackedEnsemble in
        # mojo_ref); only the named linear model is needed for scoring
        target = _kv(info, "linear_model")
        linear = None
        for i in range(int(_kv(info, "submodel_count", 0))):
            if _kv(info, f"submodel_key_{i}") == target:
                linear = load_sub(prefix + _kv(info, f"submodel_dir_{i}"))
                break
        if linear is None:
            raise ValueError("rulefit MOJO names a linear model that is "
                             "not among its submodels")
        return RefRuleFitModel(info, columns, domains, linear)
    if algo == "targetencoder":
        return RefTargetEncoderModel(z, prefix, info, columns, domains)
    if algo == "xgboost":
        return RefXGBoostModel(z, prefix, info, columns, domains)
    if algo == "extendedisolationforest":
        return RefExtendedIsoForModel(z, prefix, info, columns, domains)
    return None
