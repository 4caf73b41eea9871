"""POJO-equivalent codegen: standalone, dependency-light scoring source —
the port of ``h2o3_tpu/genmodel/codegen.py``.

Reference: ``water/codegen/`` + ``hex/tree/TreeJCodeGen.java`` generate a
self-contained Java class whose ``score0(double[] data)`` reproduces the
model without the runtime. Here the generated source is a self-contained
**numpy-only Python module**, the same source the JAX package generates:
it imports neither package, embeds the arrays as literals (read from the
model's tensors with ``.cpu().numpy()``) and has ``score(row_dict)`` and
``score_batch(ndarray)`` entry points. It scores on the host, in float64.

Supported: GBM / DRF (tree ensembles incl. multinomial), GLM, KMeans —
the same families the reference ships POJO writers for.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array as host numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _arr(a: np.ndarray, name: str, indent: str = "") -> str:
    """Compact literal for an embedded array."""
    flat = np.asarray(a)
    body = np.array2string(flat, separator=",", threshold=np.inf,
                           max_line_width=100,
                           floatmode="unique").replace("\n", "\n" + indent)
    dt = "np.float32" if flat.dtype.kind == "f" else (
        "bool" if flat.dtype.kind == "b" else "np.int32")
    return f"{name} = np.array({body}, dtype={dt})"


def _tree_arrays(trees) -> dict[str, np.ndarray]:
    stack = lambda attr: np.stack([_host(getattr(t, attr)) for t in trees])
    out = dict(FEAT=stack("feat"), TV=stack("thresh_val"), NA=stack("na_left"),
               SP=stack("is_split"), LEAF=stack("leaf"))
    if getattr(trees[0], "left_mask", None) is not None:
        out["MASK"] = stack("left_mask")
    return out


_TREE_TRAVERSE = '''
def _tree_sum(X, FEAT, TV, NA, SP, LEAF, MASK=None):
    n = X.shape[0]
    acc = np.zeros(n, np.float64)
    depth = int(np.log2(FEAT.shape[1] + 1)) - 1
    for t in range(FEAT.shape[0]):
        idx = np.zeros(n, np.int64)
        for _ in range(depth):
            f = np.maximum(FEAT[t][idx], 0)
            x = X[np.arange(n), f]
            if MASK is None:
                left = np.where(np.isnan(x), NA[t][idx], x < TV[t][idx])
            else:
                # categorical group splits: route codes by bin membership
                code = np.nan_to_num(x, nan=0.0).astype(np.int64)
                card = CAT_CARD[f]
                b = np.where(card > NBINS_CAT,
                             (code * NBINS_CAT) // np.maximum(card, 1), code)
                b = np.clip(b, 0, MASK.shape[2] - 1)
                is_cat = card > 0
                left_cat = MASK[t][idx, b]
                left = np.where(np.isnan(x), NA[t][idx],
                                np.where(is_cat, left_cat, x < TV[t][idx]))
            nxt = idx * 2 + np.where(left, 1, 2)
            idx = np.where(SP[t][idx], nxt, idx)
        acc += LEAF[t][idx]
    return acc
'''

_PROLOGUE = '''"""Standalone scoring module generated by h2o3_tpu (POJO equivalent).

Only dependency: numpy. Entry points:
  score_batch(X)  -> ndarray predictions ([n] regression, [n, K] class probs)
  score(row)      -> single-row dict in, prediction out
"""
import numpy as np

'''

_ROW_HELPERS = '''
def _row_to_x(row):
    x = np.full(len(COLUMNS), np.nan, np.float64)
    for i, c in enumerate(COLUMNS):
        v = row.get(c)
        if v is None:
            continue
        if i in CAT_MAP:
            x[i] = CAT_MAP[i].get(str(v), -1)
            if x[i] < 0:
                x[i] = np.nan
        else:
            x[i] = float(v)
    return x


def score(row):
    out = score_batch(_row_to_x(row)[None, :])
    return out[0]
'''


def _cat_map_literal(x_cols, feat_domains) -> str:
    maps = {}
    for i, c in enumerate(x_cols):
        dom = feat_domains.get(c)
        if dom:
            maps[i] = {lvl: j for j, lvl in enumerate(dom)}
    return f"CAT_MAP = {maps!r}"


def generate_tree_model(model) -> str:
    """GBM/DRF source. Reference: TreeJCodeGen (forest as nested ifs); here
    the dense-heap traversal loops over embedded arrays instead."""
    o = model.output
    dist = o["distribution"]
    grouped = o.get("cat_card") is not None
    lines = [_PROLOGUE,
             f"COLUMNS = {list(o['x_cols'])!r}",
             _cat_map_literal(o["x_cols"], o["feat_domains"]),
             f"DOMAIN = {list(model.response_domain) if model.response_domain else None!r}"]
    if grouped:
        cc = _host(o["cat_card"]).astype(np.int64)
        lines.append(_arr(cc, "CAT_CARD"))
        lines.append(f"NBINS_CAT = {int(o.get('cat_bins') or 0)!r}")
    else:
        lines.append("CAT_CARD = None")
        lines.append("NBINS_CAT = 0")
    lines.append(_TREE_TRAVERSE)
    msfx = ", MASK" if grouped else ""
    if o.get("trees_multi") is not None:
        K = len(o["trees_multi"])
        for k, ts in enumerate(o["trees_multi"]):
            for nm, a in _tree_arrays(ts).items():
                lines.append(_arr(a, f"{nm}_{k}"))
        f0 = _host(o["f0_multi"]) if o.get("f0_multi") is not None \
            else np.zeros(K)
        f0 = f0.astype(np.float64)
        lines.append(_arr(f0.astype(np.float32), "F0"))
        lines.append(f"LR = {float(o.get('learn_rate', 1.0))!r}")
        lines.append(f"NTREES = {int(o['ntrees'])!r}")
        kd = ", ".join(
            f"_tree_sum(X, FEAT_{k}, TV_{k}, NA_{k}, SP_{k}, LEAF_{k}"
            + (f", MASK_{k}" if grouped else "") + ")"
            for k in range(K))
        if model.algo == "drf":
            body = f'''
def score_batch(X):
    X = np.asarray(X, np.float64)
    raw = np.stack([{kd}], axis=1)
    probs = np.clip(raw / max(NTREES, 1), 0.0, 1.0)
    return probs / np.maximum(probs.sum(axis=1, keepdims=True), 1e-30)
'''
        else:
            body = f'''
def score_batch(X):
    X = np.asarray(X, np.float64)
    f = F0[None, :] + LR * np.stack([{kd}], axis=1)
    e = np.exp(f - f.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)
'''
        lines.append(body)
    else:
        for nm, a in _tree_arrays(o["trees"]).items():
            lines.append(_arr(a, nm))
        lines.append(f"F0 = {float(o.get('f0', 0.0))!r}")
        lines.append(f"LR = {float(o.get('learn_rate', 1.0))!r}")
        lines.append(f"NTREES = {int(o['ntrees'])!r}")
        if model.algo == "drf":
            if o.get("binomial"):
                body = '''
def score_batch(X):
    X = np.asarray(X, np.float64)
    p = np.clip(_tree_sum(X, FEAT, TV, NA, SP, LEAF{m}) / max(NTREES, 1), 0.0, 1.0)
    return np.stack([1 - p, p], axis=1)
'''
            else:
                body = '''
def score_batch(X):
    X = np.asarray(X, np.float64)
    return _tree_sum(X, FEAT, TV, NA, SP, LEAF{m}) / max(NTREES, 1)
'''
        elif dist == "bernoulli":
            body = '''
def score_batch(X):
    X = np.asarray(X, np.float64)
    f = F0 + LR * _tree_sum(X, FEAT, TV, NA, SP, LEAF{m})
    p = 1.0 / (1.0 + np.exp(-f))
    return np.stack([1 - p, p], axis=1)
'''
        elif dist in ("poisson", "gamma", "tweedie"):   # log link
            body = '''
def score_batch(X):
    X = np.asarray(X, np.float64)
    return np.exp(np.clip(F0 + LR * _tree_sum(X, FEAT, TV, NA, SP, LEAF{m}), -30, 30))
'''
        else:
            body = '''
def score_batch(X):
    X = np.asarray(X, np.float64)
    return F0 + LR * _tree_sum(X, FEAT, TV, NA, SP, LEAF{m})
'''
        lines.append(body.format(m=msfx))
    lines.append(_ROW_HELPERS)
    return "\n".join(lines)


def generate_glm_model(model) -> str:
    """GLM source: standardization + one-hot expansion + link inverse
    (reference: GLM POJO via water/codegen)."""
    di = model.data_info
    beta = _host(model.output["beta"]).astype(np.float64)
    fam = str(model.params["family"])
    lines = [_PROLOGUE,
             f"CAT_COLS = {list(di.cat_cols)!r}",
             f"NUM_COLS = {list(di.num_cols)!r}",
             f"CAT_DOMAINS = {[list(d) for d in di.cat_domains]!r}",
             f"USE_ALL = {bool(di.use_all_factor_levels)!r}",
             f"COLUMNS = {list(di.cat_cols) + list(di.num_cols)!r}",
             "CAT_MAP = {i: {l: j for j, l in enumerate(CAT_DOMAINS[i])} "
             "for i in range(len(CAT_COLS))}",
             _arr(np.asarray(di.num_means, np.float32), "NUM_MEANS"),
             _arr(np.asarray(di.num_sub, np.float32), "NUM_SUB"),
             _arr(np.asarray(di.num_mul, np.float32), "NUM_MUL"),
             _arr(beta.astype(np.float32), "BETA"),
             f"FAMILY = {fam!r}",
             f"DOMAIN = {list(model.response_domain) if model.response_domain else None!r}"]
    lines.append('''
def _expand(X):
    # X columns ordered CAT_COLS + NUM_COLS (codes / raw numerics)
    n = X.shape[0]
    parts = []
    for i in range(len(CAT_COLS)):
        card = len(CAT_DOMAINS[i])
        lo = 0 if USE_ALL else 1
        c = X[:, i]
        oh = np.zeros((n, card - lo), np.float64)
        ok = ~np.isnan(c)
        cc = np.where(ok, c, 0).astype(np.int64)
        for j in range(lo, card):
            oh[:, j - lo] = np.where(ok & (cc == j), 1.0, 0.0)
        parts.append(oh)
    nums = X[:, len(CAT_COLS):].copy()
    for j in range(nums.shape[1]):
        col = nums[:, j]
        col = np.where(np.isnan(col), NUM_MEANS[j], col)
        nums[:, j] = (col - NUM_SUB[j]) * NUM_MUL[j]
    parts.append(nums)
    return np.concatenate(parts, axis=1) if parts else np.zeros((n, 0))


def score_batch(X):
    X = np.asarray(X, np.float64)
    E = _expand(X)
    if BETA.ndim == 2:      # multinomial
        eta = E @ BETA[:-1, :] + BETA[-1, :]
        ex = np.exp(eta - eta.max(axis=1, keepdims=True))
        return ex / ex.sum(axis=1, keepdims=True)
    eta = E @ BETA[:-1] + BETA[-1]
    if FAMILY == "binomial":
        p = 1.0 / (1.0 + np.exp(-eta))
        return np.stack([1 - p, p], axis=1)
    if FAMILY in ("poisson", "gamma", "tweedie"):
        return np.exp(eta)
    return eta
''')
    lines.append(_ROW_HELPERS)
    return "\n".join(lines)


def generate_kmeans_model(model) -> str:
    centers = _host(model.output["centers_std"]
                    if "centers_std" in model.output
                    else model.output["centers"]).astype(np.float64)
    di = model.data_info
    lines = [_PROLOGUE,
             f"COLUMNS = {list(di.cat_cols) + list(di.num_cols)!r}",
             f"CAT_MAP = {{i: {{l: j for j, l in enumerate(d)}} for i, d in enumerate({[list(d) for d in di.cat_domains]!r})}}",
             f"CAT_DOMAINS = {[list(d) for d in di.cat_domains]!r}",
             f"USE_ALL = {bool(di.use_all_factor_levels)!r}",
             _arr(np.asarray(di.num_means, np.float32), "NUM_MEANS"),
             _arr(np.asarray(di.num_sub, np.float32), "NUM_SUB"),
             _arr(np.asarray(di.num_mul, np.float32), "NUM_MUL"),
             f"N_CATS = {len(di.cat_cols)!r}",
             _arr(centers.astype(np.float32), "CENTERS")]
    lines.append('''
def _expand(X):
    n = X.shape[0]
    parts = []
    for i in range(N_CATS):
        card = len(CAT_DOMAINS[i])
        lo = 0 if USE_ALL else 1
        c = X[:, i]
        oh = np.zeros((n, card - lo), np.float64)
        ok = ~np.isnan(c)
        cc = np.where(ok, c, 0).astype(np.int64)
        for j in range(lo, card):
            oh[:, j - lo] = np.where(ok & (cc == j), 1.0, 0.0)
        parts.append(oh)
    nums = X[:, N_CATS:].copy()
    for j in range(nums.shape[1]):
        col = nums[:, j]
        col = np.where(np.isnan(col), NUM_MEANS[j], col)
        nums[:, j] = (col - NUM_SUB[j]) * NUM_MUL[j]
    parts.append(nums)
    return np.concatenate(parts, axis=1) if parts else np.zeros((n, 0))


def score_batch(X):
    E = _expand(np.asarray(X, np.float64))
    d2 = ((E[:, None, :] - CENTERS[None, :, :]) ** 2).sum(axis=2)
    return np.argmin(d2, axis=1)
''')
    lines.append(_ROW_HELPERS)
    return "\n".join(lines)


def generate_pojo(model) -> str:
    """Dispatch by algo (reference: ``Model.toJava``; h2o-py
    ``download_pojo``)."""
    if model.algo in ("gbm", "drf"):
        return generate_tree_model(model)
    if model.algo == "glm":
        return generate_glm_model(model)
    if model.algo == "kmeans":
        return generate_kmeans_model(model)
    raise ValueError(f"no standalone codegen for algo {model.algo!r} "
                     "(reference POJO support: tree models, GLM, KMeans)")


def download_pojo(model, path: str) -> str:
    src = generate_pojo(model)
    with open(path, "w") as f:
        f.write(src)
    return path
