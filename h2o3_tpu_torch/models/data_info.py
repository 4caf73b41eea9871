"""DataInfo — a frame as a model-ready design matrix — and the response and
domain handling of training and scoring: the port of
``h2o3_tpu/models/data_info.py`` (reference: ``hex/DataInfo.java``).

The design lays out one-hot blocks of the categorical columns first, then
the numeric columns standardised (``use_all_factor_levels``,
``DataInfo.java:112``; ``_normMul``, ``:120``; mean imputation, ``:149``).
A test frame is adapted to the training layout by level name
(``Model.adaptTestForTrain``): unseen levels become missing, and a missing
level gives an all-zero block. :meth:`DataInfo.expand` writes the dense
float32 [rows, P] design in place into one zeroed tensor, so that no
second [rows, P] temporary exists beside it at any width.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from h2o3_tpu_torch.frame.types import VecType


@dataclasses.dataclass
class DataInfo:
    cat_cols: list[str]
    num_cols: list[str]
    cat_domains: list[tuple[str, ...]]     # train-time domains, layout order
    cat_offsets: np.ndarray                # start of each cat block in X
    num_means: np.ndarray                  # imputation values
    num_mul: np.ndarray                    # 1/sigma (or 1) per numeric col
    num_sub: np.ndarray                    # mean (or 0) per numeric col
    use_all_factor_levels: bool
    standardize: bool
    ncats_expanded: int

    @property
    def ncols_expanded(self) -> int:
        return self.ncats_expanded + len(self.num_cols)

    @property
    def coef_names(self) -> list[str]:
        lo = 0 if self.use_all_factor_levels else 1
        names = [f"{col}.{lvl}" for col, dom in zip(self.cat_cols,
                                                    self.cat_domains)
                 for lvl in dom[lo:]]
        return names + list(self.num_cols)

    @staticmethod
    def make(frame, x: list[str], standardize: bool = True,
             use_all_factor_levels: bool = False) -> "DataInfo":
        """The layout and the numeric columns' imputation and scaling from
        the training frame's rollups (mean and sigma over finite values)."""
        cat_cols = [c for c in x if frame.vec(c).is_categorical]
        num_cols = [c for c in x if not frame.vec(c).is_categorical]
        for c in num_cols:
            if not frame.vec(c).type.on_device:
                raise TypeError(f"column {c!r} has type {frame.vec(c).type}; "
                                "not trainable")
        cat_domains = [frame.vec(c).domain for c in cat_cols]
        offs, k = [], 0
        for dom in cat_domains:
            offs.append(k)
            k += len(dom) if use_all_factor_levels else max(len(dom) - 1, 0)
        means = np.array([frame.vec(c).mean() for c in num_cols], np.float32)
        sigmas = np.array([frame.vec(c).sigma() for c in num_cols],
                          np.float32)
        means = np.nan_to_num(means)
        mul = np.where((sigmas > 0) & np.isfinite(sigmas),
                       1.0 / np.maximum(sigmas, 1e-30), 1.0).astype(
            np.float32) if standardize else np.ones_like(means)
        sub = means if standardize else np.zeros_like(means)
        return DataInfo(cat_cols, num_cols, cat_domains,
                        np.array(offs, np.int32), means, mul, sub,
                        use_all_factor_levels, standardize, k)

    def expand(self, frame) -> torch.Tensor:
        """The [rows, P] float32 design on the frame's device; categorical
        levels adapted to the training domains by name."""
        dev = frame.device
        X = torch.zeros((frame.local_nrows, self.ncols_expanded),
                        dtype=torch.float32, device=dev)
        lo = 0 if self.use_all_factor_levels else 1
        rows = torch.arange(frame.local_nrows, device=dev)
        for col, dom, off in zip(self.cat_cols, self.cat_domains,
                                 self.cat_offsets):
            v = frame.vec(col)
            if v.type is not VecType.CAT:
                raise TypeError(f"column {col!r} must be categorical at "
                                "scoring time")
            codes = v.data
            if v.domain != dom:
                codes = remap_codes(codes, v.domain or (), dom)
            if len(dom) - lo <= 0:
                continue
            # each row writes one element of its own block: a one at its
            # level's column, or (dropped first level, missing level) a zero
            # at the block's first column, so the indices never collide
            ok = codes >= lo
            j = torch.where(ok, codes.long() + (int(off) - lo), int(off))
            X.view(-1).index_put_((rows * self.ncols_expanded + j,),
                                  ok.float())
        s0 = self.ncats_expanded
        for i, col in enumerate(self.num_cols):
            x = frame.vec(col).data
            # mean imputation always (reference MeanImputation), whether or
            # not the column is standardised (sub is 0 when it is not)
            imputed = torch.where(torch.isnan(x), float(self.num_means[i]), x)
            X[:, s0 + i] = (imputed - float(self.num_sub[i])) \
                * float(self.num_mul[i])
        return X

    def response(self, frame, y: str) -> tuple[torch.Tensor, int]:
        """Response column as float32 (codes for categorical) and its number
        of classes (0 for regression)."""
        v = frame.vec(y)
        if v.is_categorical:
            return v.data.float(), v.cardinality()
        return v.data, 0


def response_as_float(vec) -> tuple[torch.Tensor, torch.Tensor]:
    """Response as float32 + per-row validity mask — THE canonical NA
    semantics for supervised training and metrics (categorical code -1 and
    numeric NaN are missing)."""
    if vec.is_categorical:
        return vec.data.float(), vec.data >= 0
    return vec.data, ~torch.isnan(vec.data)


def remap_codes(codes: torch.Tensor, src_dom: tuple[str, ...],
                dst_dom: tuple[str, ...]) -> torch.Tensor:
    """Categorical codes of domain ``src_dom`` as codes of ``dst_dom``: a
    level ``dst_dom`` lacks, and a missing code, give -1 (reference:
    ``Model.adaptTestForTrain``'s domain mapping)."""
    dst = {s: i for i, s in enumerate(dst_dom)}
    lut = torch.tensor([dst.get(s, -1) for s in src_dom] or [-1],
                       dtype=torch.int32, device=codes.device)
    return torch.where(codes >= 0, lut[codes.clamp(0, lut.numel() - 1)
                                       .long()], -1)


def response_adapted(vec, train_domain) -> tuple[torch.Tensor, torch.Tensor]:
    """Response as float32 + validity, remapped to the training domain
    where a frame's categorical levels differ (unseen levels are
    invalid); else :func:`response_as_float`."""
    if train_domain and vec.is_categorical and vec.domain != train_domain:
        codes = remap_codes(vec.data, vec.domain or (), train_domain)
        return codes.float(), codes >= 0
    return response_as_float(vec)


#: the most levels a crossed factor keeps (the rest pool into "other";
#: reference ``h2o.interaction``'s ``max_factors`` default)
MAX_CROSS_LEVELS = 100


def _cross_factor(va, vb):
    """The level cross of two categorical columns (reference:
    ``CreateInteractions``, as ``frame/utils.py:interaction`` with
    ``pairwise=True``): labels ``a_b``, the domain ranked by frequency (ties
    by label), at most :data:`MAX_CROSS_LEVELS` kept, the rest "other"; a
    row missing either level is missing."""
    from h2o3_tpu_torch.frame.vec import Vec
    ca, cb = va.data.long(), vb.data.long()
    nb = max(len(vb.domain or ()), 1)
    valid = (ca >= 0) & (cb >= 0)
    key = torch.where(valid, ca * nb + cb, 0)
    counts = torch.bincount(key[valid], minlength=len(va.domain or ()) * nb)
    occurring = torch.nonzero(counts).flatten().tolist()
    cnt_host = counts.cpu().numpy()
    by_label: dict[str, int] = {}
    for k in occurring:
        lbl = f"{va.domain[k // nb]}_{vb.domain[k % nb]}"
        by_label[lbl] = by_label.get(lbl, 0) + int(cnt_host[k])
    ranked = sorted(by_label, key=lambda s: (-by_label[s], s))
    kept = ranked[:MAX_CROSS_LEVELS]
    dom = tuple(kept + (["other"] if len(ranked) > MAX_CROSS_LEVELS else []))
    lut_idx = {lvl: i for i, lvl in enumerate(dom)}
    other = lut_idx.get("other", -1)
    lut = np.full(max(len(counts), 1), -1, np.int32)
    for k in occurring:
        lut[k] = lut_idx.get(f"{va.domain[k // nb]}_{vb.domain[k % nb]}",
                             other)
    codes = torch.as_tensor(lut).to(ca.device)[key]
    return Vec(torch.where(valid, codes, -1).to(torch.int32), VecType.CAT,
               domain=dom)


def expand_interactions(frame, interactions: list[str], domains=None):
    """Pairwise interaction columns among ``interactions`` (reference:
    ``hex/DataInfo.java`` interactions / ``CreateInteractions``):

    - num × num → elementwise product column ``a_b``
    - cat × num → one numeric column per level: ``cat.lvl_a_b`` (the
      indicator times the numeric value, NaN taken as 0)
    - cat × cat → combined factor ``a_b`` (level cross)

    Returns an extended frame (originals untouched); training and scoring
    both come through here. ``domains`` (``{col: train_domain}``, captured
    at training) pins the cat × num column set: a scoring frame missing a
    training level still produces its column, all zero."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec
    domains = domains or {}
    names, vecs = list(frame.names), list(frame.vecs)
    for a, b in itertools.combinations(interactions, 2):
        va, vb = frame.vec(a), frame.vec(b)
        name = f"{a}_{b}"
        if va.is_categorical and vb.is_categorical:
            names.append(name)
            vecs.append(_cross_factor(va, vb))
        elif not va.is_categorical and not vb.is_categorical:
            names.append(name)
            vecs.append(Vec(va.as_float() * vb.as_float(), VecType.NUM))
        else:
            cat, num = (va, vb) if va.is_categorical else (vb, va)
            cname = a if va.is_categorical else b
            dom = tuple(domains.get(cname, cat.domain or ()))
            codes = cat.data
            if cat.domain != dom:
                codes = remap_codes(codes, cat.domain or (), dom)
            numv = torch.nan_to_num(num.as_float(), nan=0.0)
            for li, lvl in enumerate(dom):
                names.append(f"{cname}.{lvl}_{name}")
                vecs.append(Vec((codes == li).float() * numv, VecType.NUM))
    return Frame(names, vecs, key=frame.key)
