"""RuleFit — rules from a tree ensemble and a sparse linear model over
them — the port of ``h2o3_tpu/models/rulefit.py`` (reference:
``hex/rulefit/RuleFit.java``, Friedman & Popescu: GBMs over a ladder of
depths, every tree node a conjunctive rule, the 0/1 rule-activation
matrix, then an L1 GLM over the rules and optionally the linear terms).

The trees are the port's GBM (its histogram kernels on the card), with
``categorical_encoding="ordinal"`` so that every split is a threshold.
The split fields of all trees are fetched once; the node memberships are
then a sweep down each heap on the device, written node-major ([heap,
rows]: one contiguous row a node). The rule matrix is laid out once as
[columns, rows] float32, and the level-1 frame's columns are its rows
(views, not copies).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.gbm import GBM, tree_columns
from h2o3_tpu_torch.models.glm import GLM, full_fp32
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key

#: the split fields a rule reads from a tree
RULE_FIELDS = ("feat", "thresh_val", "na_left", "is_split")


def _host_fields(trees) -> list[dict]:
    """Each tree's split fields as numpy arrays, from one fetch for all
    trees (float64 holds the int32 features and float32 thresholds
    exactly)."""
    if not trees:
        return []
    flat = torch.cat([torch.stack([getattr(t, f).double() for f in
                                   RULE_FIELDS]) for t in trees], dim=1)
    host = flat.cpu().numpy()
    out, pos = [], 0
    for t in trees:
        heap = t.feat.shape[0]
        block = host[:, pos:pos + heap]
        out.append(dict(feat=block[0].astype(np.int32),
                        thresh_val=block[1].astype(np.float32),
                        na_left=block[2] > 0, is_split=block[3] > 0))
        pos += heap
    return out


def _feature_rows(frame: Frame, cols: list[str],
                  domains: dict[str, tuple]) -> torch.Tensor:
    """[F, rows] raw float32 features, one contiguous row a feature
    (:func:`gbm.tree_columns`)."""
    return torch.stack(tree_columns(frame, cols, domains), dim=0)


def _node_masks(XT: torch.Tensor, fields: dict) -> torch.Tensor:
    """[heap, rows] node membership of one dense-heap tree: the root holds
    every row; a child holds its parent's rows that take its side of the
    split (``fields``: the tree's split fields on the host)."""
    feat, tv = fields["feat"], fields["thresh_val"]
    nal, isp = fields["na_left"], fields["is_split"]
    heap = len(feat)
    masks = torch.zeros((heap, XT.shape[1]), dtype=torch.bool,
                        device=XT.device)
    masks[0] = True
    for i in range(heap // 2):
        if not isp[i]:
            continue          # a leaf: its children hold no rows
        xv = XT[max(int(feat[i]), 0)]
        go_left = torch.where(torch.isnan(xv), bool(nal[i]),
                              xv < float(tv[i]))
        masks[2 * i + 1] = masks[i] & go_left
        masks[2 * i + 2] = masks[i] & ~go_left
    return masks


def _rule_masks(XT: torch.Tensor, fields: list[dict]) -> torch.Tensor:
    """[rules, rows] activations: every tree's non-root nodes in order."""
    return torch.cat([_node_masks(XT, f)[1:] for f in fields], dim=0)


def _standardised(XT, lin_mean, lin_sd) -> torch.Tensor:
    """The linear terms: (x - mean) / sd, missing as 0."""
    mean = torch.as_tensor(np.asarray(lin_mean, np.float32)).to(XT.device)
    sd = torch.as_tensor(np.asarray(lin_sd, np.float32)).to(XT.device)
    lin = (XT - mean[:, None]) / sd[:, None]
    return torch.where(torch.isnan(lin), 0.0, lin)


class RuleFitModel(Model):
    algo = "rulefit"

    def _rule_matrix(self, frame: Frame) -> torch.Tensor:
        """[columns, rows] float32: the kept rules' activations, then the
        standardised linear terms."""
        o = self.output
        XT = _feature_rows(frame, o["x_cols"], o["feat_domains"])
        parts = []
        if o["model_type"] != "linear":
            keep = torch.as_tensor(np.nonzero(o["rule_keep"])[0]).to(
                XT.device)
            parts.append(_rule_masks(XT, _host_fields(o["trees"]))[keep]
                         .float())
        if o["model_type"] in ("linear", "rules_and_linear"):
            parts.append(_standardised(XT, o["lin_mean"], o["lin_sd"]))
        return torch.cat(parts, dim=0)

    def _score_raw(self, frame: Frame):
        M = self._rule_matrix(frame)
        beta = torch.as_tensor(np.asarray(self.output["beta"],
                                          np.float32)).to(M.device)
        with full_fp32():
            eta = beta[:-1] @ M + beta[-1]
        if self.nclasses == 2:
            p = torch.sigmoid(eta)
            return torch.stack([1 - p, p], dim=1)
        return eta

    def rule_importance(self) -> list[tuple[str, float]]:
        """Non-zero rules by |coefficient| (reference: the significant
        rules table)."""
        o = self.output
        out = [(d, float(c)) for d, c in zip(o["rule_names"], o["beta"][:-1])
               if abs(float(c)) > 1e-8]
        return sorted(out, key=lambda t: -abs(t[1]))


class RuleFit(ModelBuilder):
    """h2o-py surface: ``H2ORuleFitEstimator``."""

    algo = "rulefit"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            model_type="rules_and_linear",   # or rules, linear
            min_rule_length=1,
            max_rule_length=3,
            rule_generation_ntrees=10,       # trees per depth (reference: 50)
            lambda_=1e-3,                    # L1 strength of rule selection
            max_num_rules=-1,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> RuleFitModel:
        self._refuse_checkpoint()
        p = self.params
        model_type = p["model_type"]
        if model_type not in ("rules", "linear", "rules_and_linear"):
            raise ValueError(f"model_type {model_type!r}: rules, linear or "
                             "rules_and_linear")
        yvec = frame.vec(y)
        binom = yvec.is_categorical
        if binom and yvec.cardinality() != 2:
            raise ValueError("RuleFit supports binary classification or "
                             "regression")

        # 1) the tree ensemble over the depth ladder (one model a depth)
        trees = []
        lo, hi = int(p["min_rule_length"]), int(p["max_rule_length"])
        for d in range(lo, hi + 1):
            # ordinal categorical encoding: rules read threshold splits
            gbm = GBM(ntrees=int(p["rule_generation_ntrees"]), max_depth=d,
                      learn_rate=0.1, seed=int(p.get("seed") or 0) + d,
                      categorical_encoding="ordinal") \
                .train(x=list(x), y=y, training_frame=frame, weights=weights)
            trees.extend(gbm.output["trees"])
            job.update(0.3 * (d - lo + 1) / (hi - lo + 1), f"depth {d} trees")
        feat_domains = {c: frame.vec(c).domain for c in x
                        if frame.vec(c).is_categorical}

        # 2) the rule activations, dropping rules that hold (almost) no
        # row or (almost) every row
        XT = _feature_rows(frame, x, feat_domains)
        fields = _host_fields(trees)
        masks = _rule_masks(XT, fields)
        n = frame.nrows
        frac = masks.sum(dim=1, dtype=torch.int64).float() / float(n)
        keep = ((frac > 0.005) & (frac < 0.995)).cpu().numpy()
        max_rules = int(p["max_num_rules"])
        if max_rules > 0 and keep.sum() > max_rules:
            idx = np.nonzero(keep)[0]
            keep[:] = False
            keep[idx[:max_rules]] = True
        all_names = []
        for ti, f in enumerate(fields):
            all_names.extend(_rule_names_for_tree(f, x, ti))
        rule_names = [nm for nm, k in zip(all_names, keep) if k]

        lin_mean = np.zeros(len(x), np.float32)
        lin_sd = np.ones(len(x), np.float32)
        linear = model_type in ("linear", "rules_and_linear")
        if linear:
            ok = ~torch.isnan(XT)
            cnt = ok.sum(1).float()
            mean = torch.where(ok, XT, 0.0).sum(1) / cnt
            dev = torch.where(ok, XT - mean[:, None], 0.0)
            sd = torch.sqrt((dev * dev).sum(1) / cnt)
            lin_mean, lin_sd = torch.stack([mean, sd]).cpu().numpy()
            lin_sd = np.maximum(lin_sd, 1e-6)
            rule_names = (rule_names if model_type != "linear" else []) + \
                [f"linear.{c}" for c in x]

        # the matrix laid out once: [columns, rows], a column's Vec a row
        n_rules = int(keep.sum()) if model_type != "linear" else 0
        M = torch.empty((n_rules + (len(x) if linear else 0), n),
                        dtype=torch.float32, device=XT.device)
        if n_rules:
            M[:n_rules] = masks[torch.as_tensor(np.nonzero(keep)[0]).to(
                XT.device)]
        del masks
        if linear:
            M[n_rules:] = _standardised(XT, lin_mean, lin_sd)
        del XT

        # 3) the L1 GLM on the rule matrix (reference: GLM alpha = 1)
        names = [f"r{i}" for i in range(M.shape[0])]
        lvl1 = Frame(names + [y], [Vec(M[i], VecType.NUM)
                                   for i in range(M.shape[0])] + [yvec])
        glm = GLM(family="binomial" if binom else "gaussian", alpha=1.0,
                  lambda_=float(p["lambda_"]), standardize=False) \
            .train(x=names, y=y, training_frame=lvl1, weights=weights)
        beta = np.asarray(glm.output["coef"], np.float64)

        if model_type == "linear":
            trees = []   # a linear model never traverses its trees
        return RuleFitModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, response_column=y,
            response_domain=yvec.domain if binom else None,
            output=dict(trees=trees, x_cols=list(x), feat_domains=feat_domains,
                        rule_keep=keep, rule_names=rule_names, beta=beta,
                        model_type=model_type,
                        lin_mean=np.asarray(lin_mean, np.float32),
                        lin_sd=np.asarray(lin_sd, np.float32),
                        glm_key=glm.key))


def _rule_names_for_tree(fields: dict, names, ti: int) -> list[str]:
    """Each non-root node's rule: the conjunction of the splits down to it
    (``fields``: the tree's split fields on the host)."""
    feat, tv = fields["feat"], fields["thresh_val"]
    nal, isp = fields["na_left"], fields["is_split"]
    heap = len(feat)
    conds: dict[int, list[str]] = {0: []}
    for i in range(heap // 2):
        if not isp[i]:
            continue
        base = conds.get(i)
        if base is None:
            continue
        f, t = names[feat[i]], tv[i]
        na = " or NA" if nal[i] else ""
        conds[2 * i + 1] = base + [f"({f} < {t:.6g}{na})"]
        conds[2 * i + 2] = base + [f"({f} >= {t:.6g}"
                                   f"{'' if nal[i] else ' or NA'})"]
    return [f"M{ti}.N{i}: " + " & ".join(conds[i]) if i in conds and conds[i]
            else f"M{ti}.N{i}" for i in range(1, heap)]
