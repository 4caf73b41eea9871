"""Infogram — admissible-ML feature selection, core and fair — the port of
``h2o3_tpu/models/infogram.py`` (reference: ``h2o-admissibleml``'s
``Infogram.java``, ``EstimateCMI.java`` and ``InfogramUtils``).

Core (no ``protected_columns``): relevance is the full surrogate's
variable importance scaled to a maximum of 1; the net information (CMI) of
x_i is the drop in the mean log2-probability of the actual class when x_i
is left out. Fair (``protected_columns``): relevance from a surrogate on
every predictor but the protected ones; the safety index of x_i is the
information about y that x_i adds to the protected set. Each surrogate is
the port's GBM (the histogram kernels on the card), DRF or GLM, trained
on the one frame with its own feature list; each CMI estimate is one
fetch.

:func:`fairness_metrics` tabulates a binomial model's confusion counts,
rates, AUC, logloss and adverse-impact ratio per protected group.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import response_as_float
from h2o3_tpu_torch.models.gbm import DRF, GBM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


#: the surrogates (each has ``varimp`` for the relevance axis)
SURROGATES = {"gbm": GBM, "glm": GLM, "drf": DRF}


def _mean_cmi(model: Model, frame: Frame, y: str) -> float:
    """EstimateCMI.java: the mean log2 p(actual class) over the scorable
    rows, fetched once."""
    raw = model._score_raw(frame)           # [rows, nclass] probabilities
    yy, valid = response_as_float(frame.vec(y))
    mask = frame.row_mask() & valid
    yi = torch.clamp(yy.to(torch.int64), 0, raw.shape[1] - 1)
    p = torch.gather(raw, 1, yi[:, None])[:, 0]
    ok = mask & (p > 0)
    tot = torch.where(ok, torch.log(torch.clamp(p, min=1e-30)), 0.0).sum()
    cnt = torch.clamp(ok.sum(), min=1)
    return float(tot / cnt) / float(np.log(2.0))


class InfogramModel(Model):
    algo = "infogram"

    def _score_raw(self, frame: Frame):
        # scoring is the relevance (full) surrogate's
        return self.output["relevance_model"]._score_raw(frame)

    def get_admissible_features(self) -> list[str]:
        return list(self.output["admissible_features"])

    def get_admissible_cmi(self) -> list[float]:
        a = set(self.output["admissible_features"])
        return [c for f, c in zip(self.output["all_predictor_names"],
                                  self.output["cmi"]) if f in a]

    def infogram_data(self):
        """Rows of (column, admissible, relevance, cmi, cmi_raw): the data
        behind h2o-py's infogram plot."""
        o = self.output
        adm = set(o["admissible_features"])
        return [dict(column=f, admissible=f in adm,
                     relevance=float(r), cmi=float(c), cmi_raw=float(cr))
                for f, r, c, cr in zip(o["all_predictor_names"],
                                       o["relevance"], o["cmi"],
                                       o["cmi_raw"])]


class Infogram(ModelBuilder):
    algo = "infogram"
    supports_regression = False   # CMI needs class probabilities

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            protected_columns=None,
            net_information_threshold=0.1,     # cmi threshold (core)
            total_information_threshold=0.1,   # relevance threshold (core)
            safety_index_threshold=0.1,        # cmi threshold (fair)
            relevance_index_threshold=0.1,     # relevance threshold (fair)
            top_n_features=50,
            algorithm="gbm",
            algorithm_params=None,
        )

    def _surrogate(self, x, y, frame, weights):
        """One surrogate fit (:data:`SURROGATES`)."""
        cls = SURROGATES.get(str(self.params.get("algorithm", "gbm")).lower())
        if cls is None:
            raise ValueError(f"unsupported infogram algorithm "
                             f"{self.params['algorithm']!r}; one of "
                             f"{sorted(SURROGATES)}")
        extra = dict(self.params.get("algorithm_params") or {})
        if cls in (GBM, DRF):
            extra.setdefault("ntrees", 20)
            extra.setdefault("max_depth", 5)
        seed = int(self.params.get("seed") or -1)
        if seed >= 0:
            extra.setdefault("seed", seed)
        return cls(**extra)._fit(Job(f"infogram surrogate on {len(x)} cols"),
                                 frame, list(x), y, weights)

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> InfogramModel:
        self._refuse_checkpoint()
        p = self.params
        protected = list(p.get("protected_columns") or [])
        build_core = not protected
        preds = [c for c in x if c not in protected]
        if not preds:
            raise ValueError("no predictors left after removing protected "
                             "columns")
        top_n = int(p.get("top_n_features") or 50)

        # relevance: full predictors (core), all but protected (fair)
        rel_model = self._surrogate(preds, y, frame, weights)
        vi = {name: rel for name, rel, _, _ in rel_model.varimp()}
        vmax = max(vi.values()) if vi and max(vi.values()) > 0 else 1.0
        relevance = {c: vi.get(c, 0.0) / vmax for c in preds}

        # the top-K by relevance (reference: extractTopKPredictors)
        preds = sorted(preds, key=lambda c: -relevance[c])[:top_n]

        cmi_raw = {}
        if build_core:
            full_cmi = _mean_cmi(rel_model, frame, y)
            for i, c in enumerate(preds):
                rest = [q for q in preds if q != c]
                if not rest:
                    cmi_raw[c] = max(0.0, full_cmi)
                    continue
                m = self._surrogate(rest, y, frame, weights)
                cmi_raw[c] = max(0.0, full_cmi - _mean_cmi(m, frame, y))
                job.update((i + 1) / (len(preds) + 1), f"CMI {c}")
        else:
            base_model = self._surrogate(protected, y, frame, weights)
            base_cmi = _mean_cmi(base_model, frame, y)
            for i, c in enumerate(preds):
                m = self._surrogate(protected + [c], y, frame, weights)
                cmi_raw[c] = max(0.0, _mean_cmi(m, frame, y) - base_cmi)
                job.update((i + 1) / (len(preds) + 1), f"CMI {c}")

        cmax = max(cmi_raw.values()) if cmi_raw and \
            max(cmi_raw.values()) > 0 else 1.0
        cmi = {c: v / cmax for c, v in cmi_raw.items()}

        cmi_thr = float(p["net_information_threshold"] if build_core
                        else p["safety_index_threshold"])
        rel_thr = float(p["total_information_threshold"] if build_core
                        else p["relevance_index_threshold"])
        admissible = [c for c in preds
                      if cmi[c] >= cmi_thr and relevance[c] >= rel_thr]

        return InfogramModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=frame.vec(y).domain,
            data_info=rel_model.data_info,
            output=dict(
                all_predictor_names=preds,
                relevance=[relevance[c] for c in preds],
                cmi=[cmi[c] for c in preds],
                cmi_raw=[cmi_raw[c] for c in preds],
                admissible_features=admissible,
                protected_columns=protected,
                build_core=build_core,
                relevance_model=rel_model))


def _labels(vec: Vec) -> list:
    """A categorical column's level names per row (None where missing)."""
    dom = vec.domain or ()
    return [dom[c] if c >= 0 else None for c in vec.to_numpy().tolist()]


def fairness_metrics(model, frame: Frame, protected_cols: list[str],
                     reference: list[str] | None = None,
                     favorable_class: str | None = None) -> Frame:
    """Per-protected-group fairness table (reference: ``water/rapids/ast/
    prims/models/AstFairnessMetrics.java``): tp/fp/tn/fn rates, accuracy,
    precision, f1, AUC, logloss, the selected ratio, the adverse-impact
    ratio (AIR) and Fisher's p-value against the reference group (the
    largest by default). The group columns are categorical, one level per
    group label (a missing protected value is its own group, missing)."""
    if not model.is_classifier or len(model.response_domain or ()) != 2:
        raise ValueError("fairnessMetrics requires a binomial model")
    dom = list(model.response_domain)
    fav = favorable_class or dom[1]
    if fav not in dom:
        raise ValueError(f"favorable class {fav!r} not in domain {dom}")

    preds = model.predict(frame)
    p = np.asarray(preds.vec(f"p{fav}").to_numpy(), np.float64)[: frame.nrows]
    yl = _labels(frame.vec(model.response_column))
    act = np.array([lbl == fav for lbl in yl], bool)
    thr = getattr(model, "_default_threshold", None)
    thr = 0.5 if thr is None else float(thr)   # 0.0 is a valid threshold
    sel = p >= thr

    glabels = [_labels(frame.vec(c)) for c in protected_cols]
    keys = list(zip(*glabels))
    groups: dict[tuple, list] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    groups = {k: np.asarray(v) for k, v in groups.items()}

    if reference:
        ref_key = tuple(reference)
        if ref_key not in groups:
            raise ValueError(f"reference group {ref_key} not present")
    else:   # the largest group (reference ditto)
        ref_key = max(groups, key=lambda k: len(groups[k]))

    def rank_auc(pi, ai):
        pos, neg = pi[ai], pi[~ai]
        if not len(pos) or not len(neg):
            return float("nan")
        order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
        ranks = np.empty(len(order))
        ranks[order] = np.arange(1, len(order) + 1)
        return float((ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2)
                     / (len(pos) * len(neg)))

    def fisher_p(a, b, c, d):
        from scipy.stats import fisher_exact
        return float(fisher_exact([[a, b], [c, d]])[1])

    ref_idx = groups[ref_key]
    ref_sel_ratio = float(sel[ref_idx].mean()) if len(ref_idx) \
        else float("nan")

    rows = []
    # the missing protected value forms its own group; None sorts first
    order = sorted(groups, key=lambda k: tuple("" if v is None else str(v)
                                               for v in k))
    for k in order:
        idx = groups[k]
        s, a = sel[idx], act[idx]
        tp = float((s & a).sum())
        fp = float((s & ~a).sum())
        fn = float((~s & a).sum())
        tn = float((~s & ~a).sum())
        tot = tp + fp + tn + fn
        pc = np.clip(p[idx], 1e-15, 1 - 1e-15)
        ll = float(-(a * np.log(pc) + ~a * np.log1p(-pc)).mean()) \
            if tot else float("nan")
        sel_ratio = (tp + fp) / tot if tot else float("nan")
        rows.append(list(k) + [
            tot, tot / frame.nrows,
            (tp + tn) / tot if tot else np.nan,
            tp / (tp + fp) if tp + fp else np.nan,
            2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else np.nan,
            tp / (tp + fn) if tp + fn else np.nan,
            tn / (tn + fp) if tn + fp else np.nan,
            fp / (fp + tn) if fp + tn else np.nan,
            fn / (fn + tp) if fn + tp else np.nan,
            rank_auc(p[idx], a), ll, sel_ratio,
            sel_ratio / ref_sel_ratio if ref_sel_ratio else np.nan,
            fisher_p(tp + fp, tn + fn, float(sel[ref_idx].sum()),
                     float((~sel[ref_idx]).sum())),
        ])
    names = list(protected_cols) + [
        "total", "relativeSize", "accuracy", "precision", "f1", "tpr", "tnr",
        "fpr", "fnr", "auc", "logloss", "selectedRatio", "air", "p_value"]
    ncat = len(protected_cols)
    dev = frame.device
    vecs = [Vec.from_numpy(np.array([r[j] for r in rows], dtype=object),
                           type=VecType.CAT, device=dev)
            for j in range(ncat)]
    vecs += [Vec.from_numpy(np.float32([r[j] for r in rows]), VecType.NUM,
                            device=dev)
             for j in range(ncat, len(names))]
    return Frame(names, vecs)
