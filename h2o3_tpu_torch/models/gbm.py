"""GBM and DRF — gradient boosting and random forest on the histogram tree
engine — the port of ``h2o3_tpu/models/gbm.py``.

Each GBM round computes the loss gradient at the current margins, grows one
tree on it (K class trees for multinomial, in one batched growth:
:func:`h2o3_tpu_torch.models.tree.grow_trees_batched`) and adds
``learn_rate`` times each row's leaf to the margins, in the reference's
tree-for-tree order ``Fcur + lr * row_leaf``. DRF grows each round's tree
(or K class-indicator trees) on a Poisson bootstrap of the row weights and
averages the trees at scoring. The reference runs the rounds as one
compiled ``lax.scan`` cut into chunks that keep a TPU watchdog happy; here
they are a Python loop whose device work is enqueued without a host sync.
Row and column sampling draw from a ``torch.Generator`` per tree, seeded
from the builder's ``seed`` and the tree's index, so that a checkpoint
resume draws what the uninterrupted run drew (the reference splits its
keys for all ``ntrees`` and slices them at the resumed tree): the port's
random numbers are its own, not JAX's.

Every GBM tree's metric (``stopping_metric``) is computed on the card, on
the training margins and, with a ``validation_frame``, on margins carried
over the validation rows; ``stopping_rounds`` fetches the series in chunks
of trees (one host sync a chunk) and trims the trees grown past the stop,
so the kept trees are those of per-tree scoring. Without stopping the
series is fetched once, at the end, for the scoring history.
Categorical features take group splits (``categorical_encoding`` AUTO or
enum; ordinal or label_encoder keep thresholds), with more levels than
``min(nbins, nbins_cats)`` grouped into ranges; ``monotone_constraints``
and ``interaction_constraints`` constrain GBM and XGBoost trees.

Distributions: bernoulli, multinomial, gaussian, poisson, gamma, tweedie,
laplace, quantile, huber and custom (a link/init/gradient/gamma UDF uploaded
as a zip under a DKV key and named by ``custom_distribution_func``,
:mod:`h2o3_tpu_torch.utils.udf`: evaluated on whole float64 columns on the
card, or by the reference's row loop on the host where the UDF cannot
take tensors; ``output["custom_vectorized"]`` says which), with
``offset_column``. Every tree model
reports ``varimp`` (split gains summed per feature) and, with one tree
set, ``predict_contributions`` (TreeSHAP on the card,
:mod:`h2o3_tpu_torch.genmodel.treeshap`); a binomial model trained with
``calibrate_model`` scores ``cal_p0``/``cal_p1`` through Platt scaling or
isotonic regression fitted on its ``calibration_frame``. A
``calibration_frame`` is a Frame or the key of one in the DKV.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.genmodel.treeshap import ensemble_contributions
from h2o3_tpu_torch.models.data_info import (remap_codes, response_adapted,
                                             response_as_float)
from h2o3_tpu_torch.models.job import Job, JobCancelled
from h2o3_tpu_torch.models.model_base import (Model, ModelBuilder,
                                              make_model_key,
                                              publish_dispatch_audit)
from h2o3_tpu_torch.models.tree import (Tree, TreeParams, _walk_binned,
                                        cat_bins_for_codes,
                                        fold_binned, grow_cost, grow_tree,
                                        grow_trees_batched, predict_binned,
                                        predict_raw)
from h2o3_tpu_torch.ops.map_reduce import mesh_reduce, retrying
from h2o3_tpu_torch.parallel.mesh import refuse_on_mesh
from h2o3_tpu_torch.ops.quantile import (bin_column, bin_dtype, bin_features,
                                         compute_bin_edges)
from h2o3_tpu_torch.persist.recovery import checkpoint_every
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils.costs import accounted
from h2o3_tpu_torch.utils.registry import DKV
from h2o3_tpu_torch.utils.timeline import timed_event
from h2o3_tpu_torch.utils.udf import linkinv, resolve_distribution

def _boost_scan_cost(args, statics) -> tuple[float, float]:
    """A chunk's cost: its rounds' tree growths (:func:`grow_cost`; K class
    trees a round for multinomial). The gradients, margins and metrics
    around them are left out."""
    binned = args[0]
    c = grow_cost(binned.shape[0], binned.shape[1],
                  max(int(statics["nclass"]), 1), statics["depth"],
                  statics["nbins"], binned.element_size())
    return (statics["rounds"] * c["flops"], statics["rounds"] * c["bytes"])


#: a chunk of boosting rounds as a site of the compute observatory (the
#: reference's ``gbm:boost_scan`` program)
_BOOST_SCAN = accounted("gbm:boost_scan", _boost_scan_cost, loop="gbm_chunk")

#: the GBM distributions the port trains
DISTRIBUTIONS = ("bernoulli", "multinomial", "gaussian", "poisson", "gamma",
                 "tweedie", "laplace", "quantile", "huber", "custom")
#: the families whose margins are on the log scale
LOG_LINK = ("poisson", "gamma", "tweedie")
#: the calibration methods (reference ``CalibrationHelper``)
CALIBRATION_METHODS = ("PlattScaling", "IsotonicRegression")


def tree_columns(frame: Frame, cols: list[str],
                 domains: dict[str, tuple]) -> list[torch.Tensor]:
    """Each feature as a raw float32 column; categorical codes are mapped
    onto the training domain (a level unseen in training is missing)."""
    arrs = []
    for c in cols:
        v = frame.vec(c)
        dom = domains.get(c)
        if v.is_categorical and dom and v.domain != dom:
            codes = remap_codes(v.data, v.domain or (), dom)
            arrs.append(torch.where(codes < 0, torch.nan, codes.float()))
        else:
            arrs.append(v.as_float())
    return arrs


def tree_matrix(frame: Frame, cols: list[str],
                domains: dict[str, tuple]) -> torch.Tensor:
    """[rows, F] raw float32 feature matrix (:func:`tree_columns`)."""
    return torch.stack(tree_columns(frame, cols, domains), dim=1)


def sigmoid(f: torch.Tensor) -> torch.Tensor:
    """Class-1 probabilities of float32 margins, computed in float64 and
    rounded once: the same float32 bits on the CPU and the card, whose
    float32 sigmoids differ in the last bit on many rows (an isotonic
    calibration's steps amplify that), and within an ulp of the
    reference's float32 sigmoid."""
    return torch.sigmoid(f.double()).float()


def _weighted_quantile_host(y: torch.Tensor, w: torch.Tensor,
                            prob: float) -> float:
    """Weighted quantile of y over rows with w > 0 (host side, once per
    training: the initial margin of laplace, quantile and huber); across
    ranks over every rank's rows, gathered."""
    from h2o3_tpu_torch.parallel.distributed import fetch
    yh = fetch(y.detach()).astype(np.float64)
    wh = fetch(w.detach()).astype(np.float64)
    ok = wh > 0
    if not ok.any():
        return 0.0
    order = np.argsort(yh[ok])
    ys, ws = yh[ok][order], wh[ok][order]
    cw = np.cumsum(ws)
    idx = int(np.searchsorted(cw, prob * cw[-1]))
    return float(ys[min(idx, len(ys) - 1)])


def _grad_hess(dist: str, F: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               quantile_alpha: float = 0.5, huber_alpha: float = 0.9,
               tweedie_power: float = 1.5, custom=None):
    """Per-row (g, h) of the loss at margins F (reference: the
    ``hex/Distribution.java`` families; the non-smooth losses take the
    standard GBM pseudo-residual with a unit hessian, so the leaf is the
    weighted mean pseudo-residual). The hyperparameters enter as float32
    scalars, as the reference's traced float32 values do. ``custom``: the
    :class:`~h2o3_tpu_torch.utils.udf.CustomDistribution` of
    ``dist="custom"``."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=F.device)
    if dist == "bernoulli":
        p = torch.sigmoid(F)
        return w * (p - y), w * torch.clamp(p * (1 - p), min=1e-10)
    if dist == "gaussian":
        return w * (F - y), w
    if dist == "poisson":
        mu = torch.exp(torch.clamp(F, -30, 30))
        return w * (mu - y), w * mu
    if dist == "gamma":
        # log link; deviance gradient 1 - y*exp(-F)
        ey = y * torch.exp(torch.clamp(-F, -30, 30))
        return w * (1.0 - ey), w * ey
    if dist == "tweedie":
        p_ = f32(tweedie_power)
        e1 = torch.exp(torch.clamp((1.0 - p_) * F, -30, 30))
        e2 = torch.exp(torch.clamp((2.0 - p_) * F, -30, 30))
        g = w * (-y * e1 + e2)
        h = w * (-(1.0 - p_) * y * e1 + (2.0 - p_) * e2)
        return g, torch.clamp(h, min=1e-10)
    if dist == "laplace":
        return w * torch.sign(F - y), w
    if dist == "quantile":
        a = f32(quantile_alpha)
        return w * torch.where(y > F, -a, 1.0 - a), w
    if dist == "huber":
        # delta: the huber_alpha weighted quantile of |residual|, refreshed
        # every round; zero-weight rows cannot move it
        r = F - y
        ar = r.abs()
        order = torch.argsort(ar, stable=True)
        cw = torch.cumsum(w[order], 0)
        tgt = f32(huber_alpha) * torch.clamp(cw[-1:], min=1e-30)
        idx = torch.searchsorted(cw, tgt).clamp(0, ar.shape[0] - 1)
        delta = ar[order][idx]
        return w * torch.clamp(r, -delta, delta), w
    if dist == "custom":
        if custom is None:
            raise ValueError("distribution 'custom' takes its gradients "
                             "from an uploaded distribution (custom=)")
        return custom.grad_hess(F, y, w)
    raise ValueError(f"unknown distribution {dist!r}")


def _grad_hess_multinomial(F: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Softmax gradients for all K classes at once (reference: GBM.java
    multinomial pseudo-residuals). F: [rows, K]; y: class ids as floats;
    returns (g, h) [rows, K]."""
    p = torch.softmax(F, dim=1)
    yoh = torch.nn.functional.one_hot(y.long(), F.shape[1]).to(F.dtype)
    return (w[:, None] * (p - yoh),
            w[:, None] * torch.clamp(p * (1 - p), min=1e-10))


def _metric_device(metric: str, dist: str, F: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor, nclass: int,
                   custom_link: str | None = None) -> torch.Tensor:
    """A stopping/score metric as device code, less is better (AUC is
    negated), so that every tree's value stays on the card until the
    stopping rule fetches a chunk of them (reference: ``ScoreKeeper``).
    ``F``: margins ([rows, K] for multinomial); ``dist="drf_prob"`` means
    ``F`` already is the prediction (DRF's averaged probability or mean).
    AUC credits tied predictions at half, exactly. A custom distribution
    scores in response space, through its ``custom_link``'s inverse.
    Across ranks each weighted mean is one all_reduce of its numerator and
    ``w``'s sum; AUC, a rank statistic, is not rank-aware yet."""
    def mean(num):
        """num / Σw over the mesh's rows."""
        num, den = mesh_reduce(lambda a, b: torch.stack([a, b.sum()]),
                               num, w)
        return num / torch.clamp(den, min=1e-30)

    if nclass > 1:
        prob = F if dist == "drf_prob" else torch.softmax(F, dim=1)
        prob = torch.clamp(prob, 1e-15, 1.0)
        yi = y.long()[:, None]
        if metric in ("AUTO", "deviance", "logloss"):
            return mean(-(w * torch.log(prob).gather(1, yi)[:, 0]).sum())
        if metric in ("MSE", "RMSE"):
            mse = mean((w * (1.0 - prob.gather(1, yi)[:, 0]) ** 2).sum())
            return torch.sqrt(mse) if metric == "RMSE" else mse
        if metric == "misclassification":
            pred = torch.argmax(prob, dim=1).float()
            return mean((w * (pred != y)).sum())
        raise ValueError(f"unsupported multinomial stopping_metric {metric!r}")
    prob = mu = None
    if dist == "bernoulli":
        prob = torch.sigmoid(F)
    elif dist == "drf_prob":
        prob = torch.clamp(F, 0.0, 1.0)
    elif dist in LOG_LINK:
        mu = torch.exp(torch.clamp(F, -30, 30))
    elif dist == "custom":
        mu = linkinv(custom_link or "identity", F)
    else:
        mu = F
    if metric in ("AUTO", "deviance", "logloss"):
        if prob is not None:
            pc = torch.clamp(prob, 1e-7, 1 - 1e-7)
            return mean(-(w * (y * torch.log(pc)
                               + (1 - y) * torch.log1p(-pc))).sum())
        if dist in LOG_LINK:
            return mean((w * (mu - y * torch.clamp(F, -30, 30))).sum())
        return mean((w * (mu - y) ** 2).sum())
    if metric in ("MSE", "RMSE"):
        err = (prob - y) ** 2 if prob is not None else (mu - y) ** 2
        mse = mean((w * err).sum())
        return torch.sqrt(mse) if metric == "RMSE" else mse
    if metric == "misclassification":
        return mean((w * ((prob > 0.5).float() != y)).sum())
    if metric == "AUC":
        from h2o3_tpu_torch.parallel.mesh import refuse_on_mesh
        refuse_on_mesh("the AUC stopping metric")
        # weighted Mann-Whitney: a positive earns the negative weight below
        # its score plus half of its tie group's
        order = torch.argsort(prob, stable=True)
        sc, ys, ws = prob[order], y[order], w[order]
        negw = ws * (1.0 - ys)
        cumneg = torch.cumsum(negw, 0)
        lo = torch.searchsorted(sc, sc)
        hi = torch.searchsorted(sc, sc, right=True) - 1
        before = torch.where(lo > 0, cumneg[(lo - 1).clamp_min(0)], 0.0)
        credit = before + 0.5 * (cumneg[hi] - before)
        posw = ws * ys
        tot = torch.clamp(posw.sum() * negw.sum(), min=1e-30)
        return -(posw * credit).sum() / tot
    raise ValueError(f"unsupported stopping_metric {metric!r}")


def _offset(frame: Frame, col: str) -> torch.Tensor:
    """The per-row margin offset (NaN reads as 0)."""
    if col not in frame:
        raise ValueError(f"scoring frame lacks offset column {col!r}")
    return torch.nan_to_num(frame.vec(col).as_float(), nan=0.0)


class SharedTreeModel(Model):
    """Scoring common to the tree models: sums of the trees' leaves on the
    raw feature matrix, for one tree set or one per class; a group-split
    model routes categorical codes (remapped to the training domain) by
    its trees' left masks."""

    def _predict_trees(self, X, trees):
        out = self.output
        return predict_raw(X, trees, cat_card=out.get("cat_card"),
                           n_bins=int(out.get("cat_bins") or 0))

    def predict(self, frame: Frame) -> Frame:
        """Score; a calibrated binomial model appends ``cal_p0`` and
        ``cal_p1`` (reference: ``CalibrationHelper.postProcessPredictions``)."""
        out = super().predict(frame)
        cal = self.output.get("calibration")
        if cal is None:
            return out
        cp1 = calibrated_p1(cal, out.vecs[2].data)
        return Frame(out.names + ["cal_p0", "cal_p1"],
                     out.vecs + [Vec.from_device(1 - cp1),
                                 Vec.from_device(cp1)])

    def varimp(self, use_pandas: bool = False):
        """Per-feature split-gain importance (reference: ``SharedTree``'s
        relative importance; h2o-py ``model.varimp()`` rows (variable,
        relative, scaled, percentage)), from one fetch of every tree's
        split features and gains, summed in float64 on the host in the
        reference's order."""
        cols = self.output["x_cols"]
        rel = np.zeros(len(cols))
        all_trees = self.output.get("trees") or [
            t for ts in self.output.get("trees_multi", []) for t in ts]
        with_gain = [t for t in all_trees if t.gain is not None]
        if with_gain:
            feat = torch.stack([t.feat for t in with_gain])
            gain = torch.stack([t.gain for t in with_gain])
            fetched = torch.cat([feat.to(gain.dtype), gain]).cpu().numpy()
            n = len(with_gain)
            for f, g in zip(fetched[:n].astype(np.int64), fetched[n:]):
                ok = f >= 0
                np.add.at(rel, f[ok], np.maximum(g[ok], 0.0))
        mx = rel.max() if rel.max() > 0 else 1.0
        tot = rel.sum() if rel.sum() > 0 else 1.0
        rows = sorted(zip(cols, rel, rel / mx, rel / tot), key=lambda r: -r[1])
        if use_pandas:
            import pandas as pd
            return pd.DataFrame(rows, columns=["variable", "relative_importance",
                                               "scaled_importance",
                                               "percentage"])
        return rows

    def _contrib_scale_bias(self) -> tuple[float, float]:
        """(scale, extra_bias) mapping the trees' summed SHAP values onto
        this model's raw margin: margin = scale * tree_sum + extra_bias."""
        return 1.0, 0.0

    def contributions(self, frame: Frame) -> torch.Tensor:
        """[rows, F + 1] float64 SHAP contributions on the frame's device,
        the last column the bias; each row sums to the model's raw margin
        (logit for bernoulli, the mean for DRF and regression)."""
        if "trees" not in self.output:
            raise ValueError("contributions need a single-tree-set model")
        X = tree_matrix(frame, self.output["x_cols"],
                        self.output["feat_domains"])
        phi = ensemble_contributions(
            self.output["trees"], X, cat_card=self.output.get("cat_card"),
            n_bins=int(self.output.get("cat_bins") or 0))
        scale, bias = self._contrib_scale_bias()
        phi *= scale
        phi[:, -1] += bias
        return phi

    def predict_contributions(self, frame: Frame) -> Frame:
        """Per-row SHAP contributions and ``BiasTerm`` as float32 columns
        (reference: ``Model.scoreContributions``; h2o-py
        ``model.predict_contributions``)."""
        phi = self.contributions(frame)
        names = list(self.output["x_cols"]) + ["BiasTerm"]
        return Frame(names, [Vec.from_device(phi[:, i].float().contiguous())
                             for i in range(phi.shape[1])])

    def _tree_raw_sum(self, frame: Frame) -> torch.Tensor:
        if not self.output["trees"]:
            return torch.zeros(frame.local_nrows, dtype=torch.float32,
                               device=frame.device)
        X = tree_matrix(frame, self.output["x_cols"], self.output["feat_domains"])
        return self._predict_trees(X, self.output["trees"])

    def _tree_raw_sum_per_class(self, frame: Frame) -> torch.Tensor:
        """[rows, K] per-class sums (``trees_multi[k]`` is class k)."""
        per_class = self.output["trees_multi"]
        if not any(per_class):
            return torch.zeros((frame.local_nrows, len(per_class)),
                               dtype=torch.float32, device=frame.device)
        X = tree_matrix(frame, self.output["x_cols"], self.output["feat_domains"])
        return torch.stack([self._predict_trees(X, ts) for ts in per_class],
                           dim=1)


def fit_calibration(method: str, p1: np.ndarray, y: np.ndarray) -> dict:
    """The calibration of p1 (float32, clipped into (0, 1)) against the
    0/1 response y, on the host as the reference fits it
    (``_maybe_calibrate``): Platt scaling by at most 50 Newton steps on
    Platt's smoothed targets, or isotonic regression by
    pool-adjacent-violators over p1 sorted."""
    if method == "PlattScaling":
        f = np.log(p1 / (1 - p1))
        # Platt's target smoothing: t+=(N++1)/(N++2), t-=1/(N-+2)
        npos, nneg = float(y.sum()), float((1 - y).sum())
        t = np.where(y > 0, (npos + 1) / (npos + 2), 1 / (nneg + 2))
        a, b = 1.0, 0.0
        for _ in range(50):
            p = 1 / (1 + np.exp(-(a * f + b)))
            g = np.array([np.sum((p - t) * f), np.sum(p - t)])
            W = np.maximum(p * (1 - p), 1e-10)
            Hm = np.array([[np.sum(W * f * f) + 1e-9, np.sum(W * f)],
                           [np.sum(W * f), np.sum(W) + 1e-9]])
            step = np.linalg.solve(Hm, g)
            a, b = a - step[0], b - step[1]
            if np.abs(step).max() < 1e-10:
                break
        return dict(method=method, a=float(a), b=float(b))
    order = np.argsort(p1)
    xs, ys = p1[order], y[order].astype(np.float64)
    merged_v, merged_w, merged_x = [], [], []
    for v, xx in zip(ys.tolist(), xs.tolist()):
        merged_v.append(v)
        merged_w.append(1.0)
        merged_x.append(xx)
        while len(merged_v) > 1 and merged_v[-2] > merged_v[-1]:
            v2, w2 = merged_v.pop(), merged_w.pop()
            merged_x.pop()
            merged_v[-1] = (merged_v[-1] * merged_w[-1] + v2 * w2) / \
                (merged_w[-1] + w2)
            merged_w[-1] += w2
    return dict(method=method, xs=[float(v) for v in merged_x],
                ys=[float(v) for v in merged_v])


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``np.interp`` on the device (float64): fp[0] below xp[0], fp[-1]
    from xp[-1] on, else the line between the knots around x (the last
    knot at or below x, so repeated knots take their last value)."""
    n = xp.shape[0]
    j = (torch.searchsorted(xp, x, right=True) - 1).clamp(0, max(n - 2, 0))
    if n == 1:
        return torch.where(torch.isnan(x), x, fp[0].expand_as(x))
    x0, x1, y0, y1 = xp[j], xp[j + 1], fp[j], fp[j + 1]
    slope = (y1 - y0) / (x1 - x0)
    out = slope * (x - x0) + y0
    # np.interp's repair where the line's arithmetic gives NaN
    alt = slope * (x - x1) + y1
    out = torch.where(torch.isnan(out), alt, out)
    out = torch.where(torch.isnan(out) & (y0 == y1), y0, out)
    out = torch.where(x < xp[0], fp[0], out)
    out = torch.where(x >= xp[-1], fp[-1], out)
    return torch.where(torch.isnan(x), x, out)


def calibrated_p1(cal: dict, p1: torch.Tensor) -> torch.Tensor:
    """Calibrated class-1 probabilities (float32) of the model's p1, on its
    device, in the reference's arithmetic: Platt in float32 on p1 clipped
    into [1e-15, 1 - 1e-15], isotonic by ``np.interp`` in float64."""
    p1 = torch.clamp(p1, 1e-15, 1 - 1e-15)
    if cal["method"] == "PlattScaling":
        z = cal["a"] * torch.log(p1 / (1 - p1)) + cal["b"]
        return 1.0 / (1.0 + torch.exp(-z))
    f64 = dict(dtype=torch.float64, device=p1.device)
    return _interp(p1.double(), torch.tensor(cal["xs"], **f64),
                   torch.tensor(cal["ys"], **f64)).float()


class GBMModel(SharedTreeModel):
    algo = "gbm"

    def _contrib_scale_bias(self):
        return float(self.output["learn_rate"]), float(self.output["f0"])

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        out = self.output
        if out["distribution"] == "multinomial":
            f = out["f0_multi"][None, :] + \
                out["learn_rate"] * self._tree_raw_sum_per_class(frame)
            return torch.softmax(f, dim=1)
        f = out["f0"] + out["learn_rate"] * self._tree_raw_sum(frame)
        oc = self.params.get("offset_column")
        if oc:
            f = f + _offset(frame, oc)
        if out["distribution"] == "bernoulli":
            p = sigmoid(f)
            return torch.stack([1 - p, p], dim=1)
        if out["distribution"] in LOG_LINK:
            return torch.exp(torch.clamp(f, -30, 30))
        if out["distribution"] == "custom":
            return linkinv(out["custom_link"], f)
        return f


def _tree_seed(seed: int, m: int) -> int:
    """The seed of tree (round) m's generator: a mix of the training seed
    and m, so that every tree draws the same numbers whether the run went
    straight through or resumed from a checkpoint before it."""
    return int(np.random.SeedSequence([seed, m]).generate_state(
        1, np.uint64)[0] >> 1)


class SharedTreeBuilder(ModelBuilder):
    """Training code common to the tree models (reference:
    hex/tree/SharedTree.java)."""

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), ntrees=50, max_depth=5, min_rows=10.0,
                    nbins=64, sample_rate=1.0, col_sample_rate_per_tree=1.0,
                    min_split_improvement=1e-5, stopping_rounds=0,
                    stopping_metric="AUTO", stopping_tolerance=1e-3,
                    # the per-tree tracker scores every tree; these two only
                    # thin the reported history
                    score_tree_interval=0, score_each_iteration=False,
                    monotone_constraints=None,      # {col: +-1}
                    interaction_constraints=None,   # [[cols...], ...]
                    calibrate_model=False, calibration_frame=None,
                    calibration_method="PlattScaling",
                    nbins_cats=1024,                # capped at nbins here
                    categorical_encoding="AUTO",    # AUTO/enum: group splits
                    offset_column=None)

    # dense-heap trees cap depth at 16 (2^17 nodes)
    MAX_TREE_DEPTH = 16
    #: the group-split state of the last _prepare (None: no group splits)
    _cat_info = None

    #: scoring-history column name per stopping metric (AUC is tracked
    #: negated for less-is-better stopping; the table shows the true value)
    _HIST_NAMES = {"AUTO": "deviance", "deviance": "deviance",
                   "logloss": "logloss", "MSE": "mse", "RMSE": "rmse",
                   "AUC": "auc", "misclassification": "classification_error"}

    def _scoring_history(self, model):
        """Per-tree metric rows from the tracked series (reference:
        ``SharedTree.doScoringAndSaveModel`` → ``createScoringHistoryTable``);
        ``score_tree_interval`` thins the rows, the last tree always
        reports."""
        series = getattr(self, "_score_series", None)
        if not series:
            return None
        metric, tser, vser = series
        name = self._HIST_NAMES.get(metric, "deviance")
        sign = -1.0 if metric == "AUC" else 1.0
        cols = [("number_of_trees", "long", "%d"),
                (f"training_{name}", "double", "%.5f")]
        if vser is not None:
            cols.append((f"validation_{name}", "double", "%.5f"))
        sti = int(self.params.get("score_tree_interval") or 0)
        if self.params.get("score_each_iteration"):
            sti = 1
        values = [[i + 1, sign * float(tv)]
                  + ([sign * float(vser[i])] if vser is not None else [])
                  for i, tv in enumerate(tser)
                  if sti <= 1 or (i + 1) % sti == 0 or i == len(tser) - 1]
        return self._history_table(model, cols, values)

    def _refuse_outside_slice(self) -> None:
        """Parameters this builder does not take raise (see
        :attr:`UNUSED`)."""
        base = self.defaults()
        for name in self.UNUSED:
            if self.params.get(name) != base[name]:
                raise ValueError(f"{type(self).__name__} does not take "
                                 f"{name} (the reference leaves it "
                                 "unapplied)")

    #: the inherited parameters this builder does not apply: each must
    #: keep its default
    UNUSED: tuple = ()
    #: (lo, hi, nrows) of the training frame's row block under a mesh of
    #: several ranks (set by ``_prepare``), else None
    _row_block = None

    def _maybe_calibrate(self, model) -> None:
        """Fit probability calibration on ``calibration_frame`` (reference:
        ``hex/tree/CalibrationHelper.java:18``): the frame scored on the
        card, its p1, response and validity fetched once, and the fit on
        the host (:func:`fit_calibration`)."""
        if not self.params.get("calibrate_model"):
            return
        if model.nclasses != 2:
            raise ValueError("calibrate_model requires a binomial model "
                             "(reference: CalibrationHelper)")
        cf = self.params.get("calibration_frame")
        if cf is None:
            raise ValueError("calibrate_model requires calibration_frame")
        if isinstance(cf, str):
            cf = DKV[cf]
        method = str(self.params.get("calibration_method") or "PlattScaling")
        if method not in CALIBRATION_METHODS:
            raise ValueError(f"unknown calibration_method {method!r}")
        raw = model._score_raw(cf)
        yv, valid = response_adapted(cf.vec(model.response_column),
                                     model.response_domain)
        p1, y, ok = torch.stack([raw[:, 1], yv, valid.float()]).cpu().numpy()
        mask = ok > 0
        model.output["calibration"] = fit_calibration(
            method, np.clip(p1[mask], 1e-15, 1 - 1e-15), y[mask])

    def _prepare(self, frame: Frame, x: list[str], y: str, weights):
        """Bin edges from a strided sample of at most ~100k rows, the
        categorical binning state, the binned training matrix, and the
        response with its validity mask."""
        self._refuse_outside_slice()
        depth = int(self.params["max_depth"])
        if depth > self.MAX_TREE_DEPTH:
            raise ValueError(f"max_depth={depth} exceeds the dense-heap limit "
                             f"{self.MAX_TREE_DEPTH}")
        nrows = frame.nrows
        stride = max(1, nrows // 100_000)
        idx = torch.arange(0, nrows, stride, device=frame.device)
        # the same sample of the whole frame on every rank of a mesh
        sample = torch.stack([frame.vec(c).rows_at(idx) for c in x],
                             dim=1).cpu().numpy()
        self._row_block = frame.block
        if frame.block is not None:
            from h2o3_tpu_torch.parallel.distributed import fetch
            weights = torch.as_tensor(fetch(weights))
        # weighted edges keep the weights-as-replication contract
        w_sample = weights[idx.to(weights.device)].cpu().numpy().astype(
            np.float64)
        edges = torch.as_tensor(compute_bin_edges(
            sample, int(self.params["nbins"]), w_sample)).to(frame.device)
        self._setup_cat_info(frame, x)
        binned = self._bin_frame(frame, x, edges)
        yvec = frame.vec(y)
        yy, valid = response_as_float(yvec)
        return edges, binned, yy, valid, yvec

    def _setup_cat_info(self, frame: Frame, x: list[str]) -> None:
        """Group-split binning state (reference: DHistogram gives an enum a
        bin per level up to ``nbins_cats``, then range-groups;
        ``categorical_encoding`` ordinal / label_encoder keeps threshold
        splits on the codes): (cardinality per feature [F], 0 for numeric,
        and the categories' bin count), or None."""
        enc = str(self.params.get("categorical_encoding") or "AUTO").lower()
        card = [0] * len(x)
        if enc in ("auto", "enum"):
            card = [frame.vec(c).cardinality() if frame.vec(c).is_categorical
                    else 0 for c in x]
        elif enc not in ("ordinal", "label_encoder", "labelencoder"):
            raise ValueError(f"unsupported categorical_encoding {enc!r}; "
                             "have AUTO, enum, ordinal/label_encoder")
        self._cat_info = None
        if any(card):
            nbins = int(self.params["nbins"])
            cat_bins = min(nbins, int(self.params.get("nbins_cats") or nbins))
            self._cat_info = (torch.tensor(card, dtype=torch.int32,
                                           device=frame.device), cat_bins)

    @property
    def _cat_feats(self):
        return None if self._cat_info is None else self._cat_info[0] > 0

    def _cat_output(self) -> dict:
        """The model-output entries of a group-split model."""
        if self._cat_info is None:
            return {}
        cc, cat_bins = self._cat_info
        return dict(cat_card=cc, cat_bins=cat_bins)

    def _bin_frame(self, frame: Frame, x: list[str], edges) -> torch.Tensor:
        """Per-column binning → [rows, F] int8/int16 bins (int8 up to 125
        bins halves the histogram kernel's dominant input); a categorical
        feature's bin is its (range-grouped) code, missing the NA bin."""
        nbins = int(self.params["nbins"])
        dtype = bin_dtype(nbins)
        cc, cat_bins = self._cat_info or (None, 0)
        cols = []
        for j, c in enumerate(x):
            v = frame.vec(c).as_float()
            if cc is not None and frame.vec(c).is_categorical and \
                    int(cc[j]) > 0:
                b = cat_bins_for_codes(v[:, None], cc[j:j + 1], cat_bins)[:, 0]
                cols.append(torch.where(torch.isnan(v), nbins, b).to(dtype))
            else:
                cols.append(bin_column(v, edges[j], nbins, dtype))
        return torch.stack(cols, dim=1)

    def _apply_cat_bins(self, X: torch.Tensor,
                        binned: torch.Tensor) -> torch.Tensor:
        """Re-bin the categorical columns of a raw matrix's bins: the
        (range-grouped) code, missing in the NA bin."""
        if self._cat_info is None:
            return binned
        cc, cat_bins = self._cat_info
        nbins = int(self.params["nbins"])
        is_cat = cc[None, :] > 0
        nan = torch.isnan(X)
        out = torch.where(is_cat & ~nan,
                          cat_bins_for_codes(X, cc, cat_bins).to(binned.dtype),
                          binned)
        return torch.where(is_cat & nan, nbins, out).to(binned.dtype)

    def _constraint_arrays(self, x: list[str], frame: Frame) -> tuple:
        """(mono [F] int32, reach [F, F] bool) on the frame's device from
        the constraint parameters, each None when unset (reference:
        ``Constraints.java:7``, ``BranchInteractionConstraints.java``).
        Features no interaction set lists are singletons: they may split
        anywhere, and nothing else below them."""
        mc = self.params.get("monotone_constraints") or {}
        ic = self.params.get("interaction_constraints")
        mono = reach = None
        if mc:
            bad = set(mc) - set(x)
            if bad:
                raise ValueError(f"monotone_constraints name non-feature "
                                 f"columns: {sorted(bad)}")
            for c in mc:
                if frame.vec(c).is_categorical:
                    raise ValueError(f"monotone constraint on categorical "
                                     f"column {c!r} (reference: numeric only)")
                if int(mc[c]) not in (-1, 0, 1):
                    raise ValueError(f"monotone_constraints[{c!r}] must be "
                                     "-1, 0 or 1")
            mono = torch.tensor([int(mc.get(c, 0)) for c in x],
                                dtype=torch.int32, device=frame.device)
        if ic:
            F = len(x)
            reach_np = np.zeros((F, F), bool)
            listed: set[int] = set()
            for group in ic:
                bad = set(group) - set(x)
                if bad:
                    raise ValueError(f"interaction_constraints name "
                                     f"non-feature columns: {sorted(bad)}")
                idxs = [x.index(c) for c in group]
                for i in idxs:
                    reach_np[i, idxs] = True
                listed.update(idxs)
            for f in range(F):
                if f not in listed:
                    reach_np[f, f] = True
            reach = torch.as_tensor(reach_np).to(frame.device)
        return mono, reach

    def _check_checkpoint(self, cp, x, dist: str | None) -> None:
        """A checkpoint must have been trained as this run trains
        (reference: SharedTree.java:241 checks the immutable parameters)."""
        if cp is None:
            return
        if list(cp.output["x_cols"]) != list(x):
            raise ValueError("checkpoint feature columns differ from this train")
        if dist is not None and cp.output["distribution"] != dist:
            raise ValueError(f"checkpoint distribution "
                             f"{cp.output['distribution']!r} != {dist!r}")
        for immut in ("max_depth", "nbins"):
            if int(cp.params.get(immut, self.params[immut])) != \
                    int(self.params[immut]):
                raise ValueError(f"checkpoint {immut} differs; tree structure "
                                 "params are immutable across resume")
        # masked and threshold trees cannot share an ensemble
        cp_grouped = cp.output.get("cat_card") is not None
        if cp_grouped != (self._cat_info is not None):
            raise ValueError(
                "checkpoint categorical encoding differs (group splits vs "
                "ordinal); set categorical_encoding to match the checkpoint")
        if cp_grouped and int(cp.output.get("cat_bins") or 0) != \
                int(self._cat_info[1]):
            raise ValueError("checkpoint nbins_cats differs; immutable "
                             "across resume")
        # learn_rate scales every tree at scoring: it cannot change
        if "learn_rate" in self.params and "learn_rate" in cp.params:
            if float(cp.params["learn_rate"]) != \
                    float(self.params["learn_rate"]):
                raise ValueError("checkpoint learn_rate differs; it is "
                                 "immutable across resume (it rescales "
                                 "prior trees)")
        prior = int(cp.output["ntrees"])
        if int(self.params["ntrees"]) <= prior:
            raise ValueError(f"ntrees must exceed the checkpoint's {prior} "
                             "to continue training")

    def _resume_binning(self, cp, frame: Frame, x: list[str], edges, binned):
        """The checkpoint's edges and the frame binned by them (its trees'
        thresholds hold only on its bins), after the checks that do not
        need the distribution."""
        if cp is None:
            return edges, binned
        self._check_checkpoint(cp, x, None)
        edges = cp.output["edges"].to(frame.device)
        return edges, self._bin_frame(frame, x, edges)

    def _tree_generator(self, device: torch.device, m: int) -> torch.Generator:
        """Tree (round) m's source of randomness, on its device, from
        ``seed`` (42 when unset, as in the reference) and m."""
        seed = int(self.params["seed"])
        return torch.Generator(device=device).manual_seed(
            _tree_seed(seed if seed >= 0 else 42, m))

    def _effective_col_rate(self) -> float:
        """Per-level feature-sampling rate (XGBoost folds its by-node rate
        in without changing the stored params)."""
        return float(self.params["col_sample_rate"])

    @staticmethod
    def _feat_mask(gen: torch.Generator, F: int, rate: float,
                   device: torch.device) -> torch.Tensor:
        """[F] features kept with probability ``rate``, one drawn feature
        always among them."""
        if rate >= 1.0:
            return torch.ones(F, dtype=torch.bool, device=device)
        m = torch.rand(F, generator=gen, device=device) < rate
        # a scatter, where indexed assignment would wait for the card
        return m.scatter_(0, torch.randint(0, F, (1,), generator=gen,
                                           device=device), True)

    def _sample_fmask(self, gen: torch.Generator, fmask_base: torch.Tensor,
                      rate: float) -> torch.Tensor:
        """Per-tree column sampling (``col_sample_rate_per_tree``): the
        forced feature is set BEFORE the draw meets ``fmask_base``, so a
        sample never re-enables a banned feature, and an empty result keeps
        ``fmask_base``."""
        if rate >= 1.0:
            return fmask_base
        m = fmask_base & self._feat_mask(gen, fmask_base.shape[0], rate,
                                         fmask_base.device)
        return torch.where(m.any(), m, fmask_base)

    @staticmethod
    def _row_weights(gen: torch.Generator, w: torch.Tensor, rate: float,
                     bootstrap: bool, block: tuple | None = None
                     ) -> torch.Tensor:
        """Row sampling as weights: a bootstrap multiplies by Poisson(rate)
        counts (a ``rate`` fraction in expectation, static shapes), plain
        sampling keeps each row with probability ``rate``. On a row block
        ``block`` = (lo, hi, nrows) every rank draws for all the rows and
        keeps its block's draws, so the sample is one rank's."""
        if block is not None and (bootstrap or rate < 1.0):
            lo, hi, n = block
            shape = tuple(w.shape[:-1]) + (n,)
            if bootstrap:
                full = torch.full(shape, rate, dtype=w.dtype, device=w.device)
                return w * torch.poisson(full, generator=gen)[..., lo:hi]
            return w * (torch.rand(shape, generator=gen,
                                   device=w.device)[..., lo:hi] < rate)
        if bootstrap:
            return w * torch.poisson(torch.full_like(w, rate), generator=gen)
        if rate >= 1.0:
            return w
        return w * (torch.rand(w.shape, generator=gen, device=w.device) < rate)

    def _tree_params(self, **over) -> TreeParams:
        p = self.params
        return TreeParams(**dict(
            dict(max_depth=int(p["max_depth"]), nbins=int(p["nbins"]),
                 min_rows=float(p["min_rows"]),
                 reg_lambda=float(p.get("reg_lambda", 0.0)),
                 reg_alpha=float(p.get("reg_alpha", 0.0)),
                 gamma=float(p.get("gamma", 0.0)),
                 min_split_improvement=float(p["min_split_improvement"])),
            **over))


class GBM(SharedTreeBuilder):
    """h2o-py surface: ``H2OGradientBoostingEstimator``."""

    algo = "gbm"
    rank_aware = True
    mesh_refused = ModelBuilder.mesh_refused + ("calibrate_model",)

    def _check_mesh(self, frame, validation_frame) -> None:
        """As the base's; across ranks the custom and huber distributions
        (an uploaded UDF, and huber's per-tree quantile of the residuals)
        are not rank-aware yet."""
        super()._check_mesh(frame, validation_frame)
        dist = str(self.params.get("distribution") or "AUTO").lower()
        if dist in ("custom", "huber"):
            refuse_on_mesh(f"{self.algo}'s distribution={dist!r}")

    #: early-stopping metrics honoured (reference: ScoreKeeper.StoppingMetric)
    STOPPING_METRICS = ("AUTO", "deviance", "logloss", "MSE", "RMSE", "AUC",
                        "misclassification")

    def supports_auto_recovery(self) -> bool:
        return True     # snapshots in _grow_with_stopping

    def _retag_model(self, m: GBMModel) -> GBMModel:
        """A snapshot carries the builder's model class, so that a resume
        passes the checkpoint's algo check; a subclass that grows its
        models here re-classes them."""
        return m

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), learn_rate=0.1, distribution="AUTO",
                    reg_lambda=0.0, col_sample_rate=1.0, quantile_alpha=0.5,
                    huber_alpha=0.9, tweedie_power=1.5,
                    # "python:KEY=module.Class" of an uploaded UDF
                    custom_distribution_func=None)

    def _distribution(self, yvec) -> str:
        dist = str(self.params["distribution"])
        if dist.lower() == "auto":
            dist = "AUTO"
        if yvec.is_categorical:
            if dist not in ("AUTO", "bernoulli", "multinomial"):
                raise ValueError(f"distribution {dist!r} requires a numeric response")
            if dist == "bernoulli" and yvec.cardinality() != 2:
                raise ValueError("Binomial requires the response to be a "
                                 "2-class categorical")
            return "bernoulli" if yvec.cardinality() == 2 else "multinomial"
        if dist == "AUTO":
            return "gaussian"
        if dist == "bernoulli":
            raise ValueError("bernoulli distribution requires a categorical "
                             "(2-level) response")
        if dist == "custom" and not self.params.get(
                "custom_distribution_func"):
            raise ValueError("distribution='custom' requires "
                             "custom_distribution_func "
                             "(h2o.upload_custom_distribution reference)")
        if dist not in DISTRIBUTIONS or dist == "multinomial":
            raise ValueError(f"unsupported distribution {dist!r}; have "
                             f"{', '.join(DISTRIBUTIONS)}, AUTO")
        return dist

    @staticmethod
    def _f0(dist: str, yy, yc, w, p) -> float:
        """The initial margin of each family (reference GBM._fit). The
        weighted mean's sums are taken in float64 (exact for whole weights
        and responses, in any order, so across ranks too), then rounded to
        float32 for the division."""
        num, den = mesh_reduce(
            lambda w, yc: torch.stack([(w.double() * yc.double()).sum(),
                                       w.double().sum()]), w, yc).float()
        ybar = float(num / torch.clamp(den, min=1e-30))
        if dist == "bernoulli":
            ybar = min(max(ybar, 1e-6), 1 - 1e-6)
            return float(np.log(ybar / (1 - ybar)))
        if dist in LOG_LINK:
            return float(np.log(max(ybar, 1e-10)))
        if dist in ("laplace", "huber"):
            return _weighted_quantile_host(yy, w, 0.5)
        if dist == "quantile":
            return _weighted_quantile_host(yy, w, float(p["quantile_alpha"]))
        return ybar

    def _stopping_metric(self, sdist: str, metric: str | None = None) -> str:
        """``metric`` (default ``stopping_metric``) in its canonical
        spelling, checked against the distribution (h2o-py sends enum values
        lowercase)."""
        metric = str(metric or self.params.get("stopping_metric") or "AUTO")
        metric = {m.lower(): m for m in self.STOPPING_METRICS}.get(
            metric.lower(), metric)
        if metric not in self.STOPPING_METRICS:
            raise ValueError(f"unsupported stopping_metric {metric!r}; have "
                             f"{self.STOPPING_METRICS}")
        if metric in ("logloss", "misclassification", "AUC") and sdist not in (
                "bernoulli", "multinomial"):
            raise ValueError(f"stopping_metric={metric!r} requires a "
                             "classification distribution")
        if metric == "AUC" and sdist != "bernoulli":
            raise ValueError("stopping_metric='AUC' requires a binomial "
                             "response")
        return metric

    def _stop_score(self, metric: str, dist: str, F, y, w,
                    nclass: int) -> float:
        """Less-is-better score for ``stopping_metric`` on the host: the same
        math as the per-tree tracker (:func:`_metric_device`)."""
        sdist = "multinomial" if nclass > 1 else dist
        metric = self._stopping_metric(sdist, metric)
        return float(_metric_device(metric, sdist, F, y, w, nclass,
                                    self._custom_link))

    #: the link of the custom distribution being trained (None otherwise)
    _custom_link = None

    def _valid_stop_data(self, edges, nclass: int, f0, lr: float, domains,
                         y_domain, prior_trees=None):
        """The validation frame binned with the training edges (categorical
        features and response remapped to the training domains) and its
        margins seeded (f0, plus a checkpoint's trees), so each tree can be
        scored on it as it grows; None without a validation frame."""
        vf = getattr(self, "_validation_frame", None)
        if vf is None:
            return None
        x = self._x_cols
        Xv = tree_matrix(vf, x, domains)
        binned_v = self._apply_cat_bins(Xv, bin_features(Xv, edges))
        yv, validv = response_adapted(vf.vec(self._y_col), y_domain)
        wv = vf.row_mask().float() * validv
        wcol = self.params.get("weights_column")
        if wcol and wcol in vf:
            wv = wv * vf.vec(wcol).data
        yv = torch.where(wv > 0, yv, 0.0)
        nbins = int(self.params["nbins"])
        if nclass > 1:
            Fval = torch.as_tensor(f0, dtype=torch.float32).to(
                vf.device)[None, :].expand(Xv.shape[0], nclass).contiguous()
            if prior_trees:
                Fval = Fval + lr * torch.stack(
                    [predict_binned(binned_v, ts, nbins)
                     for ts in prior_trees], dim=1)
        else:
            Fval = torch.full((Xv.shape[0],), float(f0), dtype=torch.float32,
                              device=vf.device)
            if prior_trees:
                Fval = Fval + lr * predict_binned(binned_v, prior_trees, nbins)
        return binned_v, yv, wv, Fval

    def _grow_with_stopping(self, job: Job, grow_round, binned, yc, w, Fcur,
                            done: int, ntrees: int, dist: str, nclass: int,
                            lr: float, valid=None, partial=None):
        """Grow rounds ``done`` .. ``ntrees`` - 1, ``grow_round(m, Fcur) ->
        (trees, row_leaf)`` each (one tree, or K class trees and their
        [K, rows] leaves), scoring every round on the card: the training
        margins always, the validation margins with ``valid``. With
        ``stopping_rounds`` the series is fetched in chunks of rounds (one
        host sync a chunk) and the rule (reference ``_grow_with_stopping``:
        a sign-safe relative tolerance, stop once ``since >=
        stopping_rounds``) runs over it; rounds grown past the stop are
        dropped and the margins refolded over the kept ones. Returns the
        kept rounds and the final margins, and leaves the series for the
        scoring history and the count of rounds grown (kept or not) in
        ``_rounds_grown``. With ``auto_recovery_dir``, ``partial(rounds)``
        makes the model of the rounds so far, snapshotted every
        ``H2O3TPU_CHECKPOINT_EVERY`` rounds (with ``stopping_rounds`` at
        the ends of chunks, after the stopping rule has kept its rounds)."""
        p = self.params
        sr = int(p.get("stopping_rounds") or 0)
        sdist = "multinomial" if nclass > 1 else dist
        metric = self._stopping_metric(sdist)
        tol = float(p.get("stopping_tolerance") or 1e-3)
        nbins = int(p["nbins"])
        M = ntrees - done
        # rounds a chunk: a few times stopping_rounds bounds the overshoot;
        # balanced, so that no chunk is much shorter than the others
        per = min(25, max(4 * sr, 16)) if sr > 0 else max(M, 1)
        per = -(-M // max(1, -(-M // per))) if M else 1
        depth = int(p["max_depth"])
        best, since = np.inf, 0
        kept: list = []
        tser: list[float] = []
        vser: list[float] = []
        pending_t: list = []
        pending_v: list = []
        Fval = None if valid is None else valid[3]

        def step_valid(Fv, trees):
            leaves = [tr.leaf[_walk_binned(valid[0], tr, nbins, depth)]
                      for tr in trees]
            return Fv + lr * (leaves[0] if nclass <= 1
                              else torch.stack(leaves, dim=1))

        self._rounds_grown = 0
        every = checkpoint_every() if partial is not None and \
            getattr(self, "_build_recovery", None) is not None else 0
        last_snap = 0
        deadline_stop = False
        chunks = 0
        for s0 in range(done, ntrees, per):
            if job.should_stop and job.deadline_exceeded:
                # max_runtime_secs between chunks: the built rounds are
                # kept, the job ends CANCELLED (an explicit cancel raises
                # from job.update below, as before)
                job.keep_partial()
                break
            F_start, Fval_start = Fcur, Fval

            def grow_chunk(s0=s0, F_start=F_start, Fval_start=Fval_start):
                # a function of the chunk's start margins, so a retried
                # attempt repeats the first one exactly
                nonlocal last_snap
                F, Fv = F_start, Fval_start
                chunk, pt, pv = [], [], []
                stopped = False
                for m in range(s0, min(s0 + per, ntrees)):
                    trees, row_leaf = grow_round(m, F)
                    chunk.append(trees)
                    F = F + lr * (row_leaf if nclass <= 1 else row_leaf.T)
                    pt.append(_metric_device(metric, sdist, F, yc, w,
                                             nclass, self._custom_link))
                    if valid is not None:
                        Fv = step_valid(Fv, trees)
                        pv.append(_metric_device(metric, sdist, Fv,
                                                 valid[1], valid[2],
                                                 nclass, self._custom_link))
                    try:
                        job.update(0.1 + 0.8 * (m + 1 - done) / max(M, 1),
                                   f"{m + 1}/{ntrees} trees")
                    except JobCancelled:
                        if not job.deadline_exceeded:
                            raise
                        # the deadline tripped in update: keep what is
                        # built and stop growing
                        job.keep_partial()
                        stopped = True
                    grown = self._rounds_grown + len(chunk)
                    if every and sr == 0 and grown - last_snap >= every:
                        last_snap = grown
                        self._snapshot(partial(kept + chunk), m + 1, ntrees)
                    if stopped:
                        break
                return chunk, F, Fv, pt, pv, stopped

            with timed_event("tree", f"{self.algo}:chunk",
                             observe=_tm.ITER_SECONDS.labels(
                                 loop=f"{self.algo}_chunk")), \
                    _BOOST_SCAN.dispatch(
                        (binned, yc, w),
                        {"rounds": min(per, ntrees - s0), "nclass": nclass,
                         "depth": depth, "nbins": nbins}):
                # a transient dispatch failure (an injected drop, a
                # transient runtime error) retries with backoff instead of
                # killing the build
                chunk, Fcur, Fval, pt, pv, deadline_stop = retrying(
                    f"{self.algo}_chunk", grow_chunk)
            chunks += 1
            self._rounds_grown += len(chunk)
            pending_t += pt
            pending_v += pv
            stop_at = None
            if sr > 0:
                fetched = torch.stack(pending_t + pending_v).double().cpu()
                _BOOST_SCAN.settle()
                ts = fetched[:len(pending_t)].tolist()
                vs = fetched[len(pending_t):].tolist() if pending_v else None
                pending_t, pending_v = [], []
                for j, dev in enumerate(vs if vs is not None else ts):
                    # sign-safe relative improvement: deviances can be < 0
                    if dev < best - tol * abs(best) or not np.isfinite(best):
                        best, since = dev, 0
                    else:
                        since += 1
                        if since >= sr:
                            stop_at = j
                            break
                keep = len(chunk) if stop_at is None else stop_at + 1
                tser += ts[:keep]
                if vs is not None:
                    vser += vs[:keep]
                if keep < len(chunk):
                    chunk = chunk[:keep]
                    Fcur = self._refold(binned, chunk, nbins, lr, F_start,
                                        nclass)
            kept += chunk
            if stop_at is not None or deadline_stop:
                break
            if every and sr > 0 and len(kept) - last_snap >= every:
                last_snap = len(kept)
                self._snapshot(partial(kept), done + len(kept), ntrees)
        fetches = chunks if sr > 0 else 0
        if pending_t:
            # without stopping: the whole series in one fetch, at the end
            fetched = torch.stack(pending_t + pending_v).double().cpu()
            _BOOST_SCAN.settle()
            fetches += 1
            tser = fetched[:len(pending_t)].tolist()
            vser = fetched[len(pending_t):].tolist()
        self._score_series = (metric, tser, vser or None)
        # the loop's host syncs: one series fetch a chunk with stopping,
        # one at the end without
        publish_dispatch_audit(self, f"{self.algo}_round",
                               iterations=max(len(kept), 1),
                               host_syncs=fetches, device_dispatches=chunks)
        return kept, Fcur

    @staticmethod
    def _refold(binned, rounds: list, nbins: int, lr: float, F_start,
                nclass: int):
        """Margins after ``rounds`` from ``F_start``, folded tree by tree in
        the boosting loop's order (the same bits as growing them)."""
        if nclass <= 1:
            return fold_binned(binned, [r[0] for r in rounds], nbins, lr,
                               F_start)
        return torch.stack([fold_binned(binned, [r[k] for r in rounds], nbins,
                                        lr, F_start[:, k].contiguous())
                            for k in range(nclass)], dim=1)

    def _custom_distribution(self, dist: str):
        """The uploaded distribution of ``dist="custom"`` (None for the
        built-in families), its link kept for the per-tree metric."""
        if dist != "custom":
            self._custom_link = None
            return None
        custom = resolve_distribution(
            str(self.params["custom_distribution_func"]))
        self._custom_link = custom.link_name
        return custom

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> GBMModel:
        p = self.params
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
        cp = self._resolve_checkpoint()
        edges, binned = self._resume_binning(cp, frame, x, edges, binned)
        dist = self._distribution(yvec)
        dev = frame.device
        w = weights * valid
        yc = torch.where(w > 0, yy, 0.0)
        domains = {c: frame.vec(c).domain for c in x
                   if frame.vec(c).is_categorical}
        if dist == "multinomial":
            if p.get("offset_column"):
                raise ValueError("offset_column is not supported for "
                                 "multinomial distributions")
            return self._fit_multinomial(job, frame, x, y, w, yc, yvec, edges,
                                         binned, domains, cp)
        self._check_checkpoint(cp, x, dist)
        custom = self._custom_distribution(dist)
        oc = p.get("offset_column")
        if cp is not None:
            f0 = float(cp.output["f0"])
        elif custom is not None:
            f0 = custom.f0(yy, w, _offset(frame, oc) if oc else None)
        else:
            f0 = self._f0(dist, yy, yc, w, p)
        lr = float(p["learn_rate"])
        params = self._tree_params()
        binned_T = binned.T.contiguous()   # the histogram kernel reads [F, rows]
        fmask_base = torch.ones(binned.shape[1], dtype=torch.bool, device=dev)
        sample_rate = float(p["sample_rate"])
        col_tree_rate = float(p["col_sample_rate_per_tree"])
        col_rate = self._effective_col_rate()
        hp = (float(p["quantile_alpha"]), float(p["huber_alpha"]),
              float(p["tweedie_power"]))
        mono, reach = self._constraint_arrays(x, frame)
        cat_feats = self._cat_feats
        Fcur = torch.full((binned.shape[0],), f0, dtype=torch.float32,
                          device=dev)
        if oc:
            # the offset adds to the margins in training and in scoring
            Fcur = Fcur + _offset(frame, oc)
        trees: list[Tree] = []
        if cp is not None:
            trees = list(cp.output["trees"])
            # folded as the loop adds, so the remaining trees repeat
            Fcur = fold_binned(binned, trees, int(p["nbins"]), lr, Fcur)
        ntrees = int(p["ntrees"])
        done = len(trees)
        valid = None
        if getattr(self, "_validation_frame", None) is not None or \
                int(p.get("stopping_rounds") or 0) > 0:
            valid = self._valid_stop_data(
                edges, 0, f0, lr, domains,
                yvec.domain if yvec.is_categorical else None,
                prior_trees=trees or None)

        def grow_round(m, F):
            gen = self._tree_generator(dev, m)
            wt = self._row_weights(gen, w, sample_rate, bootstrap=False,
                                   block=self._row_block)
            g, h = _grad_hess(dist, F, yc, wt, *hp, custom=custom)
            fmask = self._sample_fmask(gen, fmask_base, col_tree_rate)
            tree, row_leaf = grow_tree(binned, binned_T, edges, g, h, wt,
                                       params, fmask, col_rate, gen,
                                       mono=mono, reach=reach,
                                       cat_feats=cat_feats)
            return [tree], row_leaf

        response_domain = yvec.domain if yvec.is_categorical else None

        def custom_output() -> dict:
            # read when a model is made: the first gradients decide
            # whether the custom distribution runs batched
            return {} if custom is None else dict(
                custom_link=custom.link_name,
                custom_vectorized=custom.vectorized)

        def partial(rounds) -> GBMModel:
            # a resumable model of the rounds so far, under a key of its
            # own (a snapshot never takes the final model's key)
            grown = trees + [r[0] for r in rounds]
            return self._retag_model(GBMModel(
                key=f"{self.model_id or self.algo}_autockpt",
                params=self.params, response_column=y,
                response_domain=response_domain,
                output=dict(trees=grown, edges=edges, f0=f0, learn_rate=lr,
                            distribution=dist, x_cols=list(x),
                            feat_domains=domains, ntrees=len(grown),
                            **custom_output(), **self._cat_output())))

        job.update(0.1, f"growing {ntrees - done} trees")
        rounds, Fcur = self._grow_with_stopping(
            job, grow_round, binned, yc, w, Fcur, done, ntrees, dist, 0, lr,
            valid, partial)
        trees += [r[0] for r in rounds]
        # final margins double as training predictions (skips the re-score)
        if dist == "bernoulli":
            pe = sigmoid(Fcur)
            self._last_train_raw = torch.stack([1 - pe, pe], dim=1)
        elif dist in LOG_LINK:
            self._last_train_raw = torch.exp(torch.clamp(Fcur, -30, 30))
        elif custom is not None:
            self._last_train_raw = linkinv(custom.link_name, Fcur)
        else:
            self._last_train_raw = Fcur
        model = GBMModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=response_domain,
            output=dict(trees=trees, edges=edges, f0=f0, learn_rate=lr,
                        distribution=dist, x_cols=list(x),
                        feat_domains=domains, ntrees=len(trees),
                        **custom_output(), **self._cat_output()))
        self._maybe_calibrate(model)
        return model

    def _fit_multinomial(self, job: Job, frame, x, y, w, yc, yvec, edges,
                         binned, domains, cp=None) -> GBMModel:
        """K trees per round on softmax gradients, grown together
        (reference: GBM.java multinomial, one DTree per class per
        iteration)."""
        p = self.params
        self._check_checkpoint(cp, x, "multinomial")
        if p.get("monotone_constraints"):
            raise ValueError("monotone_constraints are not supported for "
                             "multinomial distributions (reference: GBM.java)")
        dev = binned.device
        K = yvec.cardinality()
        if cp is not None:
            f0 = cp.output["f0_multi"].to(dev)
        else:
            prior = mesh_reduce(
                lambda yc, w: (torch.nn.functional.one_hot(yc.long(), K)
                               .float() * w[:, None]).sum(0),
                yc, w).cpu().numpy().astype(np.float64)
            prior = np.maximum(prior / max(prior.sum(), 1e-30), 1e-10)
            f0 = torch.as_tensor(np.log(prior).astype(np.float32)).to(dev)
        lr = float(p["learn_rate"])
        params = self._tree_params()
        binned_T = binned.T.contiguous()
        fmask_base = torch.ones(binned.shape[1], dtype=torch.bool, device=dev)
        sample_rate = float(p["sample_rate"])
        col_tree_rate = float(p["col_sample_rate_per_tree"])
        col_rate = self._effective_col_rate()
        _, reach = self._constraint_arrays(x, frame)
        cat_feats = self._cat_feats
        Fcur = f0[None, :].expand(binned.shape[0], K).contiguous()
        trees_multi: list[list[Tree]] = [[] for _ in range(K)]
        if cp is not None:
            trees_multi = [list(ts) for ts in cp.output["trees_multi"]]
            # each class's margins folded as the loop adds them
            Fcur = torch.stack([fold_binned(binned, ts, int(p["nbins"]), lr,
                                            Fcur[:, k].contiguous())
                                for k, ts in enumerate(trees_multi)], dim=1)
        ntrees = int(p["ntrees"])
        done = len(trees_multi[0])
        valid = None
        if getattr(self, "_validation_frame", None) is not None or \
                int(p.get("stopping_rounds") or 0) > 0:
            valid = self._valid_stop_data(
                edges, K, f0, lr, domains, yvec.domain,
                prior_trees=trees_multi if done else None)

        def grow_round(m, F):
            gen = self._tree_generator(dev, m)
            wt = self._row_weights(gen, w, sample_rate, bootstrap=False,
                                   block=self._row_block)
            G, H = _grad_hess_multinomial(F, yc, wt)
            fmask = self._sample_fmask(gen, fmask_base, col_tree_rate)
            return grow_trees_batched(
                binned, binned_T, edges, G.T.contiguous(), H.T.contiguous(),
                wt, params, fmask, col_rate, gen, reach=reach,
                cat_feats=cat_feats)

        def partial(rounds) -> GBMModel:
            grown = [list(ts) + [r[k] for r in rounds]
                     for k, ts in enumerate(trees_multi)]
            return self._retag_model(GBMModel(
                key=f"{self.model_id or self.algo}_autockpt",
                params=self.params, response_column=y,
                response_domain=yvec.domain,
                output=dict(trees_multi=grown, edges=edges, f0_multi=f0,
                            learn_rate=lr, distribution="multinomial",
                            x_cols=list(x), feat_domains=domains,
                            ntrees=len(grown[0]), **self._cat_output())))

        job.update(0.1, f"growing {(ntrees - done) * K} trees")
        rounds, Fcur = self._grow_with_stopping(
            job, grow_round, binned, yc, w, Fcur, done, ntrees,
            "multinomial", K, lr, valid, partial)
        for r in rounds:
            for k in range(K):
                trees_multi[k].append(r[k])
        self._last_train_raw = torch.softmax(Fcur, dim=1)
        model = GBMModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=yvec.domain,
            output=dict(trees_multi=trees_multi, edges=edges, f0_multi=f0,
                        learn_rate=lr, distribution="multinomial",
                        x_cols=list(x), feat_domains=domains,
                        ntrees=len(trees_multi[0]), **self._cat_output()))
        self._maybe_calibrate(model)     # raises: not a binomial model
        return model


class DRFModel(SharedTreeModel):
    algo = "drf"

    def _contrib_scale_bias(self):
        return 1.0 / max(self.output["ntrees"], 1), 0.0

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        n = max(self.output["ntrees"], 1)
        if self.output.get("trees_multi") is not None:
            probs = torch.clamp(self._tree_raw_sum_per_class(frame) / n,
                                0.0, 1.0)
            return probs / torch.clamp(probs.sum(dim=1, keepdim=True),
                                       min=1e-30)
        mean = self._tree_raw_sum(frame) / n
        if self.output["binomial"]:
            pmean = torch.clamp(mean, 0.0, 1.0)
            return torch.stack([1 - pmean, pmean], dim=1)
        return mean


class DRF(SharedTreeBuilder):
    """h2o-py surface: ``H2ORandomForestEstimator``.

    Reference: ``hex/tree/drf/DRF.java`` — bagged trees, mtries feature
    sampling per level, predictions averaged. Each tree fits the response
    directly (g = -y*wt, h = wt: the leaf is the in-node weighted mean);
    multinomial (and ``binomial_double_trees``) grows one class-indicator
    tree per class per round, all K in one batched growth. Like the
    reference's, it does not stop early or keep a scoring history; it
    refuses the tree constraints, which the reference's DRF ignores."""

    algo = "drf"

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), mtries=-1, max_depth=14, min_rows=1.0,
                    sample_rate=0.632, binomial_double_trees=False)

    def _refuse_outside_slice(self) -> None:
        super()._refuse_outside_slice()
        for c in ("monotone_constraints", "interaction_constraints"):
            if self.params.get(c):
                raise ValueError(f"DRF does not take {c} (the reference's "
                                 "DRF leaves them unapplied)")

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> DRFModel:
        p = self.params
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
        cp = self._resolve_checkpoint()
        edges, binned = self._resume_binning(cp, frame, x, edges, binned)
        dev = frame.device
        classifier = yvec.is_categorical
        nclass = yvec.cardinality() if classifier else 0
        w = weights * valid
        yc = torch.where(w > 0, yy, 0.0)
        F = binned.shape[1]
        mtries = int(p["mtries"])
        if mtries <= 0:
            mtries = max(1, int(np.sqrt(F)) if classifier else max(F // 3, 1))
        ntrees = int(p["ntrees"])
        params = self._tree_params(reg_lambda=0.0, reg_alpha=0.0, gamma=0.0)
        binned_T = binned.T.contiguous()
        fmask = torch.ones(F, dtype=torch.bool, device=dev)
        sample_rate = float(p["sample_rate"])
        cat_feats = self._cat_feats
        domains = {c: frame.vec(c).domain for c in x
                   if frame.vec(c).is_categorical}
        output = dict(edges=edges, x_cols=list(x), feat_domains=domains,
                      f0=0.0, learn_rate=1.0, **self._cat_output())
        if nclass > 2 or (nclass == 2 and p.get("binomial_double_trees")):
            # one class-indicator tree per class per round; leaf = in-node
            # class fraction (reference DRF.java multinomial ktrees)
            trees_multi: list[list[Tree]] = [[] for _ in range(nclass)]
            if cp is not None:
                if cp.output.get("trees_multi") is None:
                    raise ValueError(
                        "checkpoint was trained without binomial_double_"
                        "trees; the tree layouts are incompatible")
                trees_multi = [list(ts) for ts in cp.output["trees_multi"]]
            done = len(trees_multi[0])
            job.update(0.1, f"growing {(ntrees - done) * nclass} trees")
            yoh = torch.nn.functional.one_hot(yc.long(), nclass).T
            yoh = yoh.float().contiguous()                 # [K, rows]
            for m in range(done, ntrees):
                gen = self._tree_generator(dev, m)
                wt = self._row_weights(gen, w, sample_rate, bootstrap=True)
                G = -(yoh * wt)
                H = wt.expand(nclass, -1).contiguous()
                trees, _ = grow_trees_batched(binned, binned_T, edges, G, H,
                                              wt, params, fmask, mtries / F,
                                              gen, cat_feats=cat_feats)
                for k in range(nclass):
                    trees_multi[k].append(trees[k])
                job.update(0.1 + 0.8 * (m + 1 - done) / (ntrees - done))
            model = DRFModel(
                key=make_model_key(self.algo, self.model_id),
                params=self.params, response_column=y,
                response_domain=yvec.domain,
                output=dict(output, trees_multi=trees_multi, ntrees=ntrees,
                            binomial=False, distribution="multinomial"))
            self._maybe_calibrate(model)
            return model
        trees: list[Tree] = []
        if cp is not None:
            if cp.output.get("trees") is None:
                raise ValueError(
                    "checkpoint was trained with binomial_double_trees; "
                    "the tree layouts are incompatible")
            trees = list(cp.output["trees"])
        done = len(trees)
        job.update(0.1, f"growing {ntrees - done} trees")
        for m in range(done, ntrees):
            gen = self._tree_generator(dev, m)
            wt = self._row_weights(gen, w, sample_rate, bootstrap=True)
            tree, _ = grow_tree(binned, binned_T, edges, -yc * wt, wt, wt,
                                params, fmask, mtries / F, gen,
                                cat_feats=cat_feats)
            trees.append(tree)
            job.update(0.1 + 0.8 * (m + 1 - done) / (ntrees - done))
        model = DRFModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y,
            response_domain=yvec.domain if classifier else None,
            output=dict(output, trees=trees, ntrees=len(trees),
                        binomial=classifier, distribution="gaussian"))
        self._maybe_calibrate(model)
        return model
