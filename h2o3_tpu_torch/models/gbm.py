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
Row and column sampling draw from one ``torch.Generator`` made from the
builder's ``seed`` and passed down explicitly: the port's random numbers
are its own, not JAX's.

Distributions: bernoulli, multinomial, gaussian, poisson, gamma, tweedie,
laplace, quantile and huber, with ``offset_column``. Left for later slices:
the custom distribution (it needs ``utils/udf.py``), early stopping and
scoring history, checkpoint resume, calibration, categorical group splits,
monotone and interaction constraints, varimp and TreeSHAP.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import response_as_float
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key
from h2o3_tpu_torch.models.tree import (Tree, TreeParams, grow_tree,
                                        grow_trees_batched, predict_raw)
from h2o3_tpu_torch.ops.quantile import bin_column, bin_dtype, compute_bin_edges

#: the GBM distributions the port trains
DISTRIBUTIONS = ("bernoulli", "multinomial", "gaussian", "poisson", "gamma",
                 "tweedie", "laplace", "quantile", "huber")
#: the families whose margins are on the log scale
LOG_LINK = ("poisson", "gamma", "tweedie")


def tree_matrix(frame: Frame, cols: list[str],
                domains: dict[str, tuple]) -> torch.Tensor:
    """[rows, F] raw float32 feature matrix; categorical codes are mapped
    onto the training domain (a level unseen in training is missing)."""
    arrs = []
    for c in cols:
        v = frame.vec(c)
        dom = domains.get(c)
        if v.is_categorical and dom and v.domain != dom:
            pos = {s: i for i, s in enumerate(dom)}
            lut = torch.tensor([pos.get(s, -1) for s in v.domain] + [-1],
                               dtype=torch.int32, device=v.device)
            codes = lut[torch.where(v.data < 0, len(v.domain), v.data).long()]
            arrs.append(torch.where(codes < 0, torch.nan, codes.float()))
        else:
            arrs.append(v.as_float())
    return torch.stack(arrs, dim=1)


def _weighted_quantile_host(y: torch.Tensor, w: torch.Tensor,
                            prob: float) -> float:
    """Weighted quantile of y over rows with w > 0 (host side, once per
    training: the initial margin of laplace, quantile and huber)."""
    yh = y.detach().cpu().numpy().astype(np.float64)
    wh = w.detach().cpu().numpy().astype(np.float64)
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
               tweedie_power: float = 1.5):
    """Per-row (g, h) of the loss at margins F (reference: the
    ``hex/Distribution.java`` families; the non-smooth losses take the
    standard GBM pseudo-residual with a unit hessian, so the leaf is the
    weighted mean pseudo-residual). The hyperparameters enter as float32
    scalars, as the reference's traced float32 values do."""
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
        raise NotImplementedError("distribution 'custom' needs "
                                  "utils/udf.py, which is not ported yet")
    raise ValueError(f"unknown distribution {dist!r}")


def _grad_hess_multinomial(F: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Softmax gradients for all K classes at once (reference: GBM.java
    multinomial pseudo-residuals). F: [rows, K]; y: class ids as floats;
    returns (g, h) [rows, K]."""
    p = torch.softmax(F, dim=1)
    yoh = torch.nn.functional.one_hot(y.long(), F.shape[1]).to(F.dtype)
    return (w[:, None] * (p - yoh),
            w[:, None] * torch.clamp(p * (1 - p), min=1e-10))


def _offset(frame: Frame, col: str) -> torch.Tensor:
    """The per-row margin offset (NaN reads as 0)."""
    if col not in frame:
        raise ValueError(f"scoring frame lacks offset column {col!r}")
    return torch.nan_to_num(frame.vec(col).as_float(), nan=0.0)


class SharedTreeModel(Model):
    """Scoring common to the tree models: sums of the trees' leaves on the
    raw feature matrix, for one tree set or one per class."""

    def _tree_raw_sum(self, frame: Frame) -> torch.Tensor:
        if not self.output["trees"]:
            return torch.zeros(frame.nrows, dtype=torch.float32,
                               device=frame.device)
        X = tree_matrix(frame, self.output["x_cols"], self.output["feat_domains"])
        return predict_raw(X, self.output["trees"])

    def _tree_raw_sum_per_class(self, frame: Frame) -> torch.Tensor:
        """[rows, K] per-class sums (``trees_multi[k]`` is class k)."""
        per_class = self.output["trees_multi"]
        if not any(per_class):
            return torch.zeros((frame.nrows, len(per_class)),
                               dtype=torch.float32, device=frame.device)
        X = tree_matrix(frame, self.output["x_cols"], self.output["feat_domains"])
        return torch.stack([predict_raw(X, ts) for ts in per_class], dim=1)


class GBMModel(SharedTreeModel):
    algo = "gbm"

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
            p = torch.sigmoid(f)
            return torch.stack([1 - p, p], dim=1)
        if out["distribution"] in LOG_LINK:
            return torch.exp(torch.clamp(f, -30, 30))
        return f


class SharedTreeBuilder(ModelBuilder):
    """Training code common to the tree models (reference:
    hex/tree/SharedTree.java)."""

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), ntrees=50, max_depth=5, min_rows=10.0,
                    nbins=64, sample_rate=1.0, col_sample_rate_per_tree=1.0,
                    min_split_improvement=1e-5, offset_column=None)

    # dense-heap trees cap depth at 16 (2^17 nodes)
    MAX_TREE_DEPTH = 16

    def _prepare(self, frame: Frame, x: list[str], y: str, weights):
        """Bin edges from a strided sample of at most ~100k rows, the binned
        training matrix, and the response with its validity mask."""
        depth = int(self.params["max_depth"])
        if depth > self.MAX_TREE_DEPTH:
            raise ValueError(f"max_depth={depth} exceeds the dense-heap limit "
                             f"{self.MAX_TREE_DEPTH}")
        cats = [c for c in x if frame.vec(c).is_categorical]
        if cats:
            raise NotImplementedError(
                f"categorical predictors {cats} need group splits, which the "
                "port does not have yet")
        nrows = frame.nrows
        stride = max(1, nrows // 100_000)
        idx = torch.arange(0, nrows, stride, device=frame.device)
        sample = torch.stack([frame.vec(c).as_float()[idx] for c in x],
                             dim=1).cpu().numpy()
        # weighted edges keep the weights-as-replication contract
        w_sample = weights[idx].cpu().numpy().astype(np.float64)
        edges = torch.as_tensor(compute_bin_edges(
            sample, int(self.params["nbins"]), w_sample)).to(frame.device)
        binned = self._bin_frame(frame, x, edges)
        yvec = frame.vec(y)
        yy, valid = response_as_float(yvec)
        return edges, binned, yy, valid, yvec

    def _bin_frame(self, frame: Frame, x: list[str], edges) -> torch.Tensor:
        """Per-column binning → [rows, F] int8/int16 bins (int8 up to 125
        bins halves the histogram kernel's dominant input)."""
        nbins = int(self.params["nbins"])
        dtype = bin_dtype(nbins)
        return torch.stack([bin_column(frame.vec(c).as_float(), edges[j],
                                       nbins, dtype)
                            for j, c in enumerate(x)], dim=1)

    def _generator(self, device: torch.device) -> torch.Generator:
        """The training's one source of randomness, on its device, seeded
        from ``seed`` (42 when unset, as in the reference)."""
        seed = int(self.params["seed"])
        return torch.Generator(device=device).manual_seed(
            seed if seed >= 0 else 42)

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
        m[torch.randint(0, F, (1,), generator=gen, device=device)] = True
        return m

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
                     bootstrap: bool) -> torch.Tensor:
        """Row sampling as weights: a bootstrap multiplies by Poisson(rate)
        counts (a ``rate`` fraction in expectation, static shapes), plain
        sampling keeps each row with probability ``rate``."""
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

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), learn_rate=0.1, distribution="AUTO",
                    reg_lambda=0.0, col_sample_rate=1.0, quantile_alpha=0.5,
                    huber_alpha=0.9, tweedie_power=1.5)

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
        if dist == "custom":
            raise NotImplementedError("distribution 'custom' needs "
                                      "utils/udf.py, which is not ported yet")
        if dist not in DISTRIBUTIONS or dist == "multinomial":
            raise ValueError(f"unsupported distribution {dist!r}; have "
                             f"{', '.join(DISTRIBUTIONS)}, AUTO")
        return dist

    @staticmethod
    def _f0(dist: str, yy, yc, w, p) -> float:
        """The initial margin of each family (reference GBM._fit)."""
        ybar = float((w * yc).sum() / torch.clamp(w.sum(), min=1e-30))
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

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> GBMModel:
        p = self.params
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
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
            return self._fit_multinomial(job, x, y, w, yc, yvec, edges,
                                         binned, domains)
        f0 = self._f0(dist, yy, yc, w, p)
        lr = float(p["learn_rate"])
        params = self._tree_params()
        binned_T = binned.T.contiguous()   # the histogram kernel reads [F, rows]
        fmask_base = torch.ones(binned.shape[1], dtype=torch.bool, device=dev)
        gen = self._generator(dev)
        sample_rate = float(p["sample_rate"])
        col_tree_rate = float(p["col_sample_rate_per_tree"])
        col_rate = self._effective_col_rate()
        hp = (float(p["quantile_alpha"]), float(p["huber_alpha"]),
              float(p["tweedie_power"]))
        Fcur = torch.full((binned.shape[0],), f0, dtype=torch.float32,
                          device=dev)
        oc = p.get("offset_column")
        if oc:
            # the offset adds to the margins in training and in scoring
            Fcur = Fcur + _offset(frame, oc)
        ntrees = int(p["ntrees"])
        trees: list[Tree] = []
        job.update(0.1, f"growing {ntrees} trees")
        for m in range(ntrees):
            wt = self._row_weights(gen, w, sample_rate, bootstrap=False)
            g, h = _grad_hess(dist, Fcur, yc, wt, *hp)
            fmask = self._sample_fmask(gen, fmask_base, col_tree_rate)
            tree, row_leaf = grow_tree(binned, binned_T, edges, g, h, wt,
                                       params, fmask, col_rate, gen)
            trees.append(tree)
            Fcur = Fcur + lr * row_leaf
            job.update(0.1 + 0.8 * (m + 1) / max(ntrees, 1),
                       f"{m + 1}/{ntrees} trees")
        # final margins double as training predictions (skips the re-score)
        if dist == "bernoulli":
            pe = torch.sigmoid(Fcur)
            self._last_train_raw = torch.stack([1 - pe, pe], dim=1)
        elif dist in LOG_LINK:
            self._last_train_raw = torch.exp(torch.clamp(Fcur, -30, 30))
        else:
            self._last_train_raw = Fcur
        return GBMModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(trees=trees, edges=edges, f0=f0, learn_rate=lr,
                        distribution=dist, x_cols=list(x),
                        feat_domains=domains, ntrees=len(trees)))

    def _fit_multinomial(self, job: Job, x, y, w, yc, yvec, edges, binned,
                         domains) -> GBMModel:
        """K trees per round on softmax gradients, grown together
        (reference: GBM.java multinomial, one DTree per class per
        iteration)."""
        p = self.params
        dev = binned.device
        K = yvec.cardinality()
        yoh = torch.nn.functional.one_hot(yc.long(), K).float() * w[:, None]
        prior = yoh.sum(0).cpu().numpy().astype(np.float64)
        del yoh
        prior = np.maximum(prior / max(prior.sum(), 1e-30), 1e-10)
        f0 = torch.as_tensor(np.log(prior).astype(np.float32)).to(dev)
        lr = float(p["learn_rate"])
        params = self._tree_params()
        binned_T = binned.T.contiguous()
        fmask_base = torch.ones(binned.shape[1], dtype=torch.bool, device=dev)
        gen = self._generator(dev)
        sample_rate = float(p["sample_rate"])
        col_tree_rate = float(p["col_sample_rate_per_tree"])
        col_rate = self._effective_col_rate()
        Fcur = f0[None, :].expand(binned.shape[0], K).contiguous()
        ntrees = int(p["ntrees"])
        trees_multi: list[list[Tree]] = [[] for _ in range(K)]
        job.update(0.1, f"growing {ntrees * K} trees")
        for m in range(ntrees):
            wt = self._row_weights(gen, w, sample_rate, bootstrap=False)
            G, H = _grad_hess_multinomial(Fcur, yc, wt)
            fmask = self._sample_fmask(gen, fmask_base, col_tree_rate)
            trees, row_leaf = grow_trees_batched(
                binned, binned_T, edges, G.T.contiguous(), H.T.contiguous(),
                wt, params, fmask, col_rate, gen)
            for k in range(K):
                trees_multi[k].append(trees[k])
            Fcur = Fcur + lr * row_leaf.T
            job.update(0.1 + 0.8 * (m + 1) / max(ntrees, 1),
                       f"{m + 1}/{ntrees} rounds of {K} trees")
        self._last_train_raw = torch.softmax(Fcur, dim=1)
        return GBMModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=yvec.domain,
            output=dict(trees_multi=trees_multi, edges=edges, f0_multi=f0,
                        learn_rate=lr, distribution="multinomial",
                        x_cols=list(x), feat_domains=domains, ntrees=ntrees))


class DRFModel(SharedTreeModel):
    algo = "drf"

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
    tree per class per round, all K in one batched growth."""

    algo = "drf"

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), mtries=-1, max_depth=14, min_rows=1.0,
                    sample_rate=0.632, binomial_double_trees=False)

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> DRFModel:
        p = self.params
        edges, binned, yy, valid, yvec = self._prepare(frame, x, y, weights)
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
        gen = self._generator(dev)
        sample_rate = float(p["sample_rate"])
        domains = {c: frame.vec(c).domain for c in x
                   if frame.vec(c).is_categorical}
        output = dict(edges=edges, ntrees=ntrees, x_cols=list(x),
                      feat_domains=domains, f0=0.0, learn_rate=1.0)
        job.update(0.1, f"growing {ntrees} rounds")
        if nclass > 2 or (nclass == 2 and p.get("binomial_double_trees")):
            # one class-indicator tree per class per round; leaf = in-node
            # class fraction (reference DRF.java multinomial ktrees)
            yoh = torch.nn.functional.one_hot(yc.long(), nclass).T
            yoh = yoh.float().contiguous()                 # [K, rows]
            trees_multi: list[list[Tree]] = [[] for _ in range(nclass)]
            for m in range(ntrees):
                wt = self._row_weights(gen, w, sample_rate, bootstrap=True)
                G = -(yoh * wt)
                H = wt.expand(nclass, -1).contiguous()
                trees, _ = grow_trees_batched(binned, binned_T, edges, G, H,
                                              wt, params, fmask, mtries / F,
                                              gen)
                for k in range(nclass):
                    trees_multi[k].append(trees[k])
                job.update(0.1 + 0.8 * (m + 1) / ntrees)
            return DRFModel(
                key=make_model_key(self.algo, self.model_id),
                params=self.params, response_column=y,
                response_domain=yvec.domain,
                output=dict(output, trees_multi=trees_multi, binomial=False,
                            distribution="multinomial"))
        trees: list[Tree] = []
        for m in range(ntrees):
            wt = self._row_weights(gen, w, sample_rate, bootstrap=True)
            tree, _ = grow_tree(binned, binned_T, edges, -yc * wt, wt, wt,
                                params, fmask, mtries / F, gen)
            trees.append(tree)
            job.update(0.1 + 0.8 * (m + 1) / ntrees)
        return DRFModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y,
            response_domain=yvec.domain if classifier else None,
            output=dict(output, trees=trees, binomial=classifier,
                        distribution="gaussian"))
