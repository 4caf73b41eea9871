"""NaiveBayes — a classifier of per-class count tables and Gaussians — the
port of ``h2o3_tpu/models/naive_bayes.py`` (reference:
``hex/naivebayes/NaiveBayes.java``, ``NaiveBayesModel.java``).

One pass gathers the sufficient statistics: the weighted count of each
class, a [classes, levels] count table per categorical column and the
per-class count, sum and sum of squares of each numeric column. The JAX
package forms them as one-hot products; here each is an ``index_add_``
into float64 over the rows, so no [rows, levels] one-hot is formed (300
levels at 10M rows would be 12 GB) and the sums do not lose precision
with the row count. Scoring adds log conditionals (Laplace-smoothed
tables; Gaussians with the ``min_sdev``/``eps_sdev`` floor) to the log
prior and takes the softmax.
"""

from __future__ import annotations

import math

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import remap_codes, response_as_float
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _nb_train(y, w, cat_stack, num_stack, nclass: int, cards: tuple):
    """The sufficient statistics, float32: class counts [C], one count
    table [C, card] per categorical column, and the per-class count, sum
    and sum of squares [C, P] of the numeric columns (NA cells left
    out)."""
    dev = y.device
    yi = y.long()
    w64 = w.double()
    class_counts = torch.zeros(nclass, dtype=torch.float64, device=dev
                               ).index_add_(0, yi, w64)
    cat_tables = []
    for j, card in enumerate(cards):
        c = cat_stack[:, j].long()
        ok = c >= 0
        tbl = torch.zeros(nclass * card, dtype=torch.float64, device=dev)
        tbl.index_add_(0, yi * card + c.clamp_min(0),
                       torch.where(ok, w64, 0.0))
        cat_tables.append(tbl.view(nclass, card).float())
    P = num_stack.shape[1]
    if P:
        ok = ~torch.isnan(num_stack)
        xs = torch.where(ok, num_stack, 0.0).double()
        okw = ok.double() * w64[:, None]
        moments = torch.zeros((nclass, 3 * P), dtype=torch.float64,
                              device=dev)
        moments.index_add_(0, yi, torch.cat([okw, okw * xs, okw * xs * xs],
                                            dim=1))
        cnt, s1, s2 = moments.float().split(P, dim=1)
    else:
        cnt = s1 = s2 = torch.zeros((nclass, 0), dtype=torch.float32,
                                    device=dev)
    return class_counts.float(), cat_tables, cnt, s1, s2


def _nb_score(cat_stack, num_stack, log_prior, cat_logp, mu, sd,
              nclass: int, cards: tuple):
    """[rows, C] class probabilities: softmax of the log prior plus the
    log conditionals of the observed cells."""
    n = cat_stack.shape[0] if cards else num_stack.shape[0]
    ll = log_prior[None, :].expand(n, nclass)
    for j, card in enumerate(cards):
        c = cat_stack[:, j]
        contrib = cat_logp[j].T[c.clamp(0, card - 1).long()]    # [n, C]
        ll = ll + torch.where((c >= 0)[:, None], contrib, 0.0)
    if num_stack.shape[1]:
        x = num_stack[:, :, None]                                # [n, P, 1]
        m = mu.T[None, :, :]                                     # [1, P, C]
        s = sd.T[None, :, :]
        logpdf = -0.5 * torch.log(2 * math.pi * s * s) \
            - 0.5 * ((x - m) / s) ** 2
        ll = ll + torch.where(torch.isnan(x), 0.0, logpdf).sum(dim=1)
    return torch.softmax(ll, dim=1)


def _stack_features(frame: Frame, cat_cols, num_cols, train_domains):
    """[rows, cats] int32 codes in the training domains (unseen levels
    missing) and [rows, nums] float32 values."""
    cats = []
    for col, dom in zip(cat_cols, train_domains):
        v = frame.vec(col)
        codes = v.data
        if v.domain != dom:
            codes = remap_codes(codes, v.domain or (), dom)
        cats.append(codes)
    dev = frame.device
    nums = [frame.vec(c).data for c in num_cols]
    cat_stack = torch.stack(cats, dim=1) if cats else \
        torch.zeros((frame.nrows, 0), dtype=torch.int32, device=dev)
    num_stack = torch.stack(nums, dim=1) if nums else \
        torch.zeros((frame.nrows, 0), dtype=torch.float32, device=dev)
    return cat_stack, num_stack


class NaiveBayesModel(Model):
    algo = "naivebayes"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        o = self.output
        cats, nums = _stack_features(frame, o["cat_cols"], o["num_cols"],
                                     o["cat_domains"])
        return _nb_score(cats, nums, o["log_prior"], o["cat_logp"], o["mu"],
                         o["sd"], self.nclasses, o["cards"])


class NaiveBayes(ModelBuilder):
    """h2o-py surface: ``H2ONaiveBayesEstimator``."""

    algo = "naivebayes"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            laplace=0.0,
            min_sdev=0.001,
            eps_sdev=0.0,
            min_prob=0.001,
            eps_prob=0.0,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> NaiveBayesModel:
        p = self.params
        self._refuse_checkpoint()
        yvec = frame.vec(y)
        if not yvec.is_categorical:
            raise ValueError("NaiveBayes requires a categorical response")
        nclass = yvec.cardinality()
        yy, valid = response_as_float(yvec)
        w = weights * valid
        yy = torch.where(w > 0, yy, 0.0)

        cat_cols = [c for c in x if frame.vec(c).is_categorical]
        num_cols = [c for c in x if not frame.vec(c).is_categorical]
        cat_domains = [frame.vec(c).domain for c in cat_cols]
        cards = tuple(len(d) for d in cat_domains)
        cats, nums = _stack_features(frame, cat_cols, num_cols, cat_domains)

        class_counts, cat_tables, cnt, s1, s2 = _nb_train(yy, w, cats, nums,
                                                          nclass, cards)
        lap = float(p["laplace"])
        total = torch.clamp_min(class_counts.sum(), 1e-12)
        log_prior = torch.log(torch.clamp_min(class_counts / total, 1e-30))
        min_prob, eps_prob = float(p["min_prob"]), float(p["eps_prob"])
        cat_logp = []
        for tbl in cat_tables:
            tbl = tbl + lap
            probs = tbl / torch.clamp_min(tbl.sum(dim=1, keepdim=True), 1e-30)
            # min_prob replaces a probability only at or below eps_prob
            # (NaiveBayesModel.java:94)
            probs = torch.where(probs <= eps_prob, min_prob,
                                torch.clamp_min(probs, 1e-30))
            cat_logp.append(torch.log(probs))
        if num_cols:
            nn_ = torch.clamp_min(cnt, 1e-12)
            mu = s1 / nn_
            var = torch.clamp_min(s2 / nn_ - mu * mu, 0.0) * nn_ \
                / torch.clamp_min(nn_ - 1.0, 1.0)
            # min_sdev replaces a deviation only at or below eps_sdev
            # (NaiveBayesModel.java:103)
            sd = torch.sqrt(var)
            sd = torch.where(sd <= float(p["eps_sdev"]),
                             float(p["min_sdev"]), sd)
        else:
            mu = sd = torch.zeros((nclass, 0), dtype=torch.float32,
                                  device=frame.device)
        return NaiveBayesModel(
            key=make_model_key(self.algo, self.model_id), params=p,
            response_column=y, response_domain=yvec.domain,
            output=dict(log_prior=log_prior, cat_logp=cat_logp, mu=mu, sd=sd,
                        cat_cols=cat_cols, num_cols=num_cols,
                        cat_domains=cat_domains, cards=cards,
                        class_counts=class_counts.cpu().numpy()))
