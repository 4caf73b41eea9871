"""Model metrics — the regression, binomial and multinomial part of
``h2o3_tpu/models/metrics.py``.

Binomial AUC uses the reference's 400-bin streaming histogram of scores
(``hex/AUC2.java``): one pass on the device fills per-bin positive,
negative and score sums plus logloss and MSE; ROC, PR and the max-F1
confusion matrix come from the histogram on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h2o3_tpu_torch.models.distributions import get_family

NBINS = 400  # reference: AUC2.NBINS=400
#: numpy 2 renamed trapz; the card's machine may carry either numpy
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclasses.dataclass
class MetricsBase:
    nobs: int
    mse: float

    @property
    def rmse(self) -> float:
        return float(np.sqrt(self.mse))


@dataclasses.dataclass
class ModelMetricsRegression(MetricsBase):
    mae: float
    rmsle: float
    mean_residual_deviance: float
    r2: float

    def __repr__(self):
        return (f"ModelMetricsRegression(rmse={self.rmse:.6g}, mse={self.mse:.6g}, "
                f"mae={self.mae:.6g}, deviance={self.mean_residual_deviance:.6g}, "
                f"r2={self.r2:.4f})")


@dataclasses.dataclass
class ModelMetricsBinomial(MetricsBase):
    auc: float
    pr_auc: float
    logloss: float
    mean_per_class_error: float
    max_f1_threshold: float
    confusion_matrix: np.ndarray  # 2x2 at max-F1 threshold, rows=actual
    ks: float = 0.0               # Kolmogorov-Smirnov (max TPR-FPR)
    gini: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.gini = 2.0 * self.auc - 1.0

    def __repr__(self):
        return (f"ModelMetricsBinomial(auc={self.auc:.5f}, pr_auc={self.pr_auc:.5f}, "
                f"logloss={self.logloss:.5f}, rmse={self.rmse:.5f}, "
                f"mean_per_class_error={self.mean_per_class_error:.5f})")


@dataclasses.dataclass
class ModelMetricsMultinomial(MetricsBase):
    logloss: float
    mean_per_class_error: float
    confusion_matrix: np.ndarray   # [K, K], rows = actual, columns = predicted

    @property
    def accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.trace(cm) / max(cm.sum(), 1))

    def __repr__(self):
        return (f"ModelMetricsMultinomial(logloss={self.logloss:.5f}, "
                f"mean_per_class_error={self.mean_per_class_error:.5f}, "
                f"accuracy={self.accuracy:.4f})")


def regression_metrics(pred: torch.Tensor, y: torch.Tensor,
                       mask: torch.Tensor) -> ModelMetricsRegression:
    """Gaussian regression metrics over rows where ``mask`` holds."""
    w = mask.float()
    n = w.sum()
    err = torch.where(mask, pred - y, 0.0)
    mse = (err * err).sum() / n
    mae = err.abs().sum() / n
    both_pos = mask & (pred > -1) & (y > -1)
    le = torch.where(both_pos, torch.log1p(pred.clamp_min(-1 + 1e-10))
                     - torch.log1p(y), 0.0)
    rmsle = torch.sqrt((le * le).sum() / n)
    ymean = torch.where(mask, y, 0.0).sum() / n
    ss_tot = torch.where(mask, (y - ymean) ** 2, 0.0).sum()
    r2 = 1.0 - (err * err).sum() / ss_tot.clamp_min(1e-30)
    dev = get_family("gaussian").deviance(y, pred)
    mrd = torch.where(mask, dev, 0.0).sum() / n
    r = torch.stack([n, mse, mae, rmsle, r2, mrd]).tolist()
    return ModelMetricsRegression(nobs=int(r[0]), mse=r[1], mae=r[2],
                                  rmsle=r[3], mean_residual_deviance=r[5],
                                  r2=r[4])


def _binomial_pass(p: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                   nbins: int = NBINS) -> dict:
    """One pass: 400-bin score histogram (AUC2 semantics) + logloss + MSE."""
    w = mask.float()
    n = w.sum()
    pc = p.clamp(1e-7, 1 - 1e-7)
    logloss = -(w * (y * torch.log(pc) + (1 - y) * torch.log1p(-pc))).sum() / n
    err = torch.where(mask, p - y, 0.0)
    mse = (err * err).sum() / n
    bins = (p * nbins).to(torch.int32).clamp(0, nbins - 1)
    bins = torch.where(mask, bins, 0).long()
    hist = torch.zeros((nbins, 3), dtype=torch.float32, device=p.device)
    hist.index_add_(0, bins, torch.stack([w * y, w * (1.0 - y), w * p], 1))
    return dict(n=float(n), logloss=float(logloss), mse=float(mse),
                tp_h=hist[:, 0].cpu().numpy(), fp_h=hist[:, 1].cpu().numpy(),
                s_h=hist[:, 2].cpu().numpy())


def binomial_metrics(p: torch.Tensor, y: torch.Tensor,
                     mask: torch.Tensor) -> ModelMetricsBinomial:
    """AUC, PR-AUC, logloss, MSE and the max-F1 confusion matrix of the
    positive-class probability ``p`` against 0/1 labels ``y``."""
    r = _binomial_pass(p, y, mask)
    tp_h, fp_h = np.asarray(r["tp_h"], np.float64), np.asarray(r["fp_h"], np.float64)
    P, N = tp_h.sum(), fp_h.sum()
    # descending threshold sweep: cumulative TP/FP from the top bin down;
    # tps/fps are monotone, so the descending sweep IS the ROC polyline
    tps = np.cumsum(tp_h[::-1])[::-1]
    fps = np.cumsum(fp_h[::-1])[::-1]
    tpr_pts = np.concatenate([[0.0], (tps / max(P, 1e-30))[::-1], [1.0]])
    fpr_pts = np.concatenate([[0.0], (fps / max(N, 1e-30))[::-1], [1.0]])
    auc = float(_trapezoid(tpr_pts, fpr_pts))
    prec = tps / np.maximum(tps + fps, 1e-30)
    rec = tps / max(P, 1e-30)
    pr_auc = float(_trapezoid(prec[::-1], rec[::-1]))
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-30)
    b = int(np.argmax(f1))
    tp, fp = tps[b], fps[b]
    fn, tn = P - tp, N - fp
    mpce = 0.5 * (fp / max(N, 1e-30) + fn / max(P, 1e-30))
    ks = float(np.max(tps / max(P, 1e-30) - fps / max(N, 1e-30)))
    return ModelMetricsBinomial(
        nobs=int(r["n"]), mse=r["mse"], auc=auc, pr_auc=pr_auc,
        logloss=r["logloss"], mean_per_class_error=float(mpce),
        max_f1_threshold=b / NBINS, confusion_matrix=np.array([[tn, fp], [fn, tp]]),
        ks=ks)


def _multinomial_pass(probs: torch.Tensor, y: torch.Tensor,
                      mask: torch.Tensor, nclass: int) -> dict:
    """One pass: logloss and MSE of the true class's probability, and the
    confusion matrix as one ``index_add_`` on actual*K + predicted."""
    w = mask.float()
    n = w.sum()
    yi = torch.where(mask, y.long(), 0)
    p_true = probs.gather(1, yi[:, None])[:, 0].clamp(1e-15, 1.0)
    logloss = -(w * torch.log(p_true)).sum() / n
    mse = (w * (1.0 - p_true) ** 2).sum() / n
    pred = probs.argmax(dim=1)
    idx = torch.where(mask, yi * nclass + pred, 0)
    cm = torch.zeros(nclass * nclass, dtype=torch.float32, device=probs.device)
    cm.index_add_(0, idx, w)
    return dict(n=float(n), logloss=float(logloss), mse=float(mse),
                cm=cm.reshape(nclass, nclass).cpu().numpy())


def multinomial_metrics(probs: torch.Tensor, y: torch.Tensor,
                        mask: torch.Tensor,
                        nclass: int) -> ModelMetricsMultinomial:
    """Logloss, MSE, mean per-class error and the confusion matrix of
    [rows, K] class probabilities against class ids ``y``."""
    r = _multinomial_pass(probs, y, mask, nclass)
    cm = np.asarray(r["cm"], np.float64)
    row = cm.sum(axis=1)
    per_class_err = 1.0 - np.diag(cm) / np.maximum(row, 1e-30)
    mpce = float(per_class_err[row > 0].mean()) if (row > 0).any() else 0.0
    return ModelMetricsMultinomial(
        nobs=int(r["n"]), mse=r["mse"], logloss=r["logloss"],
        mean_per_class_error=mpce, confusion_matrix=cm)
