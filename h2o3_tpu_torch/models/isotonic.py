"""Isotonic regression by pool-adjacent-violators — the port of
``h2o3_tpu/models/isotonic.py`` (reference:
``hex/isotonic/IsotonicRegression.java``).

The fit sums (w, w·y) per unique x on the frame's device (one sort, two
``index_add_`` in float64) and fetches the unique-x table once; the PAV
merge is sequential and runs on the host in float64, over that table.
Scoring is a ``searchsorted`` and a linear interpolation between the
breakpoints on the device, with ``out_of_bounds`` NA or clip.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import response_as_float
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _pav(ys: np.ndarray, ws: np.ndarray) -> np.ndarray:
    """Weighted PAVA over block means (the stack algorithm, O(n)), in
    float64 on the host; Python floats carry the blocks, with the
    reference's arithmetic in its order."""
    n = len(ys)
    mean, weight, size = [0.0] * n, [0.0] * n, [0] * n
    yl, wl = np.asarray(ys, np.float64).tolist(), \
        np.asarray(ws, np.float64).tolist()
    top = 0
    for i in range(n):
        mean[top], weight[top], size[top] = yl[i], wl[i], 1
        while top > 0 and mean[top - 1] >= mean[top]:
            wsum = weight[top - 1] + weight[top]
            mean[top - 1] = (mean[top - 1] * weight[top - 1]
                             + mean[top] * weight[top]) / max(wsum, 1e-300)
            weight[top - 1] = wsum
            size[top - 1] += size[top]
            top -= 1
        top += 1
    return np.repeat(np.asarray(mean[:top], np.float64),
                     np.asarray(size[:top], np.int64))


def _interp(x: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor):
    """Piecewise-linear interpolation through the thresholds, clipped at
    the ends."""
    idx = torch.clamp(torch.searchsorted(tx, x.contiguous(), right=True) - 1,
                      0, tx.shape[0] - 2)
    x0, x1 = tx[idx], tx[idx + 1]
    y0, y1 = ty[idx], ty[idx + 1]
    t = torch.where(x1 > x0, (x - x0) / torch.clamp(x1 - x0, min=1e-30), 0.0)
    return y0 + torch.clamp(t, 0.0, 1.0) * (y1 - y0)


class IsotonicRegressionModel(Model):
    algo = "isotonicregression"

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        o = self.output
        x = frame.vec(o["x_col"]).as_float()
        pred = _interp(torch.clamp(x, o["min_x"], o["max_x"]),
                       o["thresholds_x"], o["thresholds_y"])
        if str(self.params.get("out_of_bounds", "NA")).upper() == "NA":
            oob = (x < o["min_x"]) | (x > o["max_x"])
            pred = torch.where(oob, torch.nan, pred)
        return torch.where(torch.isnan(x), torch.nan, pred)


class IsotonicRegression(ModelBuilder):
    """h2o-py surface: ``H2OIsotonicRegressionEstimator`` (one feature)."""

    algo = "isotonicregression"
    supports_classification = False

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), out_of_bounds="NA")

    def _fit(self, job: Job, frame: Frame, x, y, weights
             ) -> IsotonicRegressionModel:
        self._refuse_checkpoint()
        if len(x) != 1:
            raise ValueError("IsotonicRegression requires exactly one "
                             "feature column")
        xv = frame.vec(x[0]).as_float()
        yy, valid = response_as_float(frame.vec(y))
        w = weights * valid * ~torch.isnan(xv)
        keep = w > 0
        xs, wk = xv[keep], w[keep]
        if xs.numel() == 0:
            raise ValueError("no usable rows")
        # the products in float32, as the reference forms them, then summed
        # in float64 per unique x
        wy = (wk * yy[keep]).double()
        ux, inv = torch.unique(xs, sorted=True, return_inverse=True)
        sw = torch.zeros(ux.numel(), dtype=torch.float64, device=xs.device)
        swy = torch.zeros_like(sw)
        sw.index_add_(0, inv, wk.double())
        swy.index_add_(0, inv, wy)
        ux_h = ux.cpu().numpy()
        sw_h, swy_h = torch.stack([sw, swy]).cpu().numpy()
        ymean = swy_h / np.maximum(sw_h, 1e-300)

        fitted = _pav(ymean, sw_h)
        # thresholds: the breakpoints (first and last of each constant block)
        change = np.ones(len(ux_h), bool)
        if len(ux_h) > 2:
            interior_same = (fitted[1:-1] == fitted[:-2]) \
                & (fitted[1:-1] == fitted[2:])
            change[1:-1] = ~interior_same
        tx, ty = ux_h[change], fitted[change]
        if len(tx) == 1:
            tx = np.array([tx[0], tx[0] + 1.0])
            ty = np.array([ty[0], ty[0]])

        job.update(1.0, f"{len(tx)} thresholds")

        def on_dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(frame.device)

        return IsotonicRegressionModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, response_column=y, response_domain=None,
            output=dict(
                thresholds_x=on_dev(tx), thresholds_y=on_dev(ty),
                min_x=float(ux_h[0]), max_x=float(ux_h[-1]), x_col=x[0],
                nobs=int(xs.numel())))
