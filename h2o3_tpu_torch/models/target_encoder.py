"""TargetEncoder — the port of ``h2o3_tpu/models/target_encoder.py``.

Per categorical column, each level is replaced by the (blended) mean
response of the training rows at that level (reference:
``h2o-extensions/target-encoder``'s ``TargetEncoder.java`` and
``TargetEncoderHelper.java``). ``data_leakage_handling`` KFold encodes
each training row from the other folds' statistics, LeaveOneOut from all
rows but its own; blending shrinks small levels toward the prior by
``inflection_point`` and ``smoothing``; ``noise`` adds a uniform draw to
the training encodings.

The per-level (sum of y, count) statistics are one ``index_add_`` into
K + 1 slots (the last holds missing levels); encoding a frame is one
gather through the level → value table. With unit weights and a 0/1
response every sum is an integer below 2^24, so the float32 atomics of
the card give the CPU's values whatever their order.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import remap_codes, response_as_float
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _blend(sum_y, cnt, prior, inflection_point: float, smoothing: float):
    """Blended level mean (reference
    ``TargetEncoderHelper.getBlendedValue``): lambda = 1 / (1 + exp((ip -
    n) / s)); lambda * mean + (1 - lambda) * prior."""
    mean = sum_y / cnt.clamp_min(1.0)
    lam = 1.0 / (1.0 + torch.exp((inflection_point - cnt)
                                 / max(smoothing, 1e-6)))
    return torch.where(cnt > 0, lam * mean + (1 - lam) * prior, prior)


def _level_values(sum_y, cnt, prior, blend: bool, ip: float, sm: float):
    if blend:
        return _blend(sum_y, cnt, prior, ip, sm)
    return torch.where(cnt > 0, sum_y / cnt.clamp_min(1.0), prior)


def _level_sums(code: torch.Tensor, wy: torch.Tensor, w: torch.Tensor,
                slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of w·y, sum of w) per level slot, by one ``index_add_``."""
    acc = torch.zeros((slots, 2), dtype=torch.float32, device=w.device)
    acc.index_add_(0, code, torch.stack([wy, w], dim=1))
    return acc[:, 0], acc[:, 1]


def _prior(wy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted mean response, as a 0-d float32 tensor (no host sync)."""
    return wy.sum() / w.sum().clamp_min(1e-30)


class TargetEncoderModel(Model):
    algo = "targetencoder"

    def is_applied(self, frame: Frame) -> bool:
        """Whether every column this encoder adds is in the frame already."""
        return all(f"{c}_te" in frame for c in self.output["columns"])

    def transform(self, frame: Frame, as_training: bool = False) -> Frame:
        """The frame with a ``<col>_te`` column added for each encoded
        column (h2o-py ``H2OTargetEncoderEstimator.transform``).
        ``as_training`` gives the training rows' KFold or LeaveOneOut
        encodings (noise included) in place of the full statistics."""
        o = self.output
        names, vecs = list(frame.names), list(frame.vecs)
        if as_training and o["data_leakage_handling"] != "None" \
                and o.get("train_encoded") is not None:
            for c in o["columns"]:
                names.append(f"{c}_te")
                vecs.append(o["train_encoded"][c])
            return Frame(names, vecs)
        for c in o["columns"]:
            v = frame.vec(c)
            lut = o["lut"][c].to(frame.device)   # [K + 1]: levels, NA slot
            na_slot = lut.shape[0] - 1
            codes = v.data
            if v.domain != o["domains"][c]:
                # this frame's levels onto the training domain; a level the
                # training did not see takes the NA slot
                codes = remap_codes(codes, v.domain or (), o["domains"][c])
            codes = torch.where(codes < 0, na_slot, codes).long()
            names.append(f"{c}_te")
            vecs.append(Vec(lut[codes], VecType.NUM))
        return Frame(names, vecs)

    def _score_raw(self, frame: Frame):
        raise NotImplementedError("TargetEncoder is a transformer; use "
                                  "transform()")

    def model_performance(self, frame: Frame):
        return None


class TargetEncoder(ModelBuilder):
    """h2o-py surface: ``H2OTargetEncoderEstimator``."""

    algo = "targetencoder"

    def _holdout_metrics(self, model, frame, y, w):
        return None       # a transformer has no scoring metrics

    def _cross_validate(self, *a, **kw):
        return None       # nfolds sets the KFold leakage handling, not CV

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            columns=None,                       # None → every categorical x
            data_leakage_handling="None",       # None | KFold | LeaveOneOut
            blending=False,
            inflection_point=10.0,
            smoothing=20.0,
            noise=0.0,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> TargetEncoderModel:
        p = self.params
        self._refuse_checkpoint()
        yvec = frame.vec(y)
        if yvec.is_categorical and yvec.cardinality() != 2:
            raise ValueError("TargetEncoder supports binary or numeric targets")
        leak = str(p["data_leakage_handling"])
        if leak not in ("None", "KFold", "LeaveOneOut"):
            raise ValueError(f"data_leakage_handling={leak!r}: None, KFold or "
                             "LeaveOneOut")
        yy, valid = response_as_float(yvec)
        w = weights * valid
        wy = w * yy
        cols = p["columns"] or [c for c in x if frame.vec(c).is_categorical]
        if not cols:
            raise ValueError("no categorical columns to encode")
        prior_t = _prior(wy, w)
        prior = float(prior_t)
        ip, sm = float(p["inflection_point"]), float(p["smoothing"])
        blend = bool(p["blending"])

        nfolds = int(p.get("nfolds") or 5)
        if leak == "KFold" and p.get("fold_column"):
            # every distinct value of the fold column is a fold
            nfolds = self._fold_column_cardinality(frame)
        fold = self._fold_ids(frame, nfolds, yvec) if leak == "KFold" \
            else None
        noise = float(p["noise"])
        gen = None
        if noise > 0:
            seed = int(p.get("seed") or 0) if int(p.get("seed") or -1) >= 0 \
                else 7
            gen = torch.Generator(device=frame.device).manual_seed(seed)

        lut, domains, train_encoded = {}, {}, {}
        for c in cols:
            v = frame.vec(c)
            K = v.cardinality()
            domains[c] = v.domain
            code = torch.where(v.data < 0, K, v.data.clamp(0, K - 1)).long()
            sum_y, cnt = _level_sums(code, wy, w, K + 1)
            vals = _level_values(sum_y, cnt, prior_t, blend, ip, sm)
            # the NA slot: its own statistics where training saw missing
            # levels, else the prior
            na_seen = cnt[K] > 0
            na_val = (_blend(sum_y[K], cnt[K], prior_t, ip, sm) if blend
                      else sum_y[K] / cnt[K])
            vals[K] = torch.where(na_seen, na_val, prior_t)
            lut[c] = vals

            if leak == "KFold":
                enc = torch.zeros(frame.nrows, dtype=torch.float32,
                                  device=frame.device)
                for f in range(nfolds):
                    out_mask = fold == f
                    wf = w * ~out_mask
                    wyf = wf * yy
                    s_f, c_f = _level_sums(code, wyf, wf, K + 1)
                    v_f = _level_values(s_f, c_f, _prior(wyf, wf), blend,
                                        ip, sm)
                    enc = torch.where(out_mask, v_f[code], enc)
                train_encoded[c] = enc
            elif leak == "LeaveOneOut":
                s_loo = sum_y[code] - wy
                c_loo = cnt[code] - w
                train_encoded[c] = _level_values(s_loo, c_loo, prior_t,
                                                 blend, ip, sm)
            if gen is not None and c in train_encoded:
                u = torch.rand(frame.nrows, generator=gen,
                               device=frame.device)
                train_encoded[c] = train_encoded[c] + (-noise + 2 * noise * u)
            job.update(0.9, f"encoded {c}")

        return TargetEncoderModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=y, response_domain=None,
            output=dict(columns=cols, lut=lut, domains=domains, prior=prior,
                        data_leakage_handling=leak,
                        train_encoded={c: Vec(t, VecType.NUM)
                                       for c, t in train_encoded.items()}
                        or None))
