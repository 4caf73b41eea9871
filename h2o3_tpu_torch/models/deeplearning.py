"""DeepLearning — a feed-forward MLP for classification, regression and the
autoencoder — the port of ``h2o3_tpu/models/deeplearning.py`` (reference:
``hex/deeplearning/Neurons.java``, ``DeepLearning.java``).

The network is an ``nn.Module`` (:class:`MLP`) whose weights keep the JAX
package's layout: ``W[i]`` is ``[fan_in, width]`` and ``b[i]`` ``[width]``,
a maxout layer ``2·units`` wide. Training is synchronous minibatch SGD: an
epoch is one permutation of the rows, then ``rows // B`` minibatch steps
(the remainder dropped). A step (:func:`_step`) takes the gradient of the
weighted mean loss by autograd, adds the L1/L2 terms (to the biases too),
and updates the weights by hand in the reference's order: ADADELTA, or
momentum SGD with the annealed, per-layer-decayed rate and the reference's
Nesterov form ``p + mom·v − lr·g`` with ``v`` already updated; then the
``max_w2`` cap. ``torch.optim``'s Adadelta and Nesterov SGD compute other
formulas, so they are not used.

One ``torch.Generator`` on the fit's device, seeded from ``seed``, draws
the initial weights, each epoch's permutation and the dropout masks. The
JAX package's ``jax.random`` streams cannot be reproduced, so a fit is
held to the reference by its metric; tests inject the weights, the
permutation (:func:`_permutation`) and the masks. The epoch loop never
waits for the device: the per-epoch losses and the sample count stay on it
and are fetched once, after the last epoch. With ``auto_recovery_dir`` a
snapshot of the weights (with ``epochs_done``) is written every
``H2O3TPU_CHECKPOINT_EVERY`` epochs, and a resumed build trains the
remaining epochs. The reference's elastic local-SGD needs the multi-GPU
layer and raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.data_info import DataInfo, response_as_float
from h2o3_tpu_torch.models.job import Job, JobCancelled
from h2o3_tpu_torch.models.model_base import (Model, ModelBuilder,
                                              make_model_key,
                                              publish_dispatch_audit)
from h2o3_tpu_torch.persist.recovery import checkpoint_every
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.utils.costs import accounted
from h2o3_tpu_torch.utils.timeline import timed_event


def _epoch_cost(args, statics) -> tuple[float, float]:
    """One epoch of minibatch SGD on the [R, P] design through layers of
    ``sizes``: 6 FLOP per weight and row (forward 2, backward 4); bytes are
    the design and weights read once an epoch and each minibatch step's
    weights, gradients and update state read and written once. The
    activations' traffic is left out."""
    X = args[0]
    R = X.shape[0]
    sizes = statics["sizes"]
    nweights = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    steps = max(R // max(int(statics["batch"]), 1), 1)
    return (6.0 * R * nweights,
            float(X.numel() * 4 + R * 4 + steps * nweights * 4 * 6))


#: an epoch of DeepLearning as a site of the compute observatory (the
#: reference's ``dl:train_epochs`` program)
_EPOCH_SITE = accounted("dl:train_epochs", _epoch_cost, loop="dl_epoch")


#: the seed of a fit whose ``seed`` is unset (the reference's)
DEFAULT_SEED = 5318008


class StepConfig(NamedTuple):
    """The hyperparameters of a step, in the reference's ``cfg`` order."""

    adaptive: bool
    rho: float
    eps: float
    rate: float
    rate_annealing: float
    rate_decay: float
    mom_start: float
    mom_ramp: float
    mom_stable: float
    nesterov: bool
    l1: float
    l2: float
    max_w2: float
    in_drop: float
    hid_drops: tuple
    huber_delta: float


def _act_kind(activation: str) -> tuple[str, bool]:
    """Map the activation enum to (base activation, hidden dropout on)."""
    a = activation.lower()
    drop = a.endswith("withdropout")
    base = a.replace("withdropout", "")
    if base not in ("tanh", "rectifier", "maxout"):
        raise ValueError(f"unknown activation {activation!r}")
    return base, drop


def _dropout(h: torch.Tensor, p: float, gen, keep):
    """Inverted dropout of ratio ``p``: ``keep`` (bool, h's shape) if given,
    else drawn from ``gen``."""
    if keep is None:
        keep = torch.rand(h.shape, generator=gen, device=h.device) < 1.0 - p
    return torch.where(keep, h / (1.0 - p), 0.0)


def _forward(net: "MLP", X: torch.Tensor, train: bool = False, gen=None,
             in_drop: float = 0.0, hid_drops: tuple = (), masks=None):
    """The MLP's output (logits or predictions, linear). Maxout layers take
    the max of the two halves of their ``2·units`` columns. Dropout is
    inverted (scaled at training time), so scoring needs no rescale;
    ``masks`` ({0: the input's keep mask, i + 1: hidden layer i's}) replaces
    the drawn ones."""
    h = X
    masks = masks or {}
    if train and in_drop > 0:
        h = _dropout(h, in_drop, gen, masks.get(0))
    n_hidden = len(net.W) - 1
    for i in range(n_hidden):
        z = h @ net.W[i] + net.b[i]
        if net.act == "tanh":
            h = torch.tanh(z)
        elif net.act == "rectifier":
            h = torch.clamp_min(z, 0.0)
        else:
            u = z.shape[-1] // 2
            h = torch.maximum(z[..., :u], z[..., u:])
        p = hid_drops[i] if i < len(hid_drops) else 0.0
        if train and p > 0:
            h = _dropout(h, p, gen, masks.get(i + 1))
    return h @ net.W[-1] + net.b[-1]


class MLP(nn.Module):
    """The network: ``W[i]`` [fan_in, width], ``b[i]`` [width], one
    activation for every hidden layer."""

    def __init__(self, Ws, bs, act: str):
        super().__init__()
        self.W = nn.ParameterList([nn.Parameter(w) for w in Ws])
        self.b = nn.ParameterList([nn.Parameter(b) for b in bs])
        self.act = act

    def forward(self, X, train: bool = False, gen=None, in_drop: float = 0.0,
                hid_drops: tuple = (), masks=None):
        return _forward(self, X, train, gen, in_drop, hid_drops, masks)

    def params(self) -> list:
        """Weights then biases, the order of the optimizer's state."""
        return list(self.W) + list(self.b)


def _row_loss(out, y, w, loss: str, nclasses: int, huber_delta: float):
    """The weighted loss summed over the batch: cross-entropy for
    classifiers, else quadratic (½e²), absolute or huber, summed over the
    outputs of a multi-output (autoencoder) net."""
    if nclasses >= 2:
        logp = torch.log_softmax(out, dim=-1)
        nll = -logp.gather(1, y.long()[:, None])[:, 0]
        return (w * nll).sum()
    err = out - (y if out.dim() == 1 else y.reshape(out.shape))
    if loss == "absolute":
        e = err.abs()
    elif loss == "huber":
        a = err.abs()
        e = torch.where(a <= huber_delta, 0.5 * a * a,
                        huber_delta * (a - 0.5 * huber_delta))
    else:
        e = 0.5 * err * err
    if e.dim() == 2:
        e = e.sum(dim=1)
    return (w * e).sum()


def _zero_state(net: MLP) -> dict:
    """ADADELTA's running averages and the momentum, zero."""
    return {k: [torch.zeros_like(p) for p in net.params()]
            for k in ("Eg", "Edx", "v")}


def _step(net: MLP, opt: dict, X, y, w, gen, samples, loss: str,
          nclasses: int, cfg: StepConfig, masks=None):
    """One minibatch step, in place on ``net`` and ``opt``; returns the
    new sample count and the step's weighted mean loss (both device
    scalars)."""
    params = net.params()
    out = net(X, True, gen, cfg.in_drop, cfg.hid_drops, masks)
    if nclasses == 0 and out.shape[-1] == 1 and y.dim() == 1:
        out = out[:, 0]
    lossv = _row_loss(out, y, w, loss, nclasses, cfg.huber_delta) \
        / w.sum().clamp_min(1e-8)
    grads = torch.autograd.grad(lossv, params)
    with torch.no_grad():
        g = list(grads)
        if cfg.l1 or cfg.l2:
            g = [gi + cfg.l2 * pi + cfg.l1 * torch.sign(pi)
                 for gi, pi in zip(g, params)]
        if cfg.adaptive:
            # ADADELTA, each line the reference's expression in its order
            rho, eps, fe = cfg.rho, cfg.eps, torch._foreach_mul
            Eg = torch._foreach_add(fe(opt["Eg"], rho),
                                    fe(fe(g, 1 - rho), g))
            dx = torch._foreach_div(
                torch._foreach_sqrt(torch._foreach_add(opt["Edx"], eps)),
                torch._foreach_sqrt(torch._foreach_add(Eg, eps)))
            torch._foreach_mul_(dx, g)
            torch._foreach_neg_(dx)
            opt["Edx"] = torch._foreach_add(fe(opt["Edx"], rho),
                                            fe(fe(dx, 1 - rho), dx))
            opt["Eg"] = Eg
            torch._foreach_add_(params, dx)
        else:
            nl = len(net.W)
            lr0 = cfg.rate / (1.0 + cfg.rate_annealing * samples)
            lrs = [lr0 * (cfg.rate_decay ** i) for i in range(nl)]
            if cfg.mom_ramp > 0:
                mom = torch.clamp_max(
                    cfg.mom_start + samples * (cfg.mom_stable - cfg.mom_start)
                    / max(cfg.mom_ramp, 1.0), cfg.mom_stable)
            else:
                mom = cfg.mom_stable
            # weights and biases of layer i share its rate
            step = [lrs[j % nl] * gi for j, gi in enumerate(g)]
            v = [mom * vi - s for vi, s in zip(opt["v"], step)]
            for pi, vi, s in zip(params, v, step):
                pi.copy_(pi + mom * vi - s if cfg.nesterov else pi + vi)
            opt["v"] = v
        if 0 < cfg.max_w2 < 1e30 and np.isfinite(cfg.max_w2):
            for W in net.W:
                ss = (W * W).sum(dim=0, keepdim=True)
                W.mul_(torch.sqrt(cfg.max_w2 / torch.clamp_min(ss,
                                                               cfg.max_w2)))
        samples = samples + w.sum()
    return samples, lossv.detach()


def _epoch_steps(net: MLP, opt: dict, Xb, yb, wb, gen, samples, loss: str,
                 nclasses: int, cfg: StepConfig, masks=None):
    """The steps of one epoch over minibatches ``Xb`` [nb, B, K], ``yb``
    and ``wb`` [nb, B]; ``masks`` (tests) one dict of keep masks a step.
    Returns the sample count and the epoch's mean step loss, on the
    device."""
    losses = []
    for i in range(Xb.shape[0]):
        samples, lv = _step(net, opt, Xb[i], yb[i], wb[i], gen, samples,
                            loss, nclasses, cfg,
                            None if masks is None else masks[i])
        losses.append(lv)
    return samples, torch.stack(losses).mean()


def _permutation(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """An epoch's row order, drawn on the device from the fit's generator."""
    return torch.randperm(n, generator=gen, device=device)


def _init_params(sizes: list[int], act: str, dist: str, scale: float,
                 gen: torch.Generator, device) -> tuple[list, list]:
    """Initial weights (UniformAdaptive, Uniform or Normal) and zero
    biases; maxout hidden layers twice as wide."""
    Ws, bs = [], []
    n_layers = len(sizes) - 1
    for i in range(n_layers):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        width = 2 * fan_out if act == "maxout" and i < n_layers - 1 \
            else fan_out
        W = torch.empty((fan_in, width), dtype=torch.float32, device=device)
        if dist == "uniformadaptive":
            lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
            W.uniform_(-lim, lim, generator=gen)
        elif dist == "uniform":
            W.uniform_(-scale, scale, generator=gen)
        elif dist == "normal":
            W.normal_(0.0, 1.0, generator=gen).mul_(scale)
        else:
            raise ValueError(f"unknown initial_weight_distribution {dist!r}")
        Ws.append(W)
        bs.append(torch.zeros(width, dtype=torch.float32, device=device))
    return Ws, bs


class DeepLearningModel(Model):
    algo = "deeplearning"

    def _out(self, frame: Frame) -> tuple:
        """(the network's output, the design) of a frame."""
        X = self.data_info.expand(frame)
        with torch.no_grad():
            return self.output["net"](X), X

    def _score_raw(self, frame: Frame) -> torch.Tensor:
        out, _ = self._out(frame)
        if self.is_classifier:
            return torch.softmax(out, dim=-1)
        if self.params.get("autoencoder"):
            return out
        return out[:, 0].contiguous()

    def anomaly(self, frame: Frame) -> Frame:
        """Per-row reconstruction MSE (reference: ``DeepLearningModel
        .scoreAutoEncoder``)."""
        if not self.params.get("autoencoder"):
            raise ValueError("anomaly() requires autoencoder=True")
        out, X = self._out(frame)
        return Frame(["Reconstruction.MSE"],
                     [Vec.from_device(((out - X) ** 2).mean(dim=1),
                                      VecType.NUM)])

    def predict(self, frame: Frame) -> Frame:
        if self.params.get("autoencoder"):
            out = self._score_raw(frame)
            names = [f"reconstr_{n}" for n in self.data_info.coef_names]
            return Frame(names, [Vec.from_device(out[:, i].contiguous(),
                                                 VecType.NUM)
                                 for i in range(out.shape[1])])
        return super().predict(frame)


class DeepLearning(ModelBuilder):
    """h2o-py surface: ``H2ODeepLearningEstimator``."""

    algo = "deeplearning"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            hidden=[200, 200],
            epochs=10.0,
            activation="Rectifier",
            adaptive_rate=True,
            rho=0.99,
            epsilon=1e-8,
            rate=0.005,
            rate_annealing=1e-6,
            rate_decay=1.0,
            momentum_start=0.0,
            momentum_ramp=1e6,
            momentum_stable=0.0,
            nesterov_accelerated_gradient=True,
            input_dropout_ratio=0.0,
            hidden_dropout_ratios=None,     # 0.5 each with *WithDropout
            l1=0.0,
            l2=0.0,
            max_w2=3.4028235e38,            # this large: no cap
            loss="Automatic",       # CrossEntropy|Quadratic|Absolute|Huber
            huber_alpha=0.9,                # the huber delta is fixed at 1
            mini_batch_size=32,
            standardize=True,
            use_all_factor_levels=True,
            initial_weight_distribution="UniformAdaptive",
            initial_weight_scale=1.0,
            autoencoder=False,
            score_each_iteration=False,
            elastic=0,                      # local-SGD workers: multi-GPU
            local_steps=1,
        )

    def train(self, x=None, y=None, training_frame=None, validation_frame=None,
              weights=None):
        self.unsupervised = bool(self.params.get("autoencoder"))
        return super().train(x=x, y=y, training_frame=training_frame,
                             validation_frame=validation_frame,
                             weights=weights)

    def _refuse_unapplied(self) -> None:
        """The reference's validation, and parameters the port does not
        apply: they raise by name."""
        p = self.params
        el, ls = int(p.get("elastic") or 0), p.get("local_steps")
        if el < 0:
            raise ValueError("elastic must be >= 0 (worker count; 0 = off)")
        if ls is not None and int(ls) < 0:
            raise ValueError("local_steps must be >= 0")
        if el:
            raise NotImplementedError(
                "elastic local-SGD needs the multi-GPU layer, which the port "
                "does not have yet")
        if p.get("huber_alpha") != 0.9:
            raise NotImplementedError("huber_alpha is not applied: the huber "
                                      "delta is fixed at 1")
        if p.get("score_each_iteration"):
            raise NotImplementedError("score_each_iteration is not applied: "
                                      "the loss is recorded each epoch")

    def supports_auto_recovery(self) -> bool:
        return True     # a snapshot every H2O3TPU_CHECKPOINT_EVERY epochs

    def _validate(self, frame, x, y):
        if not self.params.get("autoencoder"):
            super()._validate(frame, x, y)

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> DeepLearningModel:
        p = self.params
        self._refuse_unapplied()
        act, act_dropout = _act_kind(p["activation"])
        autoenc = bool(p["autoencoder"])
        dev = frame.device

        di = DataInfo.make(frame, x, standardize=p["standardize"],
                           use_all_factor_levels=p["use_all_factor_levels"])
        X = di.expand(frame)
        n, K = X.shape
        if autoenc:
            yy, w = X, weights
            nclasses, loss, domain = 0, "quadratic", None
        else:
            yvec = frame.vec(y)
            yy, valid = response_as_float(yvec)
            w = weights * valid
            nclasses = yvec.cardinality() if yvec.is_categorical else 0
            domain = yvec.domain if yvec.is_categorical else None
            loss = str(p["loss"]).lower()
            if loss == "automatic":
                loss = "crossentropy" if nclasses else "quadratic"
            if nclasses and loss != "crossentropy":
                raise ValueError("classification requires CrossEntropy loss")
            if not nclasses and loss == "crossentropy":
                raise ValueError("CrossEntropy loss requires a categorical "
                                 "response (reference: DeepLearningParameters "
                                 "validation)")
            yy = torch.where(w > 0, yy, 0.0)

        hidden = [int(h) for h in p["hidden"]]
        out_dim = K if autoenc else (nclasses if nclasses >= 2 else 1)
        sizes = [K] + hidden + [out_dim]
        seed = int(p.get("seed") or -1)
        seed = seed if seed >= 0 else DEFAULT_SEED
        cp = self._resolve_checkpoint()
        samples0 = 0.0
        done_ep = 0
        if cp is not None:
            # continue the same topology from the prior weights (reference
            # DeepLearning.java:348); the stream moves on with the samples
            if cp.output["sizes"] != sizes or cp.output["act"] != act:
                raise ValueError("checkpoint topology/activation differs; "
                                 "hidden/activation are immutable across "
                                 "resume")
            samples0 = float(cp.output.get("samples_trained") or 0.0)
            # an auto-recovery snapshot carries the epochs it trained: the
            # resumed build trains the rest of them
            done_ep = int(cp.output.get("epochs_done") or 0)
            gen = torch.Generator(device=dev).manual_seed(
                (seed * 1_000_003 + 1 + int(samples0)) % (1 << 62))
            Ws = [w_.detach().to(dev).clone() for w_ in cp.output["net"].W]
            bs = [b_.detach().to(dev).clone() for b_ in cp.output["net"].b]
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            Ws, bs = _init_params(
                sizes, act, str(p["initial_weight_distribution"]).lower(),
                float(p["initial_weight_scale"]), gen, dev)
        net = MLP(Ws, bs, act)
        opt = _zero_state(net)

        hid_drops = p["hidden_dropout_ratios"]
        if hid_drops is not None and not act_dropout:
            raise ValueError("hidden_dropout_ratios require a *WithDropout "
                             "activation (reference: DeepLearningParameters "
                             "validation)")
        if hid_drops is None:
            hid_drops = [0.5 if act_dropout else 0.0] * len(hidden)
        if len(hid_drops) != len(hidden):
            raise ValueError("hidden_dropout_ratios must match hidden length")
        cfg = StepConfig(
            bool(p["adaptive_rate"]), float(p["rho"]), float(p["epsilon"]),
            float(p["rate"]), float(p["rate_annealing"]),
            float(p["rate_decay"]), float(p["momentum_start"]),
            float(p["momentum_ramp"]), float(p["momentum_stable"]),
            bool(p["nesterov_accelerated_gradient"]), float(p["l1"]),
            float(p["l2"]), float(p["max_w2"]),
            float(p["input_dropout_ratio"]),
            tuple(float(d) for d in hid_drops), 1.0)

        B = min(max(int(p["mini_batch_size"]), 1), n)
        nb = n // B
        used = nb * B
        n_epochs = max(max(int(np.ceil(float(p["epochs"]))), 1) - done_ep, 0)
        # filled on the device: a copy from the host would wait for it
        samples = torch.full((), samples0, dtype=torch.float32, device=dev)
        epoch_losses = []
        every = checkpoint_every() \
            if getattr(self, "_build_recovery", None) is not None else 0

        def snapshot(epochs_now: int) -> None:
            net_now = MLP([w_.detach().clone() for w_ in net.W],
                          [b_.detach().clone() for b_ in net.b], act)
            self._snapshot(DeepLearningModel(
                key=f"{self.model_id or self.algo}_autockpt", params=p,
                response_column=None if autoenc else y,
                response_domain=domain,
                output=dict(net=net_now, act=act, sizes=sizes,
                            score_history=[],
                            samples_trained=float(samples.item()),
                            epochs_done=done_ep + epochs_now),
                data_info=di), done_ep + epochs_now, done_ep + n_epochs)

        for ep in range(n_epochs):
            with timed_event("iteration", "dl_epoch",
                             observe=_tm.ITER_SECONDS.labels(
                                 loop="dl_epoch")), \
                    _EPOCH_SITE.dispatch((X, w), {"sizes": tuple(sizes),
                                                  "batch": B}):
                perm = _permutation(n, gen, dev)[:used]
                Xb = X[perm].view(nb, B, K)
                yb = Xb if autoenc else yy[perm].view(nb, B)
                wb = w[perm].view(nb, B)
                samples, mloss = _epoch_steps(net, opt, Xb, yb, wb, gen,
                                              samples, loss, nclasses, cfg)
            epoch_losses.append(mloss)
            try:
                job.update((ep + 1) / n_epochs, f"epoch {ep + 1}/{n_epochs}")
            except JobCancelled:
                if not job.deadline_exceeded:
                    raise
                # max_runtime_secs: keep the epochs trained so far
                job.keep_partial()
                break
            if every and (ep + 1) % every == 0 and ep + 1 < n_epochs:
                snapshot(ep + 1)
        # the one fetch of the fit: every epoch's loss and the sample count
        fetched = torch.stack(epoch_losses + [samples]).cpu().tolist()
        _EPOCH_SITE.settle()
        publish_dispatch_audit(self, "dl_epoch",
                               iterations=max(len(epoch_losses), 1),
                               host_syncs=1,
                               device_dispatches=len(epoch_losses))
        score_history = [{"epoch": i + 1, "train_loss": v}
                         for i, v in enumerate(fetched[:-1])]
        for prm in net.parameters():
            prm.requires_grad_(False)
        return DeepLearningModel(
            key=make_model_key(self.algo, self.model_id), params=p,
            response_column=None if autoenc else y, response_domain=domain,
            output=dict(net=net, act=act, sizes=sizes,
                        score_history=score_history,
                        samples_trained=fetched[-1]),
            data_info=di)

    def _scoring_history(self, model):
        """Per-epoch rows (reference: ``DeepLearningScoringInfo`` →
        ``createScoringHistoryTable``)."""
        hist = model.output.get("score_history") or []
        return self._history_table(
            model,
            [("epochs", "double", "%.1f"),
             ("training_loss", "double", "%.5f")],
            [[float(h["epoch"]), float(h["train_loss"])] for h in hist])


class AutoEncoder(DeepLearning):
    """h2o-py surface: ``H2OAutoEncoderEstimator``."""

    @classmethod
    def defaults(cls) -> dict:
        d = super().defaults()
        d["autoencoder"] = True
        d["hidden"] = [20]
        return d
