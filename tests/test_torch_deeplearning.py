"""DeepLearning in the port (h2o3_tpu_torch/models/deeplearning.py) against
the JAX reference (``h2o3_tpu/models/deeplearning.py``) on the same
numpy-seeded inputs.

Tolerances: the forward pass and the row loss at rtol 1e-5; one epoch of
four explicit minibatch steps (ADADELTA, momentum SGD with and without
Nesterov, L1, L2 and ``max_w2`` on) holds every weight at rtol 1e-5 with
an absolute floor of 1e-6 x the layer's largest |weight| (a weight that
passes near zero keeps the absolute error of the sum that cancelled);
models carried across by ``convert`` score at rtol 1e-5. The packages'
random streams differ (``jax.random`` against one ``torch.Generator``),
so whole fits are held by their metric: the mean over three seeds of the
port within three standard deviations of the reference's three seeds
(plus a floor of 1% of the mean).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import deeplearning as jdl
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import deeplearning as pdl
from jax_reference import _jax_compile_cache  # noqa: F401

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def _weights(rng, sizes, act):
    W, b = [], []
    for i in range(len(sizes) - 1):
        width = 2 * sizes[i + 1] if act == "maxout" and i < len(sizes) - 2 \
            else sizes[i + 1]
        W.append(rng.normal(scale=0.3, size=(sizes[i], width)).astype(
            np.float32))
        b.append(rng.normal(scale=0.1, size=width).astype(np.float32))
    return W, b


def _nets(W, b, act):
    jp = {"W": [jnp.asarray(a) for a in W], "b": [jnp.asarray(a) for a in b]}
    net = pdl.MLP([torch.tensor(a) for a in W], [torch.tensor(a) for a in b],
                  act)
    return jp, net


def _close_to_layers(net, jparams):
    for k in ("W", "b"):
        for ja, pt in zip(jparams[k], getattr(net, k)):
            a = np.asarray(ja)
            np.testing.assert_allclose(pt.detach().numpy(), a, rtol=RTOL,
                                       atol=1e-6 * np.abs(a).max())


# (nclasses, loss, outputs): multinomial, binomial, regression by each loss,
# and the autoencoder's quadratic loss summed over its outputs
LOSS_CASES = [(3, "crossentropy", 3), (2, "crossentropy", 2),
              (0, "quadratic", 1), (0, "absolute", 1), (0, "huber", 1),
              (0, "quadratic", 6)]


@pytest.mark.parametrize("act", ["tanh", "rectifier", "maxout"])
def test_forward_matches_reference(act):
    rng = np.random.default_rng(3)
    W, b = _weights(rng, [6, 9, 5, 3], act)
    jp, net = _nets(W, b, act)
    X = rng.normal(size=(40, 6)).astype(np.float32)
    jout = jdl._forward(jp, jnp.asarray(X), act, False, jax.random.PRNGKey(0),
                        0.0, ())
    with torch.no_grad():
        pout = net(torch.tensor(X))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("nclasses,loss,outs", LOSS_CASES)
def test_row_loss_matches_reference(nclasses, loss, outs):
    rng = np.random.default_rng(4)
    out = rng.normal(size=(40, outs)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 40).astype(np.float32)
    if nclasses:
        y = rng.integers(0, nclasses, 40).astype(np.float32)
    else:
        y = (2 * rng.normal(size=(40, outs))).astype(np.float32)
    if outs == 1:
        out, y = out[:, 0], y[:, 0]
    jl = jdl._row_loss(jnp.asarray(out), jnp.asarray(y), jnp.asarray(w),
                       loss, nclasses, 1.0)
    pl = pdl._row_loss(torch.tensor(out), torch.tensor(y), torch.tensor(w),
                       loss, nclasses, 1.0)
    np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)


def test_dropout_is_inverted_and_masks_inject():
    """Injected keep masks scale the kept units by 1/(1 - p) and zero the
    rest, layer by layer as the reference's ``jnp.where``; drawn masks keep
    about 1 - p of the units."""
    rng = np.random.default_rng(4)
    W, b = _weights(rng, [5, 7, 2], "rectifier")
    _, net = _nets(W, b, "rectifier")
    X = rng.normal(size=(30, 5)).astype(np.float32)
    keep0 = rng.random((30, 5)) < 0.8
    keep1 = rng.random((30, 7)) < 0.5
    with torch.no_grad():
        got = net(torch.tensor(X), True, None, 0.2, (0.5,),
                  {0: torch.tensor(keep0), 1: torch.tensor(keep1)}).numpy()
    h = np.where(keep0, X / np.float32(0.8), 0.0)
    h = np.maximum(h @ W[0] + b[0], 0.0)
    h = np.where(keep1, h / np.float32(0.5), 0.0)
    np.testing.assert_allclose(got, h @ W[1] + b[1], rtol=RTOL, atol=1e-6)
    gen = torch.Generator().manual_seed(1)
    kept = pdl._dropout(torch.ones(200, 500), 0.3, gen, None)
    assert abs(float((kept > 0).float().mean()) - 0.7) < 0.01
    assert torch.allclose(kept[kept > 0], torch.tensor(1 / 0.7))


# (adaptive, nesterov): ADADELTA, and momentum SGD with and without Nesterov
OPTIMIZERS = [(True, True), (False, True), (False, False)]


@pytest.mark.parametrize("adaptive,nesterov", OPTIMIZERS)
@pytest.mark.parametrize("act,nclasses,loss", [
    ("tanh", 3, "crossentropy"), ("rectifier", 0, "huber"),
    ("maxout", 2, "crossentropy")])
def test_epoch_steps_match_reference(act, adaptive, nesterov, nclasses, loss):
    """Four explicit minibatch steps of one epoch, with L1, L2, the max_w2
    cap, a rate decay per layer and an annealed, ramped momentum: every
    weight, the sample count and the epoch's mean loss."""
    rng = np.random.default_rng(5)
    K, nb, B = 12, 4, 32
    sizes = [K, 16, 8, nclasses or 1]
    W, b = _weights(rng, sizes, act)
    jp, net = _nets(W, b, act)
    Xb = rng.normal(size=(nb, B, K)).astype(np.float32)
    yb = (rng.integers(0, nclasses, (nb, B)) if nclasses
          else rng.normal(size=(nb, B))).astype(np.float32)
    wb = rng.uniform(0.5, 2.0, (nb, B)).astype(np.float32)
    cfg = (adaptive, 0.99, 1e-8, 0.05, 1e-3, 0.7, 0.5, 100.0, 0.9, nesterov,
           1e-4, 1e-3, 3.0, 0.0, (0.0, 0.0), 1.0)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jopt = {"Eg": zeros, "Edx": zeros, "v": zeros}
    jparams, _, _, jsamples, jloss = jdl._epoch_steps(
        jp, jopt, jnp.asarray(Xb), jnp.asarray(yb), jnp.asarray(wb),
        jax.random.PRNGKey(0), jnp.float32(0.0), act, loss, nclasses, cfg)
    samples, ploss = pdl._epoch_steps(
        net, pdl._zero_state(net), torch.tensor(Xb), torch.tensor(yb),
        torch.tensor(wb), None, torch.tensor(0.0), loss, nclasses,
        pdl.StepConfig(*cfg))
    _close_to_layers(net, jparams)
    np.testing.assert_allclose(float(samples), float(jsamples), rtol=RTOL)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL)


def test_autoencoder_epoch_steps_match_reference():
    """The autoencoder's steps: the minibatch is its own target."""
    rng = np.random.default_rng(6)
    W, b = _weights(rng, [7, 4, 7], "tanh")
    jp, net = _nets(W, b, "tanh")
    Xb = rng.normal(size=(4, 16, 7)).astype(np.float32)
    wb = np.ones((4, 16), np.float32)
    cfg = (True, 0.99, 1e-8, 0.005, 1e-6, 1.0, 0.0, 1e6, 0.0, True, 0.0, 0.0,
           3.4028235e38, 0.0, (0.0,), 1.0)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jparams, *_ = jdl._epoch_steps(
        jp, {"Eg": zeros, "Edx": zeros, "v": zeros}, jnp.asarray(Xb),
        jnp.asarray(Xb), jnp.asarray(wb), jax.random.PRNGKey(0),
        jnp.float32(0.0), "tanh", "quadratic", 0, cfg)
    Xt = torch.tensor(Xb)
    pdl._epoch_steps(net, pdl._zero_state(net), Xt, Xt, torch.tensor(wb),
                     None, torch.tensor(0.0), "quadratic", 0,
                     pdl.StepConfig(*cfg))
    _close_to_layers(net, jparams)


def dl_cols(n, task, seed=11):
    """Six numeric features and a categorical one; y from a nonlinear
    function of them, as 3 classes, 2 classes or a number."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    cat = rng.integers(0, 3, n)
    f = np.tanh(X[:, 0] + 0.5 * X[:, 1] * X[:, 2]) + 0.4 * (cat == 1) \
        - 0.3 * X[:, 3] ** 2
    cols = {f"x{i}": X[:, i] for i in range(6)}
    cols["c"] = np.array(["a", "b", "c"], dtype=object)[cat]
    noise = 0.3 * rng.normal(size=n)
    if task == "multinomial":
        cols["y"] = np.array(["lo", "mid", "hi"], dtype=object)[
            np.digitize(f + noise, [-0.5, 0.3])]
    elif task == "binomial":
        cols["y"] = np.where(f + noise > 0, "Y", "N").astype(object)
    else:
        cols["y"] = (f + noise).astype(np.float32)
    return cols


# (task, metric, higher is better)
FIT_CASES = [("multinomial", "logloss"), ("binomial", "auc"),
             ("regression", "rmse")]


@pytest.mark.parametrize("task,metric", FIT_CASES)
def test_whole_fits_match_reference_by_metric(task, metric):
    cols = dl_cols(256, task)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    params = dict(hidden=[12], epochs=3, mini_batch_size=32,
                  activation="Rectifier")
    ref, got = [], []
    for seed in (1, 2, 3):
        jm = jdl.DeepLearning(seed=seed, **params).train(y="y",
                                                         training_frame=jf)
        pm = pdl.DeepLearning(seed=seed, **params).train(y="y",
                                                         training_frame=pf)
        ref.append(float(getattr(jm.training_metrics, metric)))
        got.append(float(getattr(pm.training_metrics, metric)))
        assert len(pm.output["score_history"]) == 3
        assert pm.output["samples_trained"] == 3 * 256
    ref, got = np.array(ref), np.array(got)
    assert abs(got.mean() - ref.mean()) <= 3 * max(ref.std(), got.std()) \
        + 0.01 * abs(ref.mean()), (metric, ref, got)


def _convert(jm):
    return convert.deeplearning_model(
        {k: (jax.tree.map(np.asarray, v) if k == "params" else v)
         for k, v in jm.output.items()},
        dataclasses.asdict(jm.data_info), jm.response_column,
        jm.response_domain, dict(jm.params), device="cpu")


@pytest.mark.parametrize("task", ["multinomial", "regression"])
def test_reference_model_scores_alike_through_convert(task):
    cols = dl_cols(200, task, seed=12)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = jdl.DeepLearning(hidden=[8], epochs=2, activation="Maxout",
                          seed=4).train(y="y", training_frame=jf)
    pm = _convert(jm)
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == jp.names
    for c in pp.names[1:] if task == "multinomial" else pp.names:
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   jp.vec(c).to_numpy()[:200], rtol=RTOL,
                                   atol=1e-7)


def test_autoencoder_anomaly_through_convert():
    cols = dl_cols(160, "regression", seed=13)
    del cols["y"]
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = jdl.AutoEncoder(hidden=[4], epochs=2, activation="Tanh",
                         seed=2).train(training_frame=jf)
    pm = _convert(jm)
    np.testing.assert_allclose(
        pm.anomaly(pf).vec("Reconstruction.MSE").to_numpy(),
        jm.anomaly(jf).vec("Reconstruction.MSE").to_numpy()[:160], rtol=RTOL)
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == jp.names and pp.names[0] == "reconstr_c.a"
    for c in pp.names:
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   jp.vec(c).to_numpy()[:160], rtol=RTOL,
                                   atol=1e-6)
    # the port's own autoencoder learns to reconstruct
    pa = pdl.AutoEncoder(hidden=[4], epochs=3, activation="Tanh",
                         seed=2).train(training_frame=pf)
    hist = [h["train_loss"] for h in pa.output["score_history"]]
    assert pa.training_metrics is None and hist[-1] < hist[0]


@pytest.mark.parametrize("params,y,err", [
    (dict(loss="Quadratic"), "cls", ValueError),
    (dict(loss="CrossEntropy"), "num", ValueError),
    (dict(hidden_dropout_ratios=[0.2]), "cls", ValueError),
    (dict(activation="RectifierWithDropout", hidden_dropout_ratios=[0.2, 0.1]),
     "cls", ValueError),
    (dict(activation="Sigmoid"), "cls", ValueError),
    (dict(initial_weight_distribution="Gamma"), "cls", ValueError),
    (dict(elastic=-1), "cls", ValueError),
    (dict(local_steps=-1), "cls", ValueError),
    (dict(elastic=2), "cls", NotImplementedError),
    (dict(huber_alpha=0.5), "num", NotImplementedError),
    (dict(score_each_iteration=True), "cls", NotImplementedError),
])
def test_validation_errors(params, y, err):
    cols = dl_cols(64, "multinomial")
    cols["num"] = cols["x0"] * 2
    cols["cls"] = cols.pop("y")
    pf = Frame.from_arrays(cols)
    with pytest.raises(err):
        pdl.DeepLearning(hidden=[4], epochs=1, **params).train(
            y=y, training_frame=pf)


def test_checkpoint_continues_and_checks_topology():
    cols = dl_cols(256, "binomial", seed=14)
    pf = Frame.from_arrays(cols)
    params = dict(hidden=[8], mini_batch_size=16, seed=3)
    m1 = pdl.DeepLearning(epochs=1, **params).train(y="y", training_frame=pf)
    m2 = pdl.DeepLearning(epochs=1, checkpoint=m1, **params).train(
        y="y", training_frame=pf)
    assert m2.output["samples_trained"] == 2 * 256
    assert m2.params["checkpoint"] == m1.key
    assert not torch.equal(m1.output["net"].W[0], m2.output["net"].W[0])
    with pytest.raises(ValueError, match="topology"):
        pdl.DeepLearning(hidden=[9], epochs=1, checkpoint=m1).train(
            y="y", training_frame=pf)


def test_injected_permutation_and_init_fix_the_fit(monkeypatch):
    """With the permutation and the initial weights injected (drawn from
    numpy), two fits of the port are the same bits, and the epoch
    consumes the rows in the injected order."""
    cols = dl_cols(96, "regression", seed=15)
    pf = Frame.from_arrays(cols)
    seen = []

    def perm(n, gen, device):
        seen.append(n)
        return torch.as_tensor(np.random.default_rng(len(seen)).permutation(
            n)).to(device)

    def init(sizes, act, dist, scale, gen, device):
        W, b = _weights(np.random.default_rng(0), sizes, act)
        return ([torch.tensor(a).to(device) for a in W],
                [torch.tensor(a).to(device) for a in b])

    monkeypatch.setattr(pdl, "_permutation", perm)
    monkeypatch.setattr(pdl, "_init_params", init)
    nets = []
    for seed in (1, 2):   # the generator's seed no longer matters
        m = pdl.DeepLearning(hidden=[5], epochs=2, mini_batch_size=10,
                             seed=seed).train(y="y", training_frame=pf)
        assert seen == [96, 96]
        nets.append(m.output["net"])
        seen.clear()
    for a, b in zip(nets[0].params(), nets[1].params()):
        assert torch.equal(a, b)
