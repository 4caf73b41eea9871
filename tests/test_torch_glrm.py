"""GLRM in the port (h2o3_tpu_torch/models/decomposition.py) against the JAX
reference (``h2o3_tpu/models/decomposition.py``) on the same numpy-seeded
inputs.

Tolerances: every loss of ``_glrm_loss_and_grad`` (value and gradient)
and every proximal operator at rtol 1e-6; the exact path's objective at
rtol 1e-4 and its reconstruction at rtol 1e-4 (batched 5 x 5 solves and
float32 products summed in another order); one proximal fit's objective
at rtol 1e-3 (the step rule compares objectives, so an ulp can move a
step); a model carried across by ``convert`` reconstructs at rtol 1e-5.
The SVD init's eigenvectors may differ in sign between the packages, which
leaves A·Y and the objective unchanged, so factors are not compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import decomposition as jdec
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import decomposition as pdec
from jax_reference import _jax_compile_cache  # noqa: F401

N = 256          # a multiple of 8 devices x 8 rows: the reference pads none


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def glrm_cols(n=N, cats=False, seed=0):
    """Six numeric columns of rank 3 plus noise, 2% missing; with ``cats``
    two categorical columns that follow the first factor."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3))
    X = (A @ rng.normal(size=(3, 6)) + 0.1 * rng.normal(size=(n, 6))
         ).astype(np.float32)
    X[rng.random((n, 6)) < 0.02] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(6)}
    if cats:
        cols["c1"] = np.array(["lo", "mid", "hi"], dtype=object)[
            np.digitize(A[:, 0], [-0.5, 0.5])]
        lv = np.array(["p", "q", "r", "s"], dtype=object)[
            rng.integers(0, 4, n)]
        lv[rng.random(n) < 0.03] = None
        cols["c2"] = lv
    return cols


def _rt(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# the nine losses; a block layout with a 3-level categorical block at
# columns 0-2 and a 4-level ordinal block at 3-6, numeric columns after
LOSSES = ["quadratic", "absolute", "huber", "poisson", "hinge", "logistic",
          "periodic", "categorical", "ordinal"]


@pytest.mark.parametrize("loss", LOSSES)
def test_each_loss_and_gradient_matches_reference(loss):
    rng = np.random.default_rng(7)
    n, K = 40, 9
    U = (2 * rng.normal(size=(n, K))).astype(np.float32)
    lid = np.full(K, jdec._LOSS_IDS[loss], np.int32)
    start = np.arange(K, dtype=np.int32)
    last = np.zeros(K, bool)
    if loss in ("categorical", "ordinal"):
        T = np.zeros((n, K), np.float32)
        for lo, w in ((0, 3), (3, 4), (7, 2)):
            T[np.arange(n), lo + rng.integers(0, w, n)] = 1.0
            start[lo:lo + w] = lo
            last[lo + w - 1] = True
    elif loss in ("hinge", "logistic"):
        T = (rng.random((n, K)) < 0.4).astype(np.float32)
    elif loss == "poisson":
        T = rng.poisson(2.0, (n, K)).astype(np.float32)
    else:
        T = rng.normal(size=(n, K)).astype(np.float32)
    M = (rng.random((n, K)) > 0.1).astype(np.float32)
    jl, jg = jdec._glrm_loss_and_grad(jnp.asarray(U), jnp.asarray(T),
                                      jnp.asarray(M), jnp.asarray(lid),
                                      jnp.float32(3.0), jnp.asarray(start),
                                      jnp.asarray(last))
    pl, pg = pdec._glrm_loss_and_grad(
        torch.tensor(U), torch.tensor(T), torch.tensor(M), torch.tensor(lid),
        3.0, torch.tensor(start).long(), torch.tensor(last))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    _rt(pg.numpy(), jg, 1e-6)


@pytest.mark.parametrize("kind", ["None", "Quadratic", "L2", "L1",
                                  "NonNegative", "OneSparse", "UnitOneSparse",
                                  "Simplex"])
def test_each_prox_and_regularizer_matches_reference(kind):
    rng = np.random.default_rng(8)
    Z = rng.normal(size=(30, 5)).astype(np.float32)
    want = jdec._prox(jnp.asarray(Z), kind, 0.3)
    got = pdec._prox(torch.tensor(Z), kind, 0.3)
    _rt(got.numpy(), want, 1e-6)
    rv = jdec._reg_value(jnp.asarray(Z), kind, 0.7)
    pv = pdec._reg_value(torch.tensor(Z), kind, 0.7)
    np.testing.assert_allclose(float(pv), float(rv), rtol=1e-6)


@pytest.mark.parametrize("params", [
    dict(k=3, gamma_x=0.1, gamma_y=0.1, regularization_x="Quadratic",
         regularization_y="Quadratic"),
    dict(k=2, transform="STANDARDIZE", max_iterations=20),
    dict(k=3, init="Random", regularization_x="NonNegative", gamma_y=0.5,
         seed=3)])
def test_exact_path_matches_reference(params, monkeypatch):
    cols = glrm_cols()
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    if params.get("init") == "Random":
        # the reference's random Y (jax.random from its seed), injected
        Y0 = 0.1 * np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                                (3, 6), jnp.float32))
        monkeypatch.setattr(pdec, "_init_archetypes",
                            lambda Xc, k, init, gen: torch.tensor(Y0))
    jm = jdec.GLRM(**params).train(training_frame=jf)
    pm = pdec.GLRM(**params).train(training_frame=pf)
    assert pm.output["iterations"] == jm.output["iterations"]
    np.testing.assert_allclose(pm.output["objective"], jm.output["objective"],
                               rtol=1e-4)
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == jp.names
    for c in pp.names:
        _rt(pp.vec(c).to_numpy(), jp.vec(c).to_numpy()[:N], 1e-4)


@pytest.mark.parametrize("params", [
    dict(k=3, loss="Huber", max_iterations=15),
    dict(k=3, loss="Absolute", regularization_x="L1", gamma_x=0.05,
         max_iterations=15),
    dict(k=2, multi_loss="Categorical", regularization_y="L2", gamma_y=0.1,
         max_iterations=15),
    dict(k=2, multi_loss="Ordinal", loss_by_col=["Poisson"],
         loss_by_col_idx=[1], max_iterations=15)])
def test_proximal_fit_objective_matches_reference(params):
    cats = "multi_loss" in params
    cols = glrm_cols(cats=cats)
    if "loss_by_col" in params:
        cols["x1"] = np.abs(np.nan_to_num(cols["x1"])).round().astype(
            np.float32)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = jdec.GLRM(**params).train(training_frame=jf)
    pm = pdec.GLRM(**params).train(training_frame=pf)
    assert pm.data_info.coef_names == jm.data_info.coef_names
    np.testing.assert_allclose(pm.output["objective"], jm.output["objective"],
                               rtol=1e-3)


def test_row_blocks_do_not_change_the_fit(monkeypatch):
    """The proximal passes and the batched solves in row blocks of 10 rows
    give the whole-frame fit's objective."""
    pf = Frame.from_arrays(glrm_cols(cats=True))
    params = dict(k=2, max_iterations=5)
    whole = pdec.GLRM(**params).train(training_frame=pf).output["objective"]
    monkeypatch.setattr(pdec, "BLOCK_ELEMS", 10 * 16)
    blocked = pdec.GLRM(**params).train(training_frame=pf)
    np.testing.assert_allclose(blocked.output["objective"], whole, rtol=1e-5)
    exact = dict(k=2, max_iterations=3)
    pn = Frame.from_arrays(glrm_cols())
    a = pdec.GLRM(**exact).train(training_frame=pn).output["objective"]
    monkeypatch.setattr(pdec, "BLOCK_ELEMS", 1 << 26)
    b = pdec.GLRM(**exact).train(training_frame=pn).output["objective"]
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_reference_model_reconstructs_alike_through_convert():
    cols = glrm_cols(seed=1)
    jf, pf = JFrame.from_arrays(cols), Frame.from_arrays(cols)
    jm = jdec.GLRM(k=3, gamma_x=0.05).train(training_frame=jf)
    pm = convert.glrm_model(
        {k: np.asarray(v) if k in ("archetypes", "x_factor") else v
         for k, v in jm.output.items()},
        dataclasses.asdict(jm.data_info), dict(jm.params), device="cpu")
    jp, pp = jm.predict(jf), pm.predict(pf)
    for c in pp.names:
        _rt(pp.vec(c).to_numpy(), jp.vec(c).to_numpy()[:N], 1e-5)
    ja, pa = jm.transform_frame(jf), pm.transform_frame(pf)
    assert pa.names == ["Arch1", "Arch2", "Arch3"]
    for c in pa.names:
        _rt(pa.vec(c).to_numpy(), ja.vec(c).to_numpy()[:N], 1e-5)


@pytest.mark.parametrize("params,err", [
    (dict(k=0), ValueError), (dict(k=9), ValueError),
    (dict(k=1, loss="Categorical"), ValueError),
    (dict(k=1, loss="Cauchy"), ValueError),
    (dict(k=1, regularization_x="Elastic", loss="Huber"), ValueError),
    (dict(k=1, loss_by_col=["Huber", "Huber"], loss_by_col_idx=[0]),
     ValueError)])
def test_refusals(params, err):
    pf = Frame.from_arrays(glrm_cols(n=64))
    with pytest.raises(err):
        pdec.GLRM(**params).train(training_frame=pf)
