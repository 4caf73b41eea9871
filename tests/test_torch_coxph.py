"""CoxPH in the port (h2o3_tpu_torch/models/coxph.py) against the JAX
reference (``h2o3_tpu/models/coxph.py``) on the same numpy-seeded frames:
integer times with heavy ties, about 30% censored, a categorical and
three numeric covariates, with and without weights (row counts are
multiples of 64: the reference's pad rows, ROADMAP queue C).

Tolerances: the partial log-likelihood, its gradient and Hessian against
``jax.grad``/``jax.hessian`` at rtol 1e-5 (the reference differentiates
in float32, the port writes the derivatives out in float64; Hessian
entries with an absolute floor of 1e-5 x its largest); the tie ranks and
the concordance's pair counts exactly; the fitted coefficients at rtol
1e-4 (both stop when the float32 log-likelihood stops moving, which
leaves a few float32 ulps of the optimum), their standard errors and the
baseline hazard at rtol 1e-4, the linear predictor at 1e-4 of its scale.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import coxph as jcox
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import coxph as pcox
from jax_reference import _jax_compile_cache  # noqa: F401

N = 640


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def cox_cols(n=N, seed=0):
    """Hazard exp(0.7 x1 - 0.5 x2 + 0.3 [g = c]); times rounded up to
    integers 1..40 (ties), ~30% censored; a few missing covariates."""
    rng = np.random.default_rng(seed)
    x1, x2, x3 = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    g = rng.choice(np.array(["a", "b", "c"]), n)
    haz = np.exp(0.7 * x1 - 0.5 * x2 + 0.3 * (g == "c"))
    t = np.minimum(np.ceil(rng.exponential(1.0 / haz) * 8.0), 40.0)
    event = (rng.random(n) > 0.3).astype(np.float32)
    x3[rng.random(n) < 0.03] = np.nan
    return dict(x1=x1, x2=x2, x3=x3, g=g, t=t.astype(np.float32),
                event=event, w=rng.uniform(0.5, 2.0, n).astype(np.float32))


def loop_tie_ranks(group, event):
    """The reference's loop over tie groups (``coxph.py:_fit``)."""
    tie_rank = np.zeros(len(group), np.float32)
    tie_tot = np.zeros(len(group), np.float32)
    for g in range(group.max() + 1):
        sel = (group == g) & (event > 0)
        d = int(sel.sum())
        if d:
            tie_rank[sel] = np.arange(d, dtype=np.float32)
            tie_tot[sel] = float(d)
    return tie_rank, tie_tot


def sorted_inputs(seed=1, n=N):
    """Rows sorted by time descending as both fits sort them, with the
    reference's tie groups."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    t = rng.integers(1, 30, n).astype(np.float32)
    e = (rng.random(n) < 0.7).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    order = np.argsort(-t, kind="stable")
    X, t, e, w = X[order], t[order], e[order], w[order]
    _, group = np.unique(-t, return_inverse=True)
    return X, t, e, w, group


def test_tie_ranks_match_the_loop_exactly():
    for seed in range(3):
        _, t, e, _, group = sorted_inputs(seed)
        pg, last = pcox._tie_groups(torch.from_numpy(t))
        np.testing.assert_array_equal(pg.numpy(), group)
        np.testing.assert_array_equal(
            last.numpy(), np.append(np.nonzero(np.diff(group))[0],
                                    len(t) - 1))
        got = pcox._tie_ranks(pg, torch.from_numpy(e), len(last))
        for a, b in zip(got, loop_tie_ranks(group, e)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("efron", [True, False])
def test_loglik_gradient_and_hessian_match_jax(efron):
    X, t, e, w, group = sorted_inputs()
    tr, tt = loop_tie_ranks(group, e)
    beta = np.float32([0.3, -0.2, 0.1, 0.05])
    n_groups = int(group.max()) + 1
    jargs = (jnp.asarray(X), jnp.asarray(e), jnp.asarray(w),
             jnp.asarray(group.astype(np.int32)), jnp.asarray(tr),
             jnp.asarray(tt))
    ll = lambda b: jcox._cox_loglik(b, *jargs, n_groups, efron)
    want = [np.asarray(f(jnp.asarray(beta)), np.float64)
            for f in (ll, jax.grad(ll), jax.hessian(ll))]
    pg, last = pcox._tie_groups(torch.from_numpy(t))
    pargs = (torch.from_numpy(X), torch.from_numpy(e), torch.from_numpy(w),
             pg, *pcox._tie_ranks(pg, torch.from_numpy(e), n_groups), last,
             efron)
    b = torch.from_numpy(beta)
    got_ll = float(pcox._cox_loglik(b, *pargs))
    g, H = pcox._cox_derivatives(b, *pargs)
    np.testing.assert_allclose(got_ll, want[0], rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), want[1], rtol=1e-5,
                               atol=1e-5 * np.abs(want[1]).max())
    np.testing.assert_allclose(H.numpy(), want[2], rtol=1e-5,
                               atol=1e-5 * np.abs(want[2]).max())


def test_concordance_counts_match_the_reference_loop():
    """The merge-sort-tree counts give the reference's Fenwick loop's
    concordance bit for bit, with ties in time and in lp."""
    rng = np.random.default_rng(5)
    for n in (2, 3, 17, 300, 1000):
        lp = np.round(rng.normal(size=n), 1)
        t = rng.integers(1, 12, n).astype(np.float64)
        e = (rng.random(n) < 0.6).astype(np.float64)
        fake = types.SimpleNamespace(output=dict(train_lp=lp, train_time=t,
                                                 train_event=e))
        want = jcox.CoxPHModel.concordance(fake)
        got = pcox._concordance(*(torch.from_numpy(a) for a in (lp, t, e)))
        assert got == want or (np.isnan(got) and np.isnan(want))


def fit_pair(ties="efron", weights=False, seed=0):
    cols = cox_cols(seed=seed)
    kw = dict(stop_column="t", ties=ties,
              weights_column="w" if weights else None)
    x = ["x1", "x2", "x3", "g"]
    jm = jcox.CoxPH(**kw).train(x=x, y="event",
                                training_frame=JFrame.from_arrays(cols))
    pm = pcox.CoxPH(**kw).train(x=x, y="event",
                                training_frame=Frame.from_arrays(cols))
    return cols, jm, pm


@pytest.mark.parametrize("ties,weights", [("efron", False),
                                          ("breslow", False),
                                          ("efron", True)])
def test_fit_matches_reference(ties, weights):
    cols, jm, pm = fit_pair(ties, weights)
    jo, po = jm.output, pm.output
    assert po["coef_names"] == jo["coef_names"]
    assert (po["n"], po["n_events"]) == (jo["n"], jo["n_events"])
    np.testing.assert_allclose(po["coef"].numpy(), np.asarray(jo["coef"]),
                               rtol=1e-4)
    np.testing.assert_allclose(po["loglik"], jo["loglik"], rtol=1e-5)
    np.testing.assert_allclose(po["se_coef"], jo["se_coef"], rtol=1e-4)
    np.testing.assert_allclose(po["x_mean"], jo["x_mean"], rtol=1e-5)
    np.testing.assert_array_equal(po["baseline_times"], jo["baseline_times"])
    np.testing.assert_allclose(po["baseline_cumhaz"], jo["baseline_cumhaz"],
                               rtol=1e-4)
    lp_scale = np.abs(jo["train_lp"]).max()
    np.testing.assert_allclose(po["train_lp"], jo["train_lp"], rtol=1e-4,
                               atol=1e-4 * lp_scale)
    np.testing.assert_allclose(pm.concordance(), jm.concordance(), rtol=1e-4)
    fr, jfr = Frame.from_arrays(cols), JFrame.from_arrays(cols)
    np.testing.assert_allclose(pm.concordance(fr), jm.concordance(jfr),
                               rtol=1e-4)
    np.testing.assert_allclose(
        pm.predict(fr).vec("lp").to_numpy(),
        jm.predict(jfr).vec("lp").to_numpy()[:N], rtol=1e-4,
        atol=1e-4 * lp_scale)
    s_p = pm.predict_survival(fr, [3, 10.5])
    s_j = jm.predict_survival(jfr, [3, 10.5])
    assert s_p.names == s_j.names
    for c in s_p.names:
        np.testing.assert_allclose(s_p.vec(c).to_numpy(),
                                   s_j.vec(c).to_numpy()[:N], rtol=1e-4,
                                   atol=1e-6)


def test_reference_model_scores_alike_through_convert():
    cols, jm, _ = fit_pair()
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    pm = convert.coxph_model(out, dataclasses.asdict(jm.data_info), "event",
                             dict(jm.params), device="cpu")
    fr, jfr = Frame.from_arrays(cols), JFrame.from_arrays(cols)
    np.testing.assert_allclose(pm.predict(fr).vec("lp").to_numpy(),
                               jm.predict(jfr).vec("lp").to_numpy()[:N],
                               rtol=1e-5, atol=1e-6)
    assert pm.concordance() == jm.concordance()
    np.testing.assert_allclose(pm.baseline_hazard().vec("cumhaz").to_numpy(),
                               jm.baseline_hazard().vec("cumhaz").to_numpy(),
                               rtol=1e-6)


def test_refusals():
    fr = Frame.from_arrays(cox_cols())
    with pytest.raises(ValueError, match="stop_column"):
        pcox.CoxPH().train(y="event", training_frame=fr)
    with pytest.raises(ValueError, match="efron or breslow"):
        pcox.CoxPH(stop_column="t", ties="exact").train(
            x=["x1"], y="event", training_frame=fr)
    with pytest.raises(ValueError, match="categorical response"):
        pcox.CoxPH(stop_column="t").train(x=["x1"], y="g", training_frame=fr)
