"""PSVM in the port (h2o3_tpu_torch/models/psvm.py) against the JAX
reference (``h2o3_tpu/models/psvm.py``) on the same numpy-seeded frames:
two noisy classes in five numeric features and a categorical one, a few
missing values, rows excluded by zero weight. Row counts are multiples of
64, so that the reference's padded frame has as many rows as the port's
(its rank sqrt(n) and its barrier's 2n read the padded count).

Tolerances: the ICF factor, one IPM step and the decision function at
rtol 1e-4 with an absolute floor of 1e-4 x each output's largest entry
(float32 products of length 25-640 in another order); the decision
function in row blocks against one block at rtol 1e-6. Whole fits are
held by metric over three seeds: the reference's IPM, in float32, is
chaotic from its first step (at x = 0 the dual step size is a minimum over
rows of quotients of 1e8-sized terms that cancel, so one rounding moves
it by 5%), and a fit's alphas are not identifiable at a rank-sqrt(n)
factor; the mean |training AUC difference| over the seeds within 1e-3 at
the defaults and 5e-3 at C 0.5 with class weights and 60 iterations (on
one of whose seeds the reference's IPM stalls at a surrogate gap of 180
where the port's reaches 1e-3 at 200), and the decisions' signs alike on
99% of rows at the defaults.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import psvm as jpsvm
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import psvm as ppsvm

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


def svm_cols(n=N, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = rng.normal(size=(n, 5)) + 0.8 * (2 * y[:, None] - 1) * \
        np.array([1.0, -0.5, 0.3, 0.0, 0.0])
    X = X.astype(np.float32)
    X[rng.random((n, 5)) < 0.01] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["c"] = rng.choice(np.array(["p", "q", "r"]), n)
    cols["y"] = np.array(["neg", "pos"])[y]
    cols["w"] = np.where(rng.random(n) < 0.05, 0.0, 1.0).astype(np.float32)
    return cols


def _close(a, b, rtol):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                               atol=rtol * np.abs(b).max())


def design(seed=1, n=N, p=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    keep = rng.random(n) > 0.05
    X[~keep] = 0.0
    return X, y, keep


def test_icf_matches_reference():
    X, y, keep = design()
    want = np.asarray(jpsvm._icf(jnp.asarray(X), jnp.asarray(y), 25, 1 / 6,
                                 jnp.asarray(keep)))
    got = ppsvm._icf(torch.from_numpy(X), torch.from_numpy(y), 25, 1 / 6,
                     torch.from_numpy(keep)).numpy()
    _close(got, want, 1e-4)


def test_ipm_step_matches_reference():
    X, y, keep = design()
    H = np.asarray(jpsvm._icf(jnp.asarray(X), jnp.asarray(y), 25, 1 / 6,
                              jnp.asarray(keep)))
    rng = np.random.default_rng(3)
    c = np.where(keep, 1.0, 1e-12).astype(np.float32)
    x = (rng.uniform(0, 1, N) * c).astype(np.float32)
    xi = rng.uniform(0.05, 0.2, N).astype(np.float32)
    la = rng.uniform(0.05, 0.2, N).astype(np.float32)
    args = (H, y, c, x, xi, la)
    want = jpsvm._ipm_step(*(jnp.asarray(a) for a in args), jnp.float32(0.1),
                           jnp.float32(20.0 * N))
    got = ppsvm._ipm_step(*(torch.from_numpy(np.array(a)) for a in args),
                          torch.tensor(0.1), 20.0 * N)
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-4)


def test_decision_matches_reference_in_row_blocks(monkeypatch):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(N, 6)).astype(np.float32)
    Xsv = rng.normal(size=(37, 6)).astype(np.float32)
    coef = rng.normal(size=37).astype(np.float32)
    norms = (Xsv * Xsv).sum(1)
    want = np.asarray(jpsvm._sv_decision(X, norms, Xsv, coef, 0.2, 0.3))
    args = [torch.from_numpy(a) for a in (X, norms, Xsv, coef)]
    whole = ppsvm._sv_decision(*args, 0.2, 0.3).numpy()
    # blocks of 3 rows: 214 blocks, the last one short
    monkeypatch.setattr(ppsvm, "SCORE_BLOCK_ELEMS", 3 * 37)
    blocked = ppsvm._sv_decision(*args, 0.2, 0.3).numpy()
    _close(whole, want, 1e-4)
    np.testing.assert_allclose(blocked, whole, rtol=1e-6, atol=1e-6)


CASES = {"defaults": dict(),
         "weighted": dict(hyper_param=0.5, positive_weight=2.0, gamma=0.3,
                          max_iterations=60)}


@pytest.fixture(scope="module")
def fits():
    """(columns, reference model, port model) per case and seed."""
    out = {}
    x = [f"x{i}" for i in range(5)] + ["c"]
    for case, kw in CASES.items():
        for seed in range(3):
            cols = svm_cols(seed=seed)
            jm = jpsvm.PSVM(weights_column="w", **kw).train(
                x=x, y="y", training_frame=JFrame.from_arrays(cols))
            pm = ppsvm.PSVM(weights_column="w", **kw).train(
                x=x, y="y", training_frame=Frame.from_arrays(cols))
            out[case, seed] = cols, jm, pm
    return out


@pytest.mark.parametrize("case,auc_tol", [("defaults", 1e-3),
                                          ("weighted", 5e-3)])
def test_fit_matches_reference_by_metric(fits, case, auc_tol):
    diffs = []
    for seed in range(3):
        cols, jm, pm = fits[case, seed]
        assert pm.output["rank"] == jm.output["rank"]
        diffs.append(abs(pm.training_metrics.auc - jm.training_metrics.auc))
        fr, jfr = Frame.from_arrays(cols), JFrame.from_arrays(cols)
        pp, jp = pm.predict(fr), jm.predict(jfr)
        assert pp.names == jp.names
        if case == "defaults":
            agree = (np.sign(pm.decision_function(fr).numpy()) == np.sign(
                np.asarray(jm.decision_function(jfr))[:N])).mean()
            assert agree >= 0.99, (seed, agree)
    assert np.mean(diffs) <= auc_tol, diffs


def test_reference_model_scores_alike_through_convert(fits):
    cols, jm, _ = fits["defaults", 0]
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    pm = convert.psvm_model(out, dataclasses.asdict(jm.data_info), "y",
                            jm.response_domain, dict(jm.params),
                            device="cpu")
    fr, jfr = Frame.from_arrays(cols), JFrame.from_arrays(cols)
    _close(pm.decision_function(fr).numpy(),
           np.asarray(jm.decision_function(jfr))[:N], 1e-4)


def test_refusals():
    fr = Frame.from_arrays(svm_cols())
    with pytest.raises(ValueError, match="categorical response"):
        ppsvm.PSVM().train(x=["x1"], y="x0", training_frame=fr)
    with pytest.raises(ValueError, match="gaussian"):
        ppsvm.PSVM(kernel_type="linear").train(x=["x1"], y="y",
                                               training_frame=fr)
    three = Frame.from_arrays(dict(x=np.arange(6, dtype=np.float32),
                                   y=np.array(list("abcabc"))))
    with pytest.raises(ValueError, match="binomial"):
        ppsvm.PSVM().train(x=["x"], y="y", training_frame=three)


def test_a_failed_smw_factorisation_gives_nan_like_the_reference():
    """An indefinite I + H'DH (the IPM's float32 can round there) gives
    NaN, as the reference's Cholesky does, and the fit's loop then keeps
    its last finite iterate; no exception, no host sync."""
    X, y, keep = design()
    H = np.asarray(jpsvm._icf(jnp.asarray(X), jnp.asarray(y), 25, 1 / 6,
                              jnp.asarray(keep)))
    d = np.full(N, -10.0, np.float32)
    b = np.ones(N, np.float32)
    want = np.asarray(jpsvm._smw_partial(H, d, b))
    got = ppsvm._smw_partial(*(torch.from_numpy(np.array(a))
                               for a in (H, d, b))).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
