"""PSVM in the port (h2o3_tpu_torch/models/psvm.py) against the JAX
reference (``h2o3_tpu/models/psvm.py``) on the same numpy-seeded frames:
two noisy classes in five numeric features and a categorical one, a few
missing values, rows excluded by zero weight. Row counts are multiples of
64, so that the reference's padded frame has as many rows as the port's
(its rank sqrt(n) and its barrier's 2n read the padded count). Whole fits
are compared on the first 576 rows of weight 1: the port gathers rows at
weight 0 out of the fit, where the reference keeps them in the IPM at a
box of C = 1e-12 (ROADMAP queue C), so the two fit other problems on a
frame with such rows; a fit with rows at weight 0 is held to the port's
fit on the kept rows alone, bit for bit, under one standardisation.

Tolerances: the ICF factor, one IPM step and the decision function at
rtol 1e-4 with an absolute floor of 1e-4 x each output's largest entry
(float32 products of length 25-640 in another order); the decision
function in row blocks against one block at rtol 1e-6. Whole fits are
held by metric over three seeds: the reference's IPM, in float32, is
chaotic from its first step (at x = 0 the dual step size is a minimum over
rows of quotients of 1e8-sized terms that cancel, so one rounding moves
it by 5%), and a fit's alphas are not identifiable at a rank-sqrt(n)
factor; the mean |training AUC difference| over the seeds within 1e-3 at
the defaults and 5e-3 at C 0.5 with class weights and 60 iterations, and
the decisions' signs alike on 99% of rows at the defaults (on the frames
of weight-1 rows the AUCs measured equal and the signs alike on every
row).
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


def kept_cols(seed: int, n: int = 576) -> dict:
    """The first ``n`` rows of weight 1 of :func:`svm_cols` (``n`` a
    multiple of 64: no pad rows in the reference)."""
    cols = svm_cols(seed=seed)
    rows = np.nonzero(cols["w"] > 0)[0][:n]
    return {k: v[rows] for k, v in cols.items()}


def _close(a, b, rtol):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                               atol=rtol * np.abs(b).max())


def design(seed=1, n=N, p=6):
    """The kept rows of a draw with about 5% of its rows out of the fit,
    gathered away first, as the port's fit does."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    keep = rng.random(n) > 0.05
    return X[keep], y[keep]


def _ref_icf(X, y):
    return np.asarray(jpsvm._icf(jnp.asarray(X), jnp.asarray(y), 25, 1 / 6,
                                 jnp.ones(len(y), bool)))


def test_icf_matches_reference():
    X, y = design()
    want = _ref_icf(X, y)
    got = ppsvm._icf(torch.from_numpy(X), torch.from_numpy(y), 25,
                     1 / 6).numpy()
    _close(got, want, 1e-4)


def test_ipm_step_matches_reference():
    X, y = design()
    H = _ref_icf(X, y)
    n = len(y)
    rng = np.random.default_rng(3)
    c = np.ones(n, np.float32)
    x = rng.uniform(0, 1, n).astype(np.float32)
    xi = rng.uniform(0.05, 0.2, n).astype(np.float32)
    la = rng.uniform(0.05, 0.2, n).astype(np.float32)
    args = (H, y, c, x, xi, la)
    want = jpsvm._ipm_step(*(jnp.asarray(a) for a in args), jnp.float32(0.1),
                           jnp.float32(20.0 * n))
    got = ppsvm._ipm_step(*(torch.from_numpy(np.array(a)) for a in args),
                          torch.tensor(0.1), 20.0 * n)
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
            cols = kept_cols(seed)
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
                np.asarray(jm.decision_function(jfr))[:fr.nrows])).mean()
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
           np.asarray(jm.decision_function(jfr))[:fr.nrows], 1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_rows_at_weight_0_are_out_of_the_fit(monkeypatch, case):
    """A fit on a frame whose rows at weight 0 (5%) are kept in it equals
    the fit on a frame of the kept rows alone, bit for bit: the same
    support vectors, coefficients, rho and rank sqrt(kept rows). Both
    standardise by the whole frame's DataInfo (a fit on fewer rows would
    standardise by their own rollups)."""
    x = [f"x{i}" for i in range(5)] + ["c"]
    cols = svm_cols(seed=1)
    keep = cols["w"] > 0
    fr = Frame.from_arrays(cols)
    di = ppsvm.DataInfo.make(fr, x, standardize=True)
    monkeypatch.setattr(ppsvm.DataInfo, "make",
                        staticmethod(lambda *a, **k: di))
    whole = ppsvm.PSVM(weights_column="w", **CASES[case]).train(
        x=x, y="y", training_frame=fr)
    alone = ppsvm.PSVM(**CASES[case]).train(
        x=x, y="y", training_frame=Frame.from_arrays(
            {k: v[keep] for k, v in cols.items()}))
    assert whole.output["rank"] == alone.output["rank"] == \
        int(np.sqrt(keep.sum()))
    for k in ("sv_x", "sv_coef", "sv_norms"):
        assert torch.equal(whole.output[k], alone.output[k]), k
    assert whole.output["rho"] == alone.output["rho"]
    assert torch.equal(whole.decision_function(fr),
                       alone.decision_function(fr))


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
    X, y = design()
    H = _ref_icf(X, y)
    d = np.full(len(y), -10.0, np.float32)
    b = np.ones(len(y), np.float32)
    want = np.asarray(jpsvm._smw_partial(H, d, b))
    got = ppsvm._smw_partial(*(torch.from_numpy(np.array(a))
                               for a in (H, d, b))).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
