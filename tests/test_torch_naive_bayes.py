"""NaiveBayes in the port (h2o3_tpu_torch/models/naive_bayes.py) against the
JAX reference (``h2o3_tpu/models/naive_bayes.py``) on the same
numpy-seeded frames, with missing values in every column and, at scoring,
a level the training frame never saw.

Tolerances: the count tables, class counts, log prior, log conditionals,
means and deviations at rtol 1e-6 (the port sums in float64, the reference
in float32 products of at most a few hundred rows); class probabilities at
rtol 1e-6 with an absolute floor of 1e-6 per term of a row's
log-likelihood (the prior and one per feature, 5 here): they are the
softmax of sums of float32 logs near 10 in magnitude, whose ulp is 1e-6,
and XLA's CPU log and exp differ from torch's by an ulp.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import naive_bayes as jnb
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import naive_bayes as pnb
from jax_reference import _jax_compile_cache  # noqa: F401

RTOL = 1e-6
N = 384


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def nb_cols(n=N, seed=0, levels=("a", "b", "c", "d")):
    """Two categorical and two numeric features that depend on a 3-class
    y, each with a few missing values; one level of ``c1`` is rare."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    c1 = np.where(rng.random(n) < 0.6, y, rng.integers(0, len(levels), n))
    c1[rng.random(n) < 0.01] = len(levels) - 1
    c1 = np.array(levels, dtype=object)[np.minimum(c1, len(levels) - 1)]
    c2 = np.array(["u", "v"], dtype=object)[(rng.random(n) < 0.3 + 0.2 * y)
                                            .astype(int)]
    for c in (c1, c2):
        c[rng.random(n) < 0.04] = None
    x1 = (y + rng.normal(size=n)).astype(np.float32)
    x2 = (2.0 * rng.normal(size=n) * (1 + y)).astype(np.float32)
    x1[rng.random(n) < 0.05] = np.nan
    x2[rng.random(n) < 0.05] = np.nan
    yy = np.array(["k0", "k1", "k2"], dtype=object)[y]
    yy[rng.random(n) < 0.02] = None
    return dict(c1=c1, c2=c2, x1=x1, x2=x2, y=yy)


@pytest.fixture(scope="module")
def frames():
    cols = nb_cols()
    return JFrame.from_arrays(cols), Frame.from_arrays(cols)


def _probs_close(pm, jm, pf, jf):
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == jp.names
    np.testing.assert_array_equal(pp.vec("predict").to_numpy(),
                                  jp.vec("predict").to_numpy()[:pf.nrows])
    for c in pp.names[1:]:
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   jp.vec(c).to_numpy()[:pf.nrows],
                                   rtol=RTOL, atol=1e-6 * (1 + len(
                                       pm.output["cat_cols"]
                                       + pm.output["num_cols"])))


@pytest.mark.parametrize("params", [
    dict(), dict(laplace=1.0), dict(laplace=0.5, eps_prob=0.05, min_prob=0.01,
                                    eps_sdev=1.5, min_sdev=0.7)])
def test_tables_and_probabilities_match_reference(frames, params):
    jf, pf = frames
    jm = jnb.NaiveBayes(**params).train(y="y", training_frame=jf)
    pm = pnb.NaiveBayes(**params).train(y="y", training_frame=pf)
    jo, po = jm.output, pm.output
    assert po["cat_cols"] == jo["cat_cols"] and po["cards"] == jo["cards"]
    np.testing.assert_allclose(po["class_counts"], jo["class_counts"],
                               rtol=RTOL)
    for k in ("log_prior", "mu", "sd"):
        np.testing.assert_allclose(po[k].numpy(), np.asarray(jo[k]),
                                   rtol=RTOL)
    for a, b in zip(po["cat_logp"], jo["cat_logp"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    _probs_close(pm, jm, pf, jf)
    np.testing.assert_allclose(pm.training_metrics.logloss,
                               jm.training_metrics.logloss, rtol=1e-5)


def test_sufficient_statistics_match_reference(frames):
    jf, pf = frames
    cats, nums = pnb._stack_features(pf, ["c1", "c2"], ["x1", "x2"],
                                     [pf.vec("c1").domain,
                                      pf.vec("c2").domain])
    jc, jn = jnb._stack_features(jf, ["c1", "c2"], ["x1", "x2"],
                                 [jf.vec("c1").domain, jf.vec("c2").domain])
    y = pf.vec("y").data.float()
    w = (y >= 0).float()
    y = torch.where(w > 0, y, 0.0)
    got = pnb._nb_train(y, w, cats, nums, 3, (4, 2))
    jy = np.asarray(jf.vec("y").data, np.float32)
    jw = (jy >= 0).astype(np.float32) * np.asarray(jf.row_mask())
    want = jnb._nb_train(np.where(jw > 0, jy, 0.0), jw, jc, jn, 3, (4, 2))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


def test_unseen_level_and_missing_values_score_alike(frames):
    """A scoring frame with a level ``c1`` never had at training (and a
    domain in another order) scores it as missing, as the reference."""
    jf, pf = frames
    jm = jnb.NaiveBayes(laplace=1.0).train(y="y", training_frame=jf)
    pm = pnb.NaiveBayes(laplace=1.0).train(y="y", training_frame=pf)
    cols = nb_cols(n=64, seed=5, levels=("a", "b", "c", "zz"))
    _probs_close(pm, jm, Frame.from_arrays(cols), JFrame.from_arrays(cols))


def test_reference_model_scores_alike_through_convert(frames):
    jf, pf = frames
    jm = jnb.NaiveBayes(laplace=0.5).train(y="y", training_frame=jf)
    out = {k: (np.asarray(v) if k in ("log_prior", "mu", "sd")
               else [np.asarray(t) for t in v] if k == "cat_logp" else v)
           for k, v in jm.output.items()}
    pm = convert.naive_bayes_model(out, jm.response_column,
                                   jm.response_domain, dict(jm.params),
                                   device="cpu")
    _probs_close(pm, jm, pf, jf)


def test_refusals(frames):
    _, pf = frames
    with pytest.raises(ValueError, match="categorical response"):
        pnb.NaiveBayes().train(y="x1", training_frame=pf)
    m = pnb.NaiveBayes().train(y="y", training_frame=pf)
    with pytest.raises(ValueError, match="checkpoint"):
        pnb.NaiveBayes(checkpoint=m).train(y="y", training_frame=pf)
    with pytest.raises(ValueError, match="unknown parameters"):
        pnb.NaiveBayes(compute_metrics=False)
