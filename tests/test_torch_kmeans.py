"""KMeans in the port (h2o3_tpu_torch/models/kmeans.py) against the JAX
reference (``h2o3_tpu/models/kmeans.py``) on the same numpy-seeded frames.

The random first row of PlusPlus and Furthest (and Random's draw) come
from ``jax.random`` in the reference and a ``torch.Generator`` here, so
the deterministic paths are held with the first row injected into both
(``_weighted_row_choice``): Furthest, ``estimate_k`` and User points give
centers at rtol 1e-5, the same assignments and sizes, the same number of
clusters and iterations, and within-SS and total SS at rtol 1e-5. Random
and PlusPlus are held by their within-SS over three seeds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import kmeans as jkm
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import kmeans as pkm

RTOL = 1e-5
N = 400


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def frames():
    """Four blobs in five numeric columns, a categorical column, a few
    missing values."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4, size=(4, 5))
    X = (centers[rng.integers(0, 4, N)] + rng.normal(size=(N, 5))).astype(
        np.float32)
    X[rng.random((N, 5)) < 0.01] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["c"] = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, N)]
    return cols, JFrame.from_arrays(cols), Frame.from_arrays(cols)


@pytest.fixture
def first_row(monkeypatch):
    """Both packages' first center is row 17."""
    monkeypatch.setattr(jkm, "_weighted_row_choice",
                        lambda key, p, w: jnp.int32(17))
    monkeypatch.setattr(pkm, "_weighted_row_choice",
                        lambda gen, p, w: torch.tensor(17))


def _same_fit(jm, pm, jf, pf):
    np.testing.assert_allclose(pm.centers(), jm.centers(), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(pm.output["centers_std"].numpy(),
                               np.asarray(jm.output["centers_std"]),
                               rtol=RTOL, atol=1e-6)
    assert pm.output["iterations"] == jm.output["iterations"]
    for f in ("tot_withinss", "totss", "betweenss"):
        np.testing.assert_allclose(getattr(pm, f)(), getattr(jm, f)(),
                                   rtol=RTOL)
    np.testing.assert_array_equal(pm.output["size"],
                                  np.asarray(jm.output["size"]))
    jp, pp = jm.predict(jf).vec("predict"), pm.predict(pf).vec("predict")
    assert pp.domain == jp.domain
    np.testing.assert_array_equal(pp.to_numpy(), jp.to_numpy()[:N])


@pytest.mark.parametrize("params", [
    dict(k=4, init="Furthest"), dict(k=3, init="Furthest", standardize=False),
    dict(k=5, init="Furthest", max_iterations=3)])
def test_furthest_with_the_first_row_injected(frames, first_row, params):
    cols, jf, pf = frames
    jm = jkm.KMeans(**params).train(training_frame=jf)
    pm = pkm.KMeans(**params).train(training_frame=pf)
    _same_fit(jm, pm, jf, pf)
    rows = pm.scoring_history[1]
    assert [r[2] for r in rows] == list(range(1, pm.output["iterations"] + 1))


@pytest.mark.parametrize("k", [3, 8])
def test_estimate_k_is_deterministic(frames, k):
    """estimate_k grows from k = 1 by the furthest row: no random draw, so
    the whole fit matches, ``k`` exactly."""
    cols, jf, pf = frames
    jm = jkm.KMeans(k=k, estimate_k=True).train(training_frame=jf)
    pm = pkm.KMeans(k=k, estimate_k=True).train(training_frame=pf)
    assert pm.output["centers_std"].shape == jm.output["centers_std"].shape
    _same_fit(jm, pm, jf, pf)


def test_user_points_are_standardised(frames):
    cols, jf, pf = frames
    rng = np.random.default_rng(1)
    pts = rng.normal(scale=3, size=(3, 8)).astype(np.float32)
    pts[:, :3] = np.eye(3)
    jm = jkm.KMeans(k=3, init="User", user_points=pts).train(
        training_frame=jf)
    pm = pkm.KMeans(k=3, init="User", user_points=pts).train(
        training_frame=pf)
    _same_fit(jm, pm, jf, pf)
    with pytest.raises(ValueError, match="user_points"):
        pkm.KMeans(k=2, init="User", user_points=pts).train(
            training_frame=pf)
    with pytest.raises(ValueError, match="estimate k"):
        pkm.KMeans(k=3, estimate_k=True, user_points=pts).train(
            training_frame=pf)


def test_centers_are_de_standardised(frames, first_row):
    """The raw centers are the weighted means of their rows on the raw
    scale (missing values mean-imputed), one-hot blocks as level shares."""
    cols, _, pf = frames
    pm = pkm.KMeans(k=4).train(training_frame=pf)
    assign = pm.predict(pf).vec("predict").to_numpy()
    X = pm.data_info.expand(pf).numpy().astype(np.float64)
    di = pm.data_info
    s = di.ncats_expanded
    X[:, s:] = X[:, s:] / di.num_mul + di.num_sub
    for c in range(4):
        np.testing.assert_allclose(pm.centers()[c], X[assign == c].mean(0),
                                   rtol=1e-4, atol=1e-5)
    assert pm.output["size"].sum() == N


@pytest.mark.parametrize("init", ["Random", "PlusPlus"])
def test_random_inits_by_within_ss(frames, init):
    cols, jf, pf = frames
    ref, got = [], []
    for seed in (1, 2, 3):
        ref.append(jkm.KMeans(k=4, init=init, seed=seed).train(
            training_frame=jf).tot_withinss())
        got.append(pkm.KMeans(k=4, init=init, seed=seed).train(
            training_frame=pf).tot_withinss())
    # four well-separated blobs: every seed finds them, or nearly
    assert abs(np.mean(got) - np.mean(ref)) <= 3 * max(np.std(ref),
                                                       np.std(got)) \
        + 0.02 * np.mean(ref), (ref, got)


def test_reference_model_assigns_alike_through_convert(frames, first_row):
    cols, jf, pf = frames
    jm = jkm.KMeans(k=4).train(training_frame=jf)
    pm = convert.kmeans_model(
        {k: np.asarray(v) if k == "centers_std" else v
         for k, v in jm.output.items()},
        dataclasses.asdict(jm.data_info), dict(jm.params), device="cpu")
    np.testing.assert_array_equal(pm.predict(pf).vec("predict").to_numpy(),
                                  jm.predict(jf).vec("predict").to_numpy()[:N])
    np.testing.assert_allclose(pm.centers(), jm.centers())


def test_zero_weight_rows_are_never_centers(frames):
    """Furthest skips rows of weight 0 however far they lie."""
    cols = dict(frames[0])
    cols["x0"] = cols["x0"].copy()
    cols["x0"][5] = 1e4
    cols["w"] = np.ones(N, np.float32)
    cols["w"][5] = 0.0
    pf = Frame.from_arrays(cols)
    pm = pkm.KMeans(k=4, weights_column="w", standardize=False,
                    seed=3).train(training_frame=pf)
    assert np.abs(pm.centers()[:, 3]).max() < 100
    with pytest.raises(ValueError, match="checkpoint"):
        pkm.KMeans(k=2, checkpoint=pm).train(training_frame=pf)
