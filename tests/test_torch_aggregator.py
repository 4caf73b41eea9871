"""Aggregator in the port (``h2o3_tpu_torch/models/aggregator.py``) against
the JAX package's (``h2o3_tpu/models/aggregator.py``) on the same
numpy-seeded frames (row counts multiples of 64: no reference pad rows).

The first exemplar is a random draw in both packages, from streams that
differ: the reference's row is handed to the port
(``aggregator._first_exemplar``). From there the sweep is deterministic:
the exemplar rows, each row's assigned exemplar and the counts must equal
the reference's exactly. The port sums distances in float64, the
reference in float32: they pick alike wherever the reference's float32
sums order the rows as exact sums do, which these frames show (a
float32 near-tie would show here as a difference). The port's chunked
sweep equals a sweep fetching every exemplar, and its row-blocked
assignment equals one block, exactly.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.aggregator import Aggregator as JAggregator
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import aggregator
from h2o3_tpu_torch.models.aggregator import Aggregator
from h2o3_tpu_torch.models.data_info import DataInfo
from jax_reference import _jax_compile_cache  # noqa: F401

N = 1536


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def agg_cols(n=N, seed=2, distinct=None):
    """Three clustered numeric columns and a categorical; with
    ``distinct``, only that many distinct rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(6, 3))
    lab = rng.integers(0, 6, n)
    X = (centers[lab] + rng.normal(size=(n, 3))).astype(np.float32)
    g = np.array(["u", "v", "w"])[lab % 3]
    if distinct is not None:
        X, g = X[lab % distinct], g[lab % distinct]
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "g": g,
            "w": (rng.random(n) > 0.1).astype(np.float32)}


def fit_both(cols, monkeypatch, **params):
    jm = JAggregator(**params).train(training_frame=JFrame.from_arrays(cols))
    first = int(jm.output["exemplar_rows"][0])
    monkeypatch.setattr(aggregator, "_first_exemplar",
                        lambda mask, seed: first)
    pm = Aggregator(**params).train(training_frame=Frame.from_arrays(cols))
    return jm, pm


@pytest.mark.parametrize("params", [
    dict(target_num_exemplars=40),
    dict(target_num_exemplars=25, transform="NONE"),
    dict(target_num_exemplars=30, weights_column="w"),
])
def test_exemplars_counts_and_assignment_equal_the_reference(monkeypatch,
                                                            params):
    cols = agg_cols()
    jm, pm = fit_both(cols, monkeypatch, **params)
    np.testing.assert_array_equal(pm.output["exemplar_rows"],
                                  jm.output["exemplar_rows"])
    np.testing.assert_array_equal(
        pm.output["exemplar_assignment"].numpy(),
        np.asarray(jm.output["exemplar_assignment"])[:N])
    jout, pout = jm.aggregated_frame, pm.aggregated_frame
    assert pout.names == jout.names
    np.testing.assert_array_equal(pout.vec("counts").to_numpy(),
                                  jout.vec("counts").to_numpy()[:pout.nrows])
    for c in ("a", "b", "c", "g"):
        np.testing.assert_array_equal(pout.vec(c).to_numpy(),
                                      jout.vec(c).to_numpy()[:pout.nrows])
    included = (cols["w"] > 0).sum() if "weights_column" in params else N
    assert pout.vec("counts").to_numpy().sum() == included


def test_the_sweep_stops_where_every_row_is_an_exemplar(monkeypatch):
    cols = agg_cols(distinct=5)
    jm, pm = fit_both(cols, monkeypatch, target_num_exemplars=50,
                      ignored_columns=["w"])
    assert len(pm.output["exemplar_rows"]) == 5
    np.testing.assert_array_equal(pm.output["exemplar_rows"],
                                  jm.output["exemplar_rows"])


def _design(cols):
    fr = Frame.from_arrays(cols)
    x = ["a", "b", "c", "g"]
    return DataInfo.make(fr, x, use_all_factor_levels=True).expand(fr)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_the_chunked_sweep_equals_a_fetch_an_exemplar(chunk):
    X = _design(agg_cols())
    mask = torch.ones(N, dtype=torch.bool)
    want, fetches = aggregator.farthest_point_sweep(X, mask, 3, 60, chunk=1)
    got, n = aggregator.farthest_point_sweep(X, mask, 3, 60, chunk=chunk)
    np.testing.assert_array_equal(got, want)
    assert fetches == 59 and n == -(-59 // chunk)


@pytest.mark.parametrize("block_elems", [1, 40 * 7, 40 * 100])
def test_the_blocked_assignment_equals_one_block(block_elems):
    X = _design(agg_cols())
    E = X[torch.arange(0, N, N // 40)]
    whole = aggregator.nearest_exemplar(X, E, block_elems=N * E.shape[0])
    assert torch.equal(aggregator.nearest_exemplar(X, E, block_elems), whole)


def test_the_first_exemplar_is_an_included_row():
    mask = torch.zeros(200, dtype=torch.bool)
    mask[[17, 90, 150]] = True
    picks = {aggregator._first_exemplar(mask, s) for s in range(12)}
    assert picks <= {17, 90, 150} and len(picks) > 1


def test_unapplied_rel_tol_is_refused():
    fr = Frame.from_arrays(agg_cols(n=128))
    with pytest.raises(ValueError, match="rel_tol_num_exemplars"):
        Aggregator(rel_tol_num_exemplars=0.1).train(training_frame=fr)
