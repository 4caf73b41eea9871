"""Grid search in the port (``h2o3_tpu_torch/orchestration/grid.py``)
against the JAX package's (``h2o3_tpu/orchestration/grid.py``): the
Cartesian and RandomDiscrete walks give the same combos in the same order
(numpy's ``default_rng`` in both), for several seeds and for a space
larger than the budget; model ids are equal (``md5(combo_key)``); a grid
at sample rates 1.0 is held to the reference's models; a failed build
does not use up the budget; parallelism 1 and 2 give the same models bit
for bit; the grid is in the DKV; with ``recovery_dir`` a budget-stopped
RandomDiscrete grid resumes with the reference's model ids and combos,
building only the points not yet built.

Row counts are multiples of 64 (no pad rows in the reference's frames).
Tolerances are tests/test_torch_gbm.py's: probabilities at atol 1e-5,
training AUC within 1e-4 and logloss at rtol 1e-4 (the reference's
histograms are per-device partial sums, so leaves differ in the last
bits).
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.orchestration.grid import GridSearch as JGridSearch
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.tree import HEAP_FIELDS
from h2o3_tpu_torch.orchestration.grid import Grid, GridSearch
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 448
HYPER = {"max_depth": [2, 3], "learn_rate": [0.1, 0.3]}
#: AutoML's GBM grid (h2o3_tpu/orchestration/automl.py:138-153): 108 points
AUTOML_GBM = {"max_depth": [3, 5, 7, 9], "learn_rate": [0.05, 0.1, 0.2],
              "sample_rate": [0.6, 0.8, 1.0],
              "col_sample_rate": [0.4, 0.7, 1.0]}


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    """Each test starts and ends with an empty port DKV (other files'
    models may share this process)."""
    DKV.clear()
    yield
    DKV.clear()


def grid_cols(n=N, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.where(x[:, 0] + x[:, 1] + 0.5 * rng.normal(size=n) > 0, "t", "f")
    return {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "y": y}


def _combos(cls, hyper, criteria):
    return list(cls(GBM if cls is GridSearch else JGBM, hyper,
                    search_criteria=criteria)._combos())


@pytest.mark.parametrize("hyper,criteria", [
    (HYPER, None),
    (AUTOML_GBM, None),
    (AUTOML_GBM, dict(strategy="RandomDiscrete", seed=42, max_models=6)),
    (AUTOML_GBM, dict(strategy="RandomDiscrete", seed=1)),
    (AUTOML_GBM, dict(strategy="RandomDiscrete", seed=7)),
    ({"max_depth": [4, 6, 8], "learn_rate": [0.1, 0.3],
      "reg_lambda": [0.1, 1.0, 10.0], "sample_rate": [0.6, 0.8, 1.0]},
     dict(strategy="RandomDiscrete", seed=43)),
    (HYPER, dict(strategy="RandomDiscrete", seed=3)),
])
def test_walks_equal_the_reference(hyper, criteria):
    got = _combos(GridSearch, hyper, criteria)
    want = _combos(JGridSearch, hyper, criteria)
    assert got == want
    size = int(np.prod([len(v) for v in hyper.values()]))
    assert len(got) == size
    assert len({tuple(sorted(c.items())) for c in got}) == size


def test_unknown_strategy_is_refused_as_the_reference():
    for cls in (GridSearch, JGridSearch):
        with pytest.raises(ValueError, match="unknown search strategy"):
            _combos(cls, HYPER, dict(strategy="Bayesian"))


@pytest.fixture(scope="module")
def grids():
    """The same RandomDiscrete grid (a budget of 3 of 4 points, sampling
    off) in both packages."""
    cols = grid_cols()
    crit = dict(strategy="RandomDiscrete", max_models=3, seed=7)
    kw = dict(grid_id="g1", search_criteria=crit, ntrees=3, seed=5,
              nbins=16)
    jg = JGridSearch(JGBM, HYPER, **kw).train(
        y="y", training_frame=JFrame.from_arrays(cols))
    pf = Frame.from_arrays(cols)
    pg = GridSearch(GBM, HYPER, **kw).train(y="y", training_frame=pf)
    return cols, jg, pg, pf


def test_grid_models_match_the_reference(grids):
    cols, jg, pg, pf = grids
    assert pg.model_ids == jg.model_ids and len(pg.models) == 3
    assert [m.output["hyper_values"] for m in pg.models] == \
        [m.output["hyper_values"] for m in jg.models]
    jf = JFrame.from_arrays(cols)
    for jm, pm in zip(jg.models, pg.models):
        assert abs(pm.training_metrics.auc - jm.training_metrics.auc) < 1e-4
        np.testing.assert_allclose(pm.training_metrics.logloss,
                                   jm.training_metrics.logloss, rtol=1e-4)
        np.testing.assert_allclose(pm._score_raw(pf).numpy(),
                                   np.asarray(jm._score_raw(jf))[: pf.nrows],
                                   atol=1e-5)
    assert [m.key for m in pg.sorted_models("logloss")] == \
        [m.key for m in jg.sorted_models("logloss")]


def test_the_grid_is_in_the_dkv(grids):
    _, _, pg, _ = grids
    DKV.put(pg.grid_id, pg)   # the module fixture's put predates the clear
    assert isinstance(DKV["g1"], Grid) and DKV["g1"] is pg
    assert "3 models, 0 failed" in repr(pg)


def test_a_failed_build_does_not_use_up_the_budget():
    """A combo the builder refuses (max_depth 40) is recorded as a failure
    and the walk goes on to fill the budget, in both packages and at both
    parallelisms."""
    cols = grid_cols()
    hyper = {"max_depth": [40, 2, 3]}
    kw = dict(search_criteria=dict(max_models=2), ntrees=2, seed=1, nbins=16)
    jg = JGridSearch(JGBM, hyper, grid_id="gf", **kw).train(
        y="y", training_frame=JFrame.from_arrays(cols))
    pf = Frame.from_arrays(cols)
    for par in (1, 2):
        pg = GridSearch(GBM, hyper, grid_id="gf", parallelism=par,
                        **kw).train(y="y", training_frame=pf)
        assert pg.model_ids == jg.model_ids and len(pg.models) == 2
        assert [c for c, _ in pg.failures] == [c for c, _ in jg.failures] \
            == [{"max_depth": 40}]


def test_parallelism_two_gives_the_same_models_bit_for_bit():
    pf = Frame.from_arrays(grid_cols())
    grids = [GridSearch(GBM, HYPER, grid_id=f"gp{par}", parallelism=par,
                        ntrees=3, seed=5, sample_rate=0.8,
                        col_sample_rate=0.7).train(y="y", training_frame=pf)
             for par in (1, 2)]
    assert [m.output["hyper_values"] for m in grids[0].models] == \
        [m.output["hyper_values"] for m in grids[1].models]
    for a, b in zip(grids[0].models, grids[1].models):
        for ta, tb in zip(a.output["trees"], b.output["trees"]):
            for f in HEAP_FIELDS:
                assert torch.equal(getattr(ta, f), getattr(tb, f))
        assert a.training_metrics.auc == b.training_metrics.auc


def test_recovery_dir_resumes_a_stopped_grid(tmp_path):
    pf = Frame.from_arrays(grid_cols(64))
    crit = dict(strategy="RandomDiscrete", seed=3)
    rdir = str(tmp_path / "rec")
    first = GridSearch(GBM, HYPER, grid_id="gr", recovery_dir=rdir,
                       search_criteria=dict(crit, max_models=2),
                       ntrees=1).train(y="y", training_frame=pf)
    assert len(first.models) == 2
    DKV.clear()
    resumed = GridSearch(GBM, HYPER, grid_id="gr", recovery_dir=rdir,
                         search_criteria=crit, ntrees=1).train(
                             y="y", training_frame=pf)
    ref = JGridSearch(JGBM, HYPER, grid_id="gr", search_criteria=crit,
                      ntrees=1).train(y="y",
                                      training_frame=JFrame.from_arrays(
                                          grid_cols(64)))
    assert resumed.model_ids == [m.key for m in ref.models]
    assert resumed.model_ids[:2] == first.model_ids
    assert [m.output["hyper_values"] for m in resumed.models] == \
        [m.output["hyper_values"] for m in ref.models]
    for a, b in zip(first.models, resumed.models[:2]):
        for ta, tb in zip(a.output["trees"], b.output["trees"]):
            for f in HEAP_FIELDS:
                assert torch.equal(getattr(ta, f), getattr(tb, f))
