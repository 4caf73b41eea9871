"""The port's design matrix (h2o3_tpu_torch/models/data_info.py) against
the JAX reference ``h2o3_tpu.models.data_info``: the layout, the rollups
it reads (mean and sigma over finite values), the expansion with and
without ``use_all_factor_levels`` and standardisation, a test frame with
an unseen and a missing level, mean and plug-value imputation, and the
interaction columns.

The one-hot blocks involve no arithmetic and compare exactly, as do the
unstandardised numeric columns (imputation copies a value). The means and
sigmas are float32 sums in another order than the reference's 8-device
partials, so they and the standardised columns are held at rtol 1e-6,
with an atol of 1e-6 on the standardised columns, where a value near the
mean is the difference of two nearly equal numbers.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import data_info as jdi
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import data_info as pdi
from h2o3_tpu_torch.models.glm import GLM
from jax_reference import _jax_compile_cache  # noqa: F401

ROWS = 2500
X = ["c1", "x0", "c2", "x1", "x2", "x3", "x4"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def frame_cols(rows=ROWS, seed=0, levels2=("p", "q", "r", "s", "t")):
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": (rng.normal(size=rows) * (i + 1) + 3 * i).astype(
        np.float32) for i in range(5)}
    cols["x1"][rng.random(rows) < 0.1] = np.nan
    cols["x3"][:] = np.float32(2.5)              # sigma 0: mul stays 1
    c1 = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, rows)]
    c1[rng.random(rows) < 0.05] = None
    cols["c1"] = c1
    cols["c2"] = np.array(levels2)[rng.integers(0, len(levels2), rows)]
    cols["y"] = rng.normal(size=rows).astype(np.float32)
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = frame_cols()
    return cols, JFrame.from_arrays(cols), Frame.from_arrays(cols)


def test_vec_rollups_match(frames):
    cols, jf, pf = frames
    for c in ("x0", "x1", "x3", "x4"):
        np.testing.assert_allclose([pf.vec(c).mean(), pf.vec(c).sigma()],
                                   [jf.vec(c).mean(), jf.vec(c).sigma()],
                                   rtol=1e-6, atol=1e-7)
    nan = {"z": np.full(7, np.nan, np.float32)}
    assert np.isnan(Frame.from_arrays(nan).vec("z").mean())
    assert Frame.from_arrays(nan).vec("z").sigma() == 0.0


def _layout_equal(p, j):
    assert p.cat_cols == j.cat_cols and p.num_cols == j.num_cols
    assert p.cat_domains == [tuple(d) for d in j.cat_domains]
    np.testing.assert_array_equal(p.cat_offsets, j.cat_offsets)
    assert p.ncats_expanded == j.ncats_expanded
    assert p.ncols_expanded == j.ncols_expanded
    assert p.coef_names == j.coef_names
    for f in ("num_means", "num_mul", "num_sub"):
        np.testing.assert_allclose(getattr(p, f), getattr(j, f), rtol=1e-6,
                                   err_msg=f)


def _expansions_equal(P, J, di):
    P, J = P.numpy(), np.asarray(J)[:P.shape[0]]
    k = di.ncats_expanded
    np.testing.assert_array_equal(P[:, :k], J[:, :k])
    if di.standardize:
        np.testing.assert_allclose(P[:, k:], J[:, k:], rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(P[:, k:], J[:, k:])


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("use_all", [True, False])
def test_make_and_expand(frames, standardize, use_all):
    _, jf, pf = frames
    j = jdi.DataInfo.make(jf, X, standardize=standardize,
                          use_all_factor_levels=use_all)
    p = pdi.DataInfo.make(pf, X, standardize=standardize,
                          use_all_factor_levels=use_all)
    _layout_equal(p, j)
    P = p.expand(pf)
    assert P.shape == (ROWS, p.ncols_expanded) and P.dtype == torch.float32
    _expansions_equal(P, j.expand(jf), p)
    # a missing categorical gives an all-zero block; NaN is imputed
    na = np.asarray([v is None for v in frames[0]["c1"]])
    assert P[torch.from_numpy(na), :j.cat_offsets[1]].abs().sum() == 0
    assert torch.isfinite(P).all()


@pytest.mark.parametrize("use_all", [True, False])
def test_test_frame_adapted_by_level_name(frames, use_all):
    """A scoring frame whose c2 lacks level "p" (so its codes shift) and
    holds an unseen level "zz"; c1 is all missing in its first rows."""
    _, jf, pf = frames
    j = jdi.DataInfo.make(jf, X, use_all_factor_levels=use_all)
    p = pdi.DataInfo.make(pf, X, use_all_factor_levels=use_all)
    test = frame_cols(600, seed=5, levels2=("q", "r", "s", "zz"))
    test["c1"][:50] = None
    jt, pt = JFrame.from_arrays(test), Frame.from_arrays(test)
    assert pt.vec("c2").domain != p.cat_domains[1]
    _expansions_equal(p.expand(pt), j.expand(jt), p)
    P = p.expand(pt)
    unseen = torch.from_numpy(test["c2"] == "zz")
    lo, hi = p.cat_offsets[1], p.ncats_expanded
    assert P[unseen, lo:hi].abs().sum() == 0


def test_categorical_at_scoring_must_stay_categorical(frames):
    _, _, pf = frames
    p = pdi.DataInfo.make(pf, X)
    bad = frame_cols(50)
    bad["c1"] = np.arange(50, dtype=np.float32)
    with pytest.raises(TypeError, match="categorical"):
        p.expand(Frame.from_arrays(bad))


def test_plug_values_replace_means(frames):
    cols, jf, pf = frames
    params = dict(missing_values_handling="PlugValues",
                  plug_values={"x1": -4.0, "x4": 1.5})
    j = JGLM(**params)._make_data_info(jf, X)
    p = GLM(**params)._make_data_info(pf, X)
    _layout_equal(p, j)
    assert p.num_means[p.num_cols.index("x1")] == np.float32(-4.0)
    _expansions_equal(p.expand(pf), j.expand(jf), p)
    for bad, match in [({"c1": 1.0}, "categorical"), ({"nope": 1.0},
                                                       "unknown"),
                       ({"x1": "a"}, "finite")]:
        with pytest.raises(ValueError, match=match):
            GLM(missing_values_handling="PlugValues",
                plug_values=bad)._make_data_info(pf, X)
    with pytest.raises(ValueError, match="PlugValues"):
        GLM(plug_values={"x1": 1.0})._make_data_info(pf, X)


@pytest.mark.parametrize("inter", [["c1", "c2"], ["c1", "x0"], ["x0", "x2"],
                                   ["c1", "c2", "x2"]])
def test_expand_interactions(frames, inter):
    """Level crosses (frequency-ranked domain), per-level products and
    numeric products; a scoring frame missing a level keeps every column
    of the training layout."""
    cols, jf, pf = frames
    doms = {c: pf.vec(c).domain for c in inter if pf.vec(c).is_categorical}
    je = jdi.expand_interactions(jf, inter, doms)
    pe = pdi.expand_interactions(pf, inter, doms)
    assert pe.names == je.names
    for name in pe.names[len(pf.names):]:
        a, b = pe.vec(name), je.vec(name)
        assert a.is_categorical == b.is_categorical
        if a.is_categorical:
            assert a.domain == tuple(b.domain)
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
        else:
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    test = frame_cols(400, seed=6)
    test["c1"] = np.where(test["c1"] == "b", None, test["c1"])
    jt = jdi.expand_interactions(JFrame.from_arrays(test), inter, doms)
    pt = pdi.expand_interactions(Frame.from_arrays(test), inter, doms)
    assert pt.names == jt.names


def test_cross_factor_pools_the_rest_into_other():
    rng = np.random.default_rng(7)
    cols = {"a": np.array([f"a{i:02d}" for i in range(12)])[
        rng.integers(0, 12, 3000)],
        "b": np.array([f"b{i:02d}" for i in range(11)])[
            rng.integers(0, 11, 3000)],
        "y": rng.normal(size=3000).astype(np.float32)}
    je = jdi.expand_interactions(JFrame.from_arrays(cols), ["a", "b"])
    pe = pdi.expand_interactions(Frame.from_arrays(cols), ["a", "b"])
    a, b = pe.vec("a_b"), je.vec("a_b")
    assert len(a.domain) == 101 and a.domain[-1] == "other"
    assert a.domain == tuple(b.domain)
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
