"""The mungers of the port (``h2o3_tpu_torch/rapids/munge.py`` and the
Frame methods on them) against the JAX package's (``h2o3_tpu/rapids/
munge.py``, ``frame/frame.py:163-405``): one 240-row frame with missing
keys and values, a group whose values are all missing, duplicate merge
keys on both sides, right-frame levels the left lacks, TIME and string
columns.

Exact: sort orders, group ids, group keys and counts, min, max, first,
last and median, every gathered cell (sort, merge, rbind, unique, filter)
and the merge's rows and their order. Within rtol 1e-5: sums and means,
which the port adds in float64 and the JAX package in float32; variance
and sd within rtol 1e-4 on unit-scale values. Where the JAX package's
float32 ``(ss - s²/n)/(n - 1)`` cancels (a large mean, a small spread) the
port, which sums squares about the mean, is held to numpy's float64
variance instead (ROADMAP queue C)."""

import numpy as np
import pytest
import torch

from rapids_pair import _cpu_port, pair, same_frame  # noqa: F401
from h2o3_tpu.rapids import munge as jm
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.rapids import munge

N = 240
rng = np.random.default_rng(11)
G = rng.choice(["a", "b", "c", "d"], size=N).astype(object)
G[rng.choice(N, 9, replace=False)] = None
H = rng.choice(["x", "y", "z"], size=N).astype(object)
K = rng.integers(0, 5, N).astype(np.float32)
K[rng.choice(N, 7, replace=False)] = np.nan
X = rng.normal(size=N).astype(np.float32)
X[rng.choice(N, 15, replace=False)] = np.nan
X[G == "d"] = np.nan                      # a group with no value
W = rng.integers(0, 50, N).astype(np.float32)
T = (np.datetime64("2020-01-01", "ms")
     + rng.integers(0, 4, N).astype("timedelta64[D]"))
S = rng.choice(["foo", "bar", None], size=N).astype(object)
COLS = {"g": G, "h": H, "k": K, "x": X, "w": W, "t": T, "s": S}
TYPES = {"t": VecType.TIME, "s": VecType.STR}
FLOAT_AGGS = ("sum", "mean", "var", "sd")


@pytest.fixture(scope="module")
def frames():
    return pair(COLS, types=TYPES)


@pytest.fixture(scope="module")
def right_frames():
    """A right frame for merges: key g with a level the left lacks ("q"),
    duplicates, a missing key, and a column that collides with the left's
    (``w``)."""
    g = np.array(["a", "b", "b", "q", "c", None, "a"], dtype=object)
    return pair({"g": g, "z": np.arange(7, dtype=np.float32) * 1.5,
                 "w": np.float32([9, 8, 7, 6, 5, 4, 3])})


@pytest.mark.parametrize("by,asc", [
    (["x"], True), (["x"], False), (["g", "x"], [True, False]),
    (["g", "k"], True), (["k", "h", "w"], [False, True, False]),
    (["t", "w"], True), (["h"], False)])
def test_sort(frames, by, asc):
    jf, pf = frames
    np.testing.assert_array_equal(
        munge.sort_perm(pf, by, asc).numpy(), jm.sort_perm(jf, by, asc))
    same_frame(jm.sort(jf, by, asc), pf.sort(by, asc), what=str(by))


@pytest.mark.parametrize("by", [["g"], ["g", "h"], ["k"], ["k", "g"], ["t"]])
def test_group_ids(frames, by):
    jf, pf = frames
    jg, jng, jrep = jm.frame_group_ids(jf, by)
    gid, ng, rep = munge.frame_group_ids(pf, by)
    assert ng == jng
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jg)[:N])
    np.testing.assert_array_equal(rep.numpy(), jrep)


@pytest.mark.parametrize("by", [["g"], ["g", "h"], ["k"]])
@pytest.mark.parametrize("op", ["count", "nrow", "sum", "mean", "min", "max",
                                "var", "sd", "median", "first", "last"])
def test_group_by(frames, by, op):
    jf, pf = frames
    aggs = [(op, "x"), (op, "w")]
    rtol = 1e-4 if op in ("var", "sd") else 1e-5 if op in FLOAT_AGGS else 0
    exact = [c for c in by] + ([] if op in FLOAT_AGGS else
                               [f"{op}_x", f"{op}_w", "nrow", "nrow_"])
    same_frame(jm.group_by(jf, by, aggs), munge.group_by(pf, by, aggs),
               rtol=rtol, exact=exact, what=f"{by} {op}")


def test_group_by_dict_chain_and_name_collisions(frames):
    """The mapping form, repeated aggregations (``_`` suffixes) and the
    GroupBy chain with its default columns."""
    jf, pf = frames
    aggs = {"x": ["mean", "mean", "min"], "w": "max"}
    same_frame(jm.group_by(jf, "h", aggs), munge.group_by(pf, "h", aggs),
               rtol=1e-5, exact=["h", "min_x", "max_w"])
    jg = jf.group_by(["g"]).count().sum().median("w").get_frame()
    pg = pf.group_by(["g"]).count().sum().median("w").get_frame()
    same_frame(jg, pg, rtol=1e-5, exact=["g", "nrow", "median_w"])


def test_group_by_refuses_unknown_agg_and_column(frames):
    _, pf = frames
    with pytest.raises(ValueError, match="unknown agg"):
        munge.group_by(pf, "g", [("mode", "x")])
    with pytest.raises(KeyError):
        munge.group_by(pf, "g", [("mean", "nope")])


def test_group_by_on_no_rows(frames):
    jf, pf = frames
    je = jm.filter_rows(jf, jf.vec("w") > 1e6)
    pe = munge.filter_rows(pf, pf.vec("w") > 1e6)
    assert pe.nrows == je.nrows == 0
    out = munge.group_by(pe, "g", {"x": ["mean", "median", "first"]})
    assert out.nrows == 0 and out.names == ["g", "mean_x", "median_x",
                                            "first_x"]


def test_variance_where_float32_cancels():
    """A large mean and a small spread: the JAX package's float32
    ``(ss - s²/n)/(n - 1)`` loses every digit (ROADMAP queue C); the
    port's two float64 passes about the mean give numpy's float64 variance
    of the same float32 values."""
    x = (1e4 + np.random.default_rng(3).normal(size=400) * 0.01
         ).astype(np.float32)
    g = np.where(np.arange(400) < 200, "u", "v").astype(object)
    jf, pf = pair({"g": g, "x": x})
    got = munge.group_by(pf, "g", [("var", "x")]).vec("var_x").to_numpy()
    want = np.array([np.var(x[:200].astype(np.float64), ddof=1),
                     np.var(x[200:].astype(np.float64), ddof=1)])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = jm.group_by(jf, "g", [("var", "x")]).vec("var_x").to_numpy()
    assert np.max(np.abs(ref - want) / want) > 0.1


@pytest.mark.parametrize("all_x,all_y", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_merge(frames, right_frames, all_x, all_y):
    jf, pf = frames
    jr, pr = right_frames
    same_frame(jm.merge(jf, jr, all_x=all_x, all_y=all_y),
               pf.merge(pr, all_x=all_x, all_y=all_y), what="merge")


def test_merge_plan_row_for_row(frames, right_frames):
    """The merge's rows and their order: each left row with its matches in
    right order (the row index columns carry them through)."""
    jf, pf = frames
    jr, pr = right_frames
    ji, pi = pair({"row": np.arange(N, dtype=np.float32)})
    jl, pl = jf[["g"]].cbind(ji), pf[["g"]].cbind(pi)
    for ax in (False, True):
        j = jm.merge(jl, jr, all_x=ax, all_y=True)
        p = munge.merge(pl, pr, all_x=ax, all_y=True)
        np.testing.assert_array_equal(p.vec("row").to_numpy(),
                                      j.vec("row").to_numpy())
        np.testing.assert_array_equal(p.vec("z").to_numpy(),
                                      j.vec("z").to_numpy())


def test_merge_on_two_keys_and_numeric_keys():
    rng2 = np.random.default_rng(5)
    lc = {"a": rng2.integers(0, 3, 60).astype(np.float32),
          "b": rng2.choice(["p", "q"], 60).astype(object),
          "v": rng2.normal(size=60).astype(np.float32)}
    rc = {"a": np.float32([0, 1, 2, 2, np.nan]),
          "b": np.array(["q", "p", "p", "p", "q"], dtype=object),
          "r": np.float32([1, 2, 3, 4, 5])}
    jl, pl = pair(lc)
    jr, pr = pair(rc)
    for ax, ay in ((False, False), (True, True)):
        same_frame(jm.merge(jl, jr, all_x=ax, all_y=ay),
                   munge.merge(pl, pr, all_x=ax, all_y=ay))
    with pytest.raises(TypeError, match="mismatch"):
        munge.merge(pl, Frame.from_arrays(
            {"b": np.float32([1]), "r": np.float32([1])}), by=["b"])
    with pytest.raises(ValueError, match="no common"):
        munge.merge(pl, Frame.from_arrays({"zz": np.float32([1])}))


def test_merge_on_time_key():
    lt = np.array(["2024-01-01", "2024-03-01", "2024-03-01"],
                  dtype="datetime64[ms]")
    rt = np.array(["2024-03-01", "2030-01-01"], dtype="datetime64[ms]")
    jl, pl = pair({"t": lt, "a": np.float32([1, 2, 3])},
                  types={"t": VecType.TIME})
    jr, pr = pair({"t": rt, "b": np.float32([10, 20])},
                  types={"t": VecType.TIME})
    same_frame(jm.merge(jl, jr), munge.merge(pl, pr))
    same_frame(jm.merge(jl, jr, all_x=True), munge.merge(pl, pr, all_x=True))


def test_all_y_merge_keeps_a_time_keys_exact_ms():
    """Under ``all_y`` the JAX package rebuilds a TIME key with
    ``Vec.from_numpy(float ms, type=TIME)``, which stores float32 absolute
    epoch ms (131 s apart at 2024) and drops the exact host values
    (ROADMAP queue C); the port keeps the exact ms."""
    lt = np.array(["2024-01-01T00:00:01.001"], dtype="datetime64[ms]")
    rt = np.array(["2024-03-01T00:00:07.007"], dtype="datetime64[ms]")
    jl, pl = pair({"t": lt, "a": np.float32([1])}, types={"t": VecType.TIME})
    jr, pr = pair({"t": rt, "b": np.float32([2])}, types={"t": VecType.TIME})
    want = np.concatenate([lt, rt]).astype(np.int64).astype(np.float64)
    got = munge.merge(pl, pr, all_x=True, all_y=True)
    np.testing.assert_array_equal(got.vec("t").to_numpy(), want)
    assert got.vec("t").type is VecType.TIME
    ref = jm.merge(jl, jr, all_x=True, all_y=True).vec("t")
    assert ref.host_values is None and not np.array_equal(
        np.asarray(ref.to_numpy(), np.float64), want)


def test_rbind_and_cbind(frames, right_frames):
    jf, pf = frames
    jr, pr = right_frames
    same_frame(jm.rbind(jf, jf), munge.rbind(pf, pf))
    half_j, half_p = jm.filter_rows(jf, jf.vec("w") > 25), \
        munge.filter_rows(pf, pf.vec("w") > 25)
    same_frame(jm.rbind(half_j, jf, half_j), munge.rbind(half_p, pf, half_p))
    same_frame(jm.rbind(jr, jr), munge.rbind(pr, pr))
    assert munge.rbind(pf) is pf
    with pytest.raises(ValueError, match="names differ"):
        munge.rbind(pf, pr)
    same_frame(jm.cbind(jf[["x", "g"]], jf[["x"]], jf[["x"]]),
               munge.cbind(pf[["x", "g"]], pf[["x"]], pf[["x"]]))


def test_rbind_unions_domains():
    ja, pa = pair({"c": np.array(["b", "a", None], dtype=object)})
    jb, pb = pair({"c": np.array(["c", "a"], dtype=object)})
    same_frame(jm.rbind(ja, jb), munge.rbind(pa, pb))


@pytest.mark.parametrize("cols", [None, ["g"], ["g", "h"], ["k", "h"]])
def test_unique_and_table(frames, cols):
    jf, pf = frames
    sub_j, sub_p = jf[["g", "h", "k"]], pf[["g", "h", "k"]]
    same_frame(jm.unique(sub_j, cols), munge.unique(sub_p, cols))
    same_frame(jm.table(sub_j, cols), munge.table(sub_p, cols))


@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max"])
def test_pivot(frames, agg):
    jf, pf = frames
    same_frame(jm.pivot(jf, "k", "h", "x", agg),
               pf.pivot("k", "h", "x", agg),
               rtol=1e-5 if agg in ("sum", "mean") else 0.0, exact=["k"])


def test_pivot_refusals(frames):
    _, pf = frames
    with pytest.raises(TypeError, match="categorical"):
        pf.pivot("g", "x", "w")
    with pytest.raises(ValueError, match="unknown pivot agg"):
        pf.pivot("k", "h", "x", "median")


def test_melt(frames):
    jf, pf = frames
    same_frame(jm.melt(jf, ["g"], ["x", "w"]), pf.melt(["g"], ["x", "w"]))
    same_frame(jm.melt(jf[["h", "x", "w"]], ["h"], var_name="v",
                       value_name="val"),
               pf[["h", "x", "w"]].melt(["h"], var_name="v",
                                        value_name="val"))


def test_filter_and_gather(frames):
    jf, pf = frames
    same_frame(jm.filter_rows(jf, jf.vec("x") > 0),
               pf.filter(pf.vec("x") > 0))
    same_frame(jf[jf.vec("g") == "b"], pf[pf.vec("g") == "b"])
    idx = np.array([5, -1, 0, 239, 5], np.int64)
    same_frame(jm.gather_rows(jf, idx), munge.gather_rows(pf, idx))
    same_frame(jm.gather_rows(jf, idx),
               munge.gather_rows(pf, torch.as_tensor(idx)))
    mask = torch.as_tensor(np.asarray(jf.vec("w").to_numpy()) > 20)
    same_frame(jm.filter_rows(jf, jf.vec("w") > 20),
               munge.filter_rows(pf, mask))


def test_frame_structure(frames):
    jf, pf = frames
    same_frame(jf["x"], pf["x"])
    same_frame(jf[1], pf[1])
    same_frame(jf[["s", "g"]], pf[["s", "g"]])
    same_frame(jf.subframe(["t", "k"]), pf.subframe(["t", "k"]))
    with pytest.raises(TypeError, match="selector"):
        pf[1.5]
    with pytest.raises(KeyError):
        pf["nope"]
    f = Frame(list(pf.names), list(pf.vecs))
    f.add("x2", pf.vec("x"))
    assert f.names[-1] == "x2" and pf.names[-1] == "s"
    with pytest.raises(ValueError, match="duplicate"):
        f.add("x2", pf.vec("x"))
    with pytest.raises(ValueError, match="row count"):
        f.add("y", Frame.from_arrays({"y": np.float32([1])}).vec("y"))
    assert f.remove("x2") is pf.vec("x") and f.names == pf.names
    f.replace_vec("w", pf.vec("k"))
    assert f.vec("w") is pf.vec("k") and pf.vec("w") is not pf.vec("k")
    assert pf.shape == (N, 7) and len(pf) == N
    M = pf.matrix(["x", "g"])
    np.testing.assert_array_equal(
        M.numpy(), np.asarray(jf.matrix(["x", "g"]))[:N])
    with pytest.raises(TypeError, match="no device data"):
        pf.matrix(["s"])
    assert pf.head(6).equals(jf.head(6))


def test_split_frame_method(frames):
    jf, pf = frames
    for jp, pp in zip(jf.split_frame([0.3, 0.3], seed=9),
                      pf.split_frame([0.3, 0.3], seed=9)):
        same_frame(jp, pp)


def test_gathered_time_keeps_its_exact_ms():
    """A TIME column's float64 epoch ms (the ingest's ns / 1e6, often a
    float64 ulp below a whole ms) come through a sort exactly in the port;
    the JAX package's gather truncates them to whole ms, so such times move
    1 ms earlier (ROADMAP queue C)."""
    t = (np.datetime64("2022-05-01", "ms") + np.random.default_rng(8)
         .integers(0, 10 ** 8, 64).astype("timedelta64[ms]"))
    jf, pf = pair({"t": t, "k": np.arange(64, dtype=np.float32)[::-1]},
                  types={"t": VecType.TIME})
    want = pf.vec("t").to_numpy()[::-1]
    np.testing.assert_array_equal(munge.sort(pf, "k").vec("t").to_numpy(),
                                  want)
    ref = np.asarray(jm.sort(jf, "k").vec("t").to_numpy())
    assert (ref != want).any() and np.abs(ref - want).max() < 1.0
