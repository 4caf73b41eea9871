"""The advanced Rapids primitives of the port (``h2o3_tpu_torch/rapids/
advprims.py``) against the JAX package's (``h2o3_tpu/rapids/
advprims.py``), on one frame with missing values, ties, a categorical
column, a TIME column and a string column.

Exact: the numpy-drawn fold and split columns, ranks, the filled cells
(numeric, categorical and TIME), dropped duplicates, ``na.omit``, the
domain prims, ``which*``, ``match``, ``topn``, the repeaters, the string
prims, ``difflag1``, the iSAX codes and every row count. Within rtol 1e-5:
correlations, distances, the product and transpose (another float32 order
of additions or another GEMM), the moments (within 1e-4), ``mad``,
``apply``'s reductions and ``perfectAUC`` (float64 rank sums in the port,
float32 in the JAX package). A TIME column that went through a row gather
(dedup, sort, ``na.omit``) within 1 ms: the JAX package's gather truncates
the epoch ms (ROADMAP queue C; ``tests/test_torch_munge.py`` pins it). The
JAX package's ``na.omit`` and ``dropdup`` of all columns fail on a string
column; they are compared without one, and the port's handling of it is
checked on its own."""

import numpy as np
import pytest

from rapids_pair import (_cpu_port, pair, same_frame, same_value,  # noqa
                         same_vec)
from h2o3_tpu.rapids import advprims as jap
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.rapids import advprims as ap
from jax_reference import _jax_compile_cache  # noqa: F401

N = 96
rng = np.random.default_rng(31)
A = rng.normal(size=N).astype(np.float32)
A[[4, 30, 31, 32, 70]] = np.nan
B = (A * 0.5 + rng.normal(size=N) * 0.3).astype(np.float32)
B[[4, 8]] = np.nan
I = rng.integers(0, 6, N).astype(np.float32)           # ties
G = rng.choice(["p", "q", "r"], size=N).astype(object)
G[[3, 40, 41]] = None
Y = rng.integers(0, 2, N).astype(np.float32)
T = (np.datetime64("2022-05-01", "ms")
     + rng.integers(0, 10 ** 8, N).astype("timedelta64[ms]"))
T[[10, 11, 12, 60]] = np.datetime64("NaT")
S = rng.choice(["kitten", "sitting", "", "abcabc", None], N).astype(object)
COLS = {"a": A, "b": B, "i": I, "g": G, "y": Y, "t": T, "s": S}
TYPES = {"t": VecType.TIME, "s": VecType.STR}


@pytest.fixture(scope="module")
def frames():
    return pair(COLS, types=TYPES)


@pytest.mark.parametrize("method", ["Pearson", "Spearman"])
def test_cor(frames, method):
    jf, pf = frames
    cols = ["a", "b", "i", "y"]
    same_frame(jap.cor(jf[cols], method=method),
               ap.cor(pf[cols], method=method), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("measure", ["l1", "l2", "cosine", "cosine_sq"])
def test_distance(frames, measure):
    jf, pf = frames
    jx, px = jap.drop_duplicates(jf[["i", "y"]]), ap.drop_duplicates(
        pf[["i", "y"]])
    same_frame(jap.distance(jx, jx, measure), ap.distance(px, px, measure),
               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [7, 123])
def test_fold_and_split_columns(frames, seed):
    jf, pf = frames
    same_vec(jap.kfold_column(jf, 5, seed), ap.kfold_column(pf, 5, seed))
    same_vec(jap.modulo_kfold_column(jf, 4), ap.modulo_kfold_column(pf, 4))
    for c in ("i", "g"):
        same_vec(jap.stratified_kfold_column(jf.vec(c), 3, seed),
                 ap.stratified_kfold_column(pf.vec(c), 3, seed))
        same_vec(jap.stratified_split(jf.vec(c), 0.25, seed),
                 ap.stratified_split(pf.vec(c), 0.25, seed))


@pytest.mark.parametrize("na_rm", [True, False])
def test_moments_and_mode(frames, na_rm):
    jf, pf = frames
    for c in ("a", "i"):
        for fn in ("skewness", "kurtosis"):
            same_value(getattr(jap, fn)(jf.vec(c), na_rm),
                       getattr(ap, fn)(pf.vec(c), na_rm), rtol=1e-4,
                       what=fn)
    assert ap.mode(pf.vec("g")) == jap.mode(jf.vec("g"))
    with pytest.raises(ValueError, match="categorical"):
        ap.mode(pf.vec("a"))


@pytest.mark.parametrize("by,keep", [(None, "first"), (["i"], "last"),
                                     (["g", "i"], "first"), ([2.0], "last")])
def test_drop_duplicates(frames, by, keep):
    jf, pf = frames
    cols = ["a", "b", "i", "g", "y", "t"]
    same_frame(jap.drop_duplicates(jf[cols], by, keep),
               ap.drop_duplicates(pf[cols], by, keep), time_atol=1.0)


def test_matrix_prims(frames):
    jf, pf = frames
    jx, px = jf[["a", "b", "i"]], pf[["a", "b", "i"]]
    same_frame(jap.transpose(jx), ap.transpose(px), rtol=1e-6)
    jt, pt = jap.transpose(jx), ap.transpose(px)
    same_frame(jap.mmult(jt, jf[["i", "y"]]), ap.mmult(pt, pf[["i", "y"]]),
               rtol=1e-5, atol=1e-5)


def test_domain_prims(frames):
    jf, pf = frames
    jg, pg = jf.vec("g"), pf.vec("g")
    assert ap.any_factor(pf) == jap.any_factor(jf)
    assert ap.nlevels(pg) == jap.nlevels(jg)
    same_vec(jap.append_levels(jg, ["z", "p"]), ap.append_levels(pg, ["z",
                                                                      "p"]))
    same_vec(jap.relevel(jg, "r"), ap.relevel(pg, "r"))
    for top in (-1, 1):
        same_vec(jap.relevel_by_freq(jg, None, top),
                 ap.relevel_by_freq(pg, None, top))
    same_vec(jap.relevel_by_freq(jg, jf.vec("i")),
             ap.relevel_by_freq(pg, pf.vec("i")))
    same_vec(jap.set_domain(jg, ["P", "Q", "R"]),
             ap.set_domain(pg, ["P", "Q", "R"]))
    same_vec(jap.set_level(jg, "q"), ap.set_level(pg, "q"))
    for t in ("numeric", "categorical", "string", "time", "uuid", "bad"):
        assert ap.columns_by_type(pf, t) == jap.columns_by_type(jf, t)
    same_frame(jap.rename(jf, "a", "A"), ap.rename(pf, "a", "A"))
    same_frame(jap.rename(jf, 1.0, "B"), ap.rename(pf, 1.0, "B"))
    for bad in (lambda: ap.relevel(pg, "zz"), lambda: ap.set_level(pg, "zz"),
                lambda: ap.set_domain(pg, ["x"]),
                lambda: ap.columns_by_type(pf, "odd")):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("method,maxlen", [("forward", 1), ("forward", 2),
                                           ("backward", 1), ("backward", 3),
                                           ("forward", 0)])
def test_fillna(frames, method, maxlen):
    jf, pf = frames
    cols = ["a", "g", "t", "s", "i"]
    same_frame(jap.fillna(jf[cols], method, 0, maxlen),
               ap.fillna(pf[cols], method, 0, maxlen))


def test_na_prims(frames):
    jf, pf = frames
    cols = ["a", "b", "i", "g", "y", "t"]
    same_frame(jap.na_omit(jf[cols]), ap.na_omit(pf[cols]), time_atol=1.0)
    # a missing string drops its row too
    keep = ap.na_omit(pf[["s", "i"]]).vec("s").host_values
    assert len(keep) == sum(v is not None for v in S) and None not in keep
    for frac in (0.02, 0.2):
        assert ap.filter_na_cols(pf, frac) == jap.filter_na_cols(jf, frac)
    assert ap.any_na(pf) == jap.any_na(jf)
    for c in ("a", "i", "g"):
        for fn in ("max_na", "min_na", "sum_na", "prod_na", "na_cnt"):
            same_value(getattr(jap, fn)(jf.vec(c)),
                       getattr(ap, fn)(pf.vec(c)), rtol=1e-5, what=fn)
        same_value(jap.mad(jf.vec(c)), ap.mad(pf.vec(c)), rtol=1e-5)


@pytest.mark.parametrize("asc", [None, [False], [True, False]])
@pytest.mark.parametrize("sorted_out", [False, True])
def test_rank_within_group_by(frames, asc, sorted_out):
    jf, pf = frames
    scols = ["i", "a"] if asc and len(asc) == 2 else ["a"]
    same_frame(jap.rank_within_group_by(jf, ["g"], scols, asc, "rk",
                                        sorted_out),
               ap.rank_within_group_by(pf, ["g"], scols, asc, "rk",
                                       sorted_out), time_atol=1.0)
    same_frame(jap.rank_within_group_by(jf, [5.0], [2.0]),
               ap.rank_within_group_by(pf, [5.0], [2.0]))


def test_ddply_apply_and_sum_axis(frames):
    jf, pf = frames
    for fn in ("mean", "sum", "nrow", "median"):
        same_frame(jap.ddply(jf, ["g"], "a", fn), ap.ddply(pf, ["g"], "a",
                                                           fn),
                   rtol=1e-5, exact=["g"])
    same_frame(jap.ddply(jf, 3.0, 2.0, "max"), ap.ddply(pf, 3.0, 2.0, "max"))
    x_j, x_p = jf[["a", "b", "i"]], pf[["a", "b", "i"]]
    for margin in (1, 2):
        for fn in ("sum", "mean", "min", "max", "median", "sd", "var", "abs",
                   "sqrt"):
            same_frame(jap.apply_margin(x_j, margin, fn),
                       ap.apply_margin(x_p, margin, fn), rtol=1e-5,
                       atol=1e-6, what=f"{margin} {fn}")
    with pytest.raises(ValueError, match="apply supports"):
        ap.apply_margin(x_p, 1, "mode")
    for na_rm in (True, False):
        for axis in (0, 1):
            same_frame(jap.sum_axis(x_j, na_rm, axis),
                       ap.sum_axis(x_p, na_rm, axis), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("col,pct,grab", [("a", 10, "top"), ("i", 25, "top"),
                                          (0.0, 5, "bottom"),
                                          ("i", 0.01, "bottom")])
def test_topn(frames, col, pct, grab):
    jf, pf = frames
    same_frame(jap.topn(jf, col, pct, grab), ap.topn(pf, col, pct, grab))


def test_repeaters(frames):
    jf, pf = frames
    for args in ((1, 10, 1), (0, 1, 0.25), (5, -3, -2)):
        same_vec(jap.seq(*args), ap.seq(*args))
    same_vec(jap.seq_len(7), ap.seq_len(7))
    for n in (5, 200):
        for c in ("a", "g"):
            same_vec(jap.rep_len(jf.vec(c), n), ap.rep_len(pf.vec(c), n))
    same_vec(jap.rep_len(2.5, 9), ap.rep_len(2.5, 9))


def test_search_prims(frames):
    jf, pf = frames
    same_vec(jap.match(jf.vec("i"), [3.0, 1.0]), ap.match(pf.vec("i"),
                                                          [3.0, 1.0]))
    same_vec(jap.match(jf.vec("g"), ["r", "p"], -1.0, 0),
             ap.match(pf.vec("g"), ["r", "p"], -1.0, 0))
    same_vec(jap.match(jf.vec("i"), 4.0), ap.match(pf.vec("i"), 4.0))
    for c in ("y", "a"):
        same_vec(jap.which(jf.vec(c)), ap.which(pf.vec(c)))
    same_vec(jap.which(jf.vec("y") > 5), ap.which(pf.vec("y") > 5))
    x_j, x_p = jf[["a", "b", "i"]], pf[["a", "b", "i"]]
    for axis in (0, 1):
        same_frame(jap.which_max(x_j, axis=axis), ap.which_max(x_p,
                                                              axis=axis))
        same_frame(jap.which_min(x_j, axis=axis), ap.which_min(x_p,
                                                              axis=axis))


def test_string_prims(frames):
    jf, pf = frames
    for c in ("s", "g"):
        same_vec(jap.count_matches(jf.vec(c), "t"),
                 ap.count_matches(pf.vec(c), "t"))
        same_vec(jap.count_matches(jf.vec(c), ["ab", "q"]),
                 ap.count_matches(pf.vec(c), ["ab", "q"]))
    jr = jap.rank_within_group_by(jf, ["g"], ["i"])
    pr = ap.rank_within_group_by(pf, ["g"], ["i"])
    for measure in ("lv", "jaccard"):
        for ce in (True, False):
            same_vec(jap.str_distance(jf.vec("s"), jr.vec("g"), measure, ce),
                     ap.str_distance(pf.vec("s"), pr.vec("g"), measure, ce))
    same_frame(jap.tokenize(jf[["s", "g"]], "a"),
               ap.tokenize(pf[["s", "g"]], "a"))


def test_timeseries_prims(frames):
    jf, pf = frames
    same_vec(jap.difflag1(jf.vec("a")), ap.difflag1(pf.vec("a")))
    w = {f"c{j}": rng.normal(size=12).astype(np.float32) for j in range(8)}
    jw, pw = pair(w)
    same_frame(jap.isax(jw, 3, 5), ap.isax(pw, 3, 5))


def test_perfect_auc(frames):
    jf, pf = frames
    for p in ("a", "i"):
        same_value(jap.perfect_auc(jf.vec(p), jf.vec("y")),
                   ap.perfect_auc(pf.vec(p), pf.vec("y")), rtol=1e-6)
    assert ap.perfect_auc(pf.vec("a"), pf.vec("y") * 0) == 1.0


def test_flatten_and_getrow(frames):
    jf, pf = frames
    for c in ("a", "g", "s"):
        same_value(jap.flatten(jap.munge.gather_rows(jf[[c]], [7])),
                   ap.flatten(ap.munge.gather_rows(pf[[c]], [7])))
    same_value(jap.getrow(jap.munge.gather_rows(jf, [9])),
               ap.getrow(ap.munge.gather_rows(pf, [9])))
    with pytest.raises(ValueError, match="1x1"):
        ap.flatten(pf)
    with pytest.raises(ValueError, match="1-row"):
        ap.getrow(pf)


def test_grouped_permute():
    rng2 = np.random.default_rng(4)
    n = 40
    cols = {"grp": rng2.integers(0, 3, n).astype(np.float32),
            "id": rng2.integers(0, 5, n).astype(np.float32),
            "side": rng2.choice(["D", "C"], n).astype(object),
            "amt": np.round(rng2.uniform(0, 10, n), 1).astype(np.float32)}
    jf, pf = pair(cols)
    same_frame(jap.grouped_permute(jf, "id", ["grp"], "side", "amt"),
               ap.grouped_permute(pf, 1.0, 0.0, 2.0, 3.0), rtol=1e-6)
    cols["side"] = np.full(n, "C", dtype=object)
    jf, pf = pair(cols)
    same_frame(jap.grouped_permute(jf, "id", "grp", "side", "amt"),
               ap.grouped_permute(pf, "id", "grp", "side", "amt"))


@pytest.mark.parametrize("case", ["scalar", "na", "mask", "cat", "str",
                                  "time", "frame_full", "frame_slice"])
def test_rectangle_assign(frames, case):
    jf, pf = frames
    ms = float(np.datetime64("2030-01-01T00:00:00.5", "ms").astype(np.int64))
    args = {"scalar": (99.0, [0, 2], [1, 5, 7]),
            "na": (None, [], [0, 3]),
            "mask": (7.0, ["b"], "mask"),
            "cat": ("q", [3], [0, 1, 2]),
            "str": ("new", [6], np.array([4.0, 5.0])),
            "time": (ms, [5], [2, 10]),
            "frame_full": ("full", [0, 2], []),
            "frame_slice": ("slice", [0, 5, 3], [1, 2])}[case]
    src, cols, rows = args
    jrows, prows = rows, rows
    if isinstance(rows, str):
        jrows, prows = jf.vec("a") > 0.5, pf.vec("a") > 0.5
    jsrc, psrc = src, src
    if src == "full":
        jsrc, psrc = jf[["i", "b"]], pf[["i", "b"]]
    elif src == "slice":
        w = np.array([int(ms), int(ms) + 1]).astype("datetime64[ms]")
        jsrc, psrc = pair({"v": np.float32([5, 6]), "w": w,
                           "z": np.array(["r", "p"], dtype=object)},
                          types={"w": VecType.TIME})
    same_frame(jap.rectangle_assign(jf, jsrc, cols, jrows),
               ap.rectangle_assign(pf, psrc, cols, prows))


def test_rectangle_assign_refusals(frames):
    _, pf = frames
    with pytest.raises(ValueError, match="out of range"):
        ap.rectangle_assign(pf, 1.0, [0], [N])
    with pytest.raises(ValueError, match="source frame"):
        ap.rectangle_assign(pf, pf[["a"]].filter(pf.vec("a") > 0), [0],
                            [0, 1])
