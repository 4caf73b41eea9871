"""The Rapids expression engine of the port (``h2o3_tpu_torch/rapids/
exec.py``) against the JAX package's (``h2o3_tpu/rapids/exec.py``): the
parser on the same strings, every primitive of ``known_prims()`` through
``rapids()`` on the same DKV-keyed frames in both packages (or its refusal
by name; the model prims are in ``test_torch_rapids_models.py``), and one
whole session in h2o-py's wire form at toy size
(group-by, merge, sort, ``tmp=`` columns, impute, cumsum, quantile of an
rbind, table, unique, ranks, fillna, a runif split).

Results equal exactly unless an expression carries a tolerance: float
aggregates, moments, correlations and transcendental functions within
the rtol beside them (the reasons are those of ``test_torch_munge.py``,
``_rapids_ops.py`` and ``_advprims.py``)."""

import re

import numpy as np
import pytest

from rapids_pair import _cpu_port, pair, same_value  # noqa: F401
from h2o3_tpu.rapids import exec as jx
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.rapids import exec as px
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

N = 64
rng = np.random.default_rng(41)
A = rng.normal(size=N).astype(np.float32)
A[[2, 20, 21]] = np.nan
COLS = {
    "a": A, "b": (A * 0.3 + rng.normal(size=N)).astype(np.float32),
    "p": rng.uniform(0.1, 4.0, N).astype(np.float32),
    "i": rng.integers(0, 6, N).astype(np.float32),
    "g": rng.choice(["p", "q", "r"], N).astype(object),
    "h": rng.choice(["x", "y", "z"], N).astype(object),
    "y": rng.integers(0, 2, N).astype(np.float32),
    # whole seconds: their float64 epoch ms are exact, so the JAX
    # package's truncating row gathers keep them (ROADMAP queue C)
    "t": (np.datetime64("2023-01-01", "ms")
          + rng.integers(0, 10 ** 7, N).astype("timedelta64[s]")),
    "s": rng.choice(["kitten", "sit ting", "", "abcab", None], N
                    ).astype(object),
}
TYPES = {"t": VecType.TIME, "s": VecType.STR}
LOOKUP = {"g": np.array(["p", "r", "r", "w"], dtype=object),
          "z": np.float32([1, 2, 3, 4])}
PERM = {"grp": rng.integers(0, 3, 30).astype(np.float32),
        "id": rng.integers(0, 4, 30).astype(np.float32),
        "side": rng.choice(["D", "C"], 30).astype(object),
        "amt": np.round(rng.uniform(0, 9, 30), 1).astype(np.float32)}


@pytest.fixture(scope="module")
def frames():
    return {"fr": pair(COLS, types=TYPES), "lk": pair(LOOKUP),
            "gp": pair(PERM)}


@pytest.fixture
def keyed(frames):
    """The frames under the same keys in both packages' DKVs."""
    for k, (jf, pf) in frames.items():
        jf.key = pf.key = k
        JDKV.put(k, jf)
        DKV.put(k, pf)
    yield
    DKV.clear()


PARSE = ["(+ (cols fr 'a') 1)", "(rows fr [1:4])", "(rows fr [0:3:2])",
         "(cols fr ['a' \"b\"])", "(x #3 TRUE FALSE NA nan True)",
         "(sort fr [] [])", "[1 2 [3 4]]", "(f [ ] 'x y' -1.5e3)"]


def _norm(node):
    if isinstance(node, np.ndarray):
        return ("arr", node.tolist())
    if isinstance(node, list):
        return [_norm(n) for n in node]
    if isinstance(node, float) and np.isnan(node):
        return "nan"
    return node


@pytest.mark.parametrize("expr", PARSE)
def test_parser(expr):
    assert px._tokenize(expr) == jx._tokenize(expr)
    assert _norm(px._parse(px._tokenize(expr))) == \
        _norm(jx._parse(jx._tokenize(expr)))


def test_parser_refuses_open_ranges():
    with pytest.raises(ValueError, match="open-ended"):
        px._parse(px._tokenize("[1:nan]"))


#: (expression, rtol) — every prim the engine dispatches outside the model
#: family and the session ops
EXPRS = [(f"({op} (cols fr 'a') (cols fr 'b'))", 1e-6 if op == "^" else 0)
         for op in jx._BINOPS] + [
    (f"({op} (cols fr 'a') 2)", 1e-6 if op == "^" else 0)
    for op in jx._BINOPS] + [
    (f"({op} 2 (cols fr 'a'))", 1e-6 if op == "^" else 0)
    for op in jx._BINOPS if op != "%"] + [
    (f"({op} 3 4)", 0) for op in jx._BINOPS] + [
    ("(+ (cols fr ['a' 'b']) (cols fr ['p' 'i']))", 0),
] + [(f"({op} (cols fr '{'p' if op in ('acosh', 'log', 'log2', 'log10', 'log1p', 'sqrt', 'gamma', 'trigamma', 'digamma', 'lgamma') else 'y' if op in ('asin', 'acos', 'atanh') else 'a'}'))",
      1e-5) for op in sorted(jx.ops._UNARY)] + [
    (f"({op} (cols fr 'p'))", 1e-5) for op in jx._REDUCERS] + [
    ("(cols fr [0 4])", 0), ("(cols fr ['g' 'a'])", 0), ("(cols_py fr 1)", 0),
    ("(rows fr [0 3 5])", 0), ("(rows fr [2:4])", 0),
    ("(rows fr (> (cols fr 'a') 0))", 0), ("(nrow fr)", 0), ("(ncol fr)", 0),
    ("(rbind (cols fr ['a' 'g' 's']) (cols fr ['a' 'g' 's']))", 0),
    ("(cbind (cols fr 'a') (cols fr 'a'))", 0), ("(unique (cols fr 'g'))", 0),
    ("(sort (cols fr ['a' 'b' 'i' 'g']) [2 3] [1 0])", 0),
    ("(sort (cols fr ['a' 'i']) 'a')", 0),
    ("(merge (cols fr ['g' 'a']) lk)", 0), ("(h2o.runif fr 42)", 0),
    ("(quantile (cols fr ['a' 'p']) [0.1 0.5 0.9])", 1e-6),
    ("(quantile (cols fr ['a' 'p']))", 1e-6),
    ("(cumsum (cols fr 'a'))", 1e-5), ("(cumprod (cols fr 'y'))", 0),
    ("(cummin (cols fr ['a' 'b']))", 0), ("(cummax (cols fr 'i'))", 0),
    ("(cut (cols fr 'a') [-1 0 1 2])", 0), ("(hist (cols fr 'a') 5)", 0),
    ("(h2o.impute (cbind (cols fr 'a') (cols fr 'g')) 'a' 'median')", 1e-6),
    ("(impute (cbind (cols fr 'a') (cols fr 'g')) 'a')", 1e-5),
    ("(scale (cols fr ['a' 'p']) 1 0)", 1e-5), ("(scale (cols fr 'p'))", 1e-5),
    ("(round (cols fr 'a') 1)", 0), ("(round (cols fr 'a'))", 0),
    ("(signif (cols fr 'a') 3)", 1e-6), ("(signif (cols fr 'p'))", 1e-6),
    ("(table (cols fr ['g' 'h']))", 0), ("(GB fr [4] 'a' 'mean')", 1e-5),
    ("(groupby fr 'g' 'i' 'max')", 0), ("(pivot fr 'i' 'h' 'a')", 1e-5),
    ("(melt (cols fr ['g' 'a' 'b']) ['g'])", 0),
    ("(melt (cols fr ['g' 'a']) 'g')", 0),
    ("(as.factor (cols fr ['i' 'g']))", 0),
    ("(as.character (cols fr ['g' 'i']))", 0),
    ("(as.numeric (cols fr 'g'))", 0), ("(is.na fr)", 0),
    ("(is.factor fr)", 0), ("(is.numeric fr)", 0), ("(colnames fr)", 0),
    ("(levels (cols fr 'g'))", 0),
    ("(ifelse (> (cols fr 'a') 0) (cols fr 'b') -1)", 0),
    ("(ifelse (cols fr 'y') 1 (cols fr 'p'))", 0),
    ("(strsplit (cols fr 's') 't')", 0), ("(toupper (cols fr 'g'))", 0),
    ("(tolower (cols fr 's'))", 0), ("(trim (cols fr 's'))", 0),
    ("(lstrip (cols fr 's') 'k')", 0), ("(rstrip (cols fr 's'))", 0),
    ("(nchar (cols fr 's'))", 0), ("(substring (cols fr 's') 1 3)", 0),
    ("(sub (cols fr 's') 'a' 'X')", 0), ("(gsub (cols fr 'g') 'p' 'P')", 0),
    ("(grep (cols fr 's') 'it')", 0), ("(entropy (cols fr 's'))", 1e-6),
    ("(startsWith (cols fr 's') 'ki')", 0),
    ("(endsWith (cols fr 's') 'ng')", 0),
] + [(f"({op} (cols fr 't'))", 0) for op in jx._TIME_OPS] + [
    ("(cor (cols fr ['a' 'b' 'i']))", 1e-5),
    ("(cor (cols fr ['a' 'b']) (cols fr ['a' 'b']) 'complete.obs' "
     "'Spearman')", 1e-5),
    ("(spearman (cols fr ['a' 'b']))", 1e-5),
    ("(distance (cols fr ['i' 'y']) (cols fr ['i' 'y']) 'l1')", 1e-5),
    ("(distance (cols fr ['i' 'p']) (cols fr ['i' 'p']))", 1e-5),
    ("(kfold_column fr 5 7)", 0), ("(modulo_kfold_column fr 3)", 0),
    ("(stratified_kfold_column (cols fr 'g') 3 5)", 0),
    ("(h2o.random_stratified_split (cols fr 'y') 0.3 9)", 0),
    ("(stratified_split (cols fr 'g') 0.2 1)", 0),
    ("(skewness (cols fr 'a') 1)", 1e-4), ("(kurtosis (cols fr 'a') 0)", 1e-4),
    ("(mode (cols fr 'g'))", 0), ("(dropdup (cols fr ['g' 'i']) [0] 'last')",
                                  0),
    ("(dropdup (cols fr ['g' 'i']))", 0),
    ("(x (cols fr ['i' 'y']) (t (cols fr ['i' 'y'])))", 1e-5),
    ("(t (cols fr ['a' 'b']))", 0), ("(ddply fr 4 1 'mean')", 1e-5),
    ("(h2o.fillna (cols fr ['a' 'g']) 'backward' 0 2)", 0),
    ("(h2o.fillna (cols fr 'a'))", 0),
    ("(filterNACols fr 0.04)", 0), ("(na.omit (cols fr ['a' 'b' 'g']))", 0),
    ("(nlevels (cols fr 'g'))", 0),
    ("(rank_within_groupby fr [4] [0] [0] 'r' 0)", 0),
    ("(rank_within_groupby (cols fr ['g' 'i' 'a']) [0] [1 2] 1)", 0),
    ("(relevel (cols fr 'g') 'r')", 0),
    ("(relevel.by.freq (cols fr 'g') 1)", 0),
    ("(setDomain (cols fr 'h') ['X' 'Y' 'Z'])", 0),
    ("(setLevel (cols fr 'h') 'y')", 0),
    ("(appendLevels (cols fr 'h') ['w'])", 0), ("(any.factor fr)", 0),
    ("(columnsByType fr 'categorical')", 0),
    ("(apply (cols fr ['a' 'b']) 1 'mean')", 1e-5),
    ("(apply (cols fr ['a' 'b']) 2 'sd')", 1e-5),
    ("(flatten (rows (cols fr 'g') [3]))", 0),
    ("(getrow (rows (cols fr ['a' 'g' 's']) [3]))", 0),
    ("(h2o.mad (cols fr 'a'))", 1e-5), ("(maxNA (cols fr 'a'))", 0),
    ("(minNA (cols fr 'b'))", 0), ("(sumNA (cols fr 'i'))", 1e-6),
    ("(prod.na (cols fr 'y'))", 0), ("(naCnt (cols fr 'a'))", 0),
    ("(any.na fr)", 0), ("(sumaxis (cols fr ['a' 'b']) 1 1)", 1e-5),
    ("(sumaxis (cols fr ['a' 'b']))", 1e-5),
    ("(topn fr 0 20 0)", 0), ("(topn fr 'i' 10 1)", 0),
    ("(seq 1 10 2)", 0), ("(seq_len 5)", 0),
    ("(rep_len (cols fr 'g') 100)", 0), ("(rep_len 3 4)", 0),
    ("(match (cols fr 'g') ['r' 'p'] -1 1)", 0),
    ("(match (cols fr 'i') [2 3])", 0), ("(match (cols fr 'i') 4)", 0),
    ("(which (cols fr 'y'))", 0), ("(which.max (cols fr ['a' 'b']) 1 0)", 0),
    ("(which.min (cols fr ['a' 'b']) 1 1)", 0),
    ("(countmatches (cols fr 's') 'a')", 0),
    ("(countmatches (cols fr ['s' 'g']) ['ab' 'q'])", 0),
    ("(strDistance (cols fr 's') (cols fr 'g') 'jaccard' 1)", 1e-6),
    ("(strDistance (cols fr 's') (cols fr 'g'))", 0),
    ("(tokenize (cols fr 's') ' ')", 0), ("(difflag1 (cols fr 'a'))", 0),
    ("(isax (cols fr ['i' 'y' 'p']) 2 4 0)", 0),
    ("(perfectAUC (cols fr 'a') (cols fr 'y'))", 1e-6),
    ("(replaceall (cols fr 's') 'a' 'A' 0)", 0),
    ("(replacefirst (cols fr 'g') 'P' 'Q' 1)", 0),
    ("(num_valid_substrings (cols fr 's') ['ab' 'it'])", 0),
    ("(append (cols fr ['a' 'g']) (cols fr 'b') 'b2')", 0),
    ("(moment 2020 (cols fr 'i') 3 4 5 6 7)", 0), ("(moment 1999 12 31)", 0),
    ("(getTimeZone)", 0), ("(listTimeZones)", 0), ("(ls)", 0),
    ("(mod (cols fr 'i') 4)", 0), ("(%% 7 (cols fr 'i'))", 0),
    ("(intDiv (cols fr 'a') 0.5)", 0), ("(%/% 7 (cols fr 'i'))", 0),
    ("(%/% 7 2)", 0), ("(mod 7.3 2)", 0), ("(intDiv (cols fr 'i') 0)", 0),
    ("(mod (cols fr ['a' 'p']) (cols fr 'i'))", 0),
    ("(grouped_permute gp 1 0 2 3)", 1e-6),
    ("(:= fr 99 [0] [0 1 2])", 0), ("(:= fr 'q' [4] [])", 0),
    ("(:= fr 7 [1] (> (cols fr [0]) 1))", 0),
    ("(:= fr (cols lk 'z') [1] [5 6 7 8])", 0),
]
#: ops refused by name, with the exception and message each raises
REFUSED = {
    "setTimeZone": (ValueError, "UTC"),
}
SESSION_OPS = {"tmp=", "assign", "rm", "h2o.rm", "colnames=", "rename"}
MODEL_OPS = {"PermutationVarImp", "makeLeaderboard", "model.reset.threshold",
             "segment_models_as_frame", "result", "transform",
             "fairnessMetrics", "model.testJavaScoring"}


def _heads(expr: str) -> set:
    return set(re.findall(r"\(([^\s()\[\]]+)", expr))


def test_known_prims_are_the_reference_set_and_all_covered():
    assert px.known_prims() == jx.known_prims()
    covered = set().union(*(_heads(e) for e, _ in EXPRS)) | set(REFUSED) \
        | SESSION_OPS | MODEL_OPS
    assert px.known_prims() - covered == set()


@pytest.mark.parametrize("expr,rtol", EXPRS, ids=[e for e, _ in EXPRS])
def test_prim(keyed, expr, rtol):
    j = jx.rapids(expr)
    p = px.rapids(expr)
    same_value(j, p, rtol=rtol, atol=rtol, what=expr)


@pytest.mark.parametrize("op", sorted(REFUSED))
def test_refused_by_name(keyed, op):
    exc, msg = REFUSED[op]
    with pytest.raises(exc, match=re.escape(msg)):
        px.rapids(f"({op} fr fr 'x')")
    with pytest.raises(Exception):
        jx.rapids(f"({op} fr fr 'x')")


def test_unknown_ops_and_keys(keyed):
    with pytest.raises(ValueError, match="unknown rapids op"):
        px.rapids("(frobnicate fr)")
    with pytest.raises(KeyError, match="unknown identifier"):
        px.rapids("(nrow nosuchkey)")
    with pytest.raises(KeyError):
        px.rapids("(% 2 (cols fr 'a'))")      # as the JAX package's
    with pytest.raises(KeyError):
        jx.rapids("(% 2 (cols fr 'a'))")


def test_session_temps_rename_and_colnames(keyed):
    js, ps = jx.Session(), px.Session()
    for expr in ("(tmp= t1 (* (cols fr 'a') 2))", "(assign t2 (cols fr 'g'))",
                 "(+ t1 1)", "(colnames= t1 [0] ['dbl'])", "(colnames t1)"):
        same_value(jx.rapids(expr, js), px.rapids(expr, ps), what=expr)
    assert DKV.get("t1").names == ["dbl"] and DKV.get("t2").key == "t2"
    assert px.rapids("(rm t2)", ps) == 0.0 and "t2" not in DKV
    assert px.rapids("(h2o.rm t1)", ps) == 0.0 and "t1" not in DKV
    px.rapids("(tmp= t3 (cols fr 'b'))", ps)
    assert np.isnan(px.rapids('(rename "t3" "t4")', ps))
    assert "t3" not in DKV and DKV.get("t4").key == "t4"
    same_value(jx.rapids("(rename fr 1 'B')"), px.rapids("(rename fr 1 'B')"))
    with pytest.raises(ValueError, match="same number"):
        px.rapids("(colnames= fr [0 1] ['x'])")
    with pytest.raises(ValueError, match="out of"):
        px.rapids("(colnames= lk [5] ['x'])")
    with pytest.raises(KeyError, match="unknown key"):
        px.rapids('(rename "nokey" "x")')
    ps.end()
    assert "t4" not in DKV and "fr" in DKV


# -- one session in h2o-py's wire form (chip_smoke.py phase 15d, toy size)


def test_munging_session(keyed):
    """Group-by, merge, sort, tmp= columns made with intDiv/ifelse/cut, an
    impute, cumsum over the sorted frame, the quantile of an rbind, table,
    unique, ranks, fillna with maxlen and a runif split: each step's frame
    equal in both packages."""
    steps = [
        ("(tmp= gb (GB fr [4] 'a' 'mean'))", 1e-5),
        ("(tmp= mg (merge (cols fr ['g' 'h' 'i' 'a' 'p']) lk))", 0),
        ("(tmp= srt (sort mg [0 2] [1 0]))", 0),
        ("(tmp= hr (intDiv (cols mg 'i') 2))", 0),
        ("(tmp= late (ifelse (> (cols mg 'p') 2) 1 0))", 0),
        ("(tmp= band (cut (cols mg 'p') [0 1 2 3 5]))", 0),
        ("(tmp= mg2 (cbind mg hr late band))", 0),
        ("(h2o.impute mg2 'a' 'mean')", 1e-5),
        ("(cumsum (cols srt 'p'))", 1e-5),
        ("(quantile (rbind mg mg) [0.1 0.5 0.99])", 1e-6),
        ("(table (cols mg ['h' 'g']))", 0),
        ("(unique (cols mg 'h'))", 0),
        ("(rank_within_groupby mg [0] [4] [0] 'rank' 0)", 0),
        ("(h2o.fillna (cols fr ['a' 'b']) 'forward' 0 2)", 0),
        ("(tmp= rnd (h2o.runif mg 1234))", 0),
        ("(rows mg (< rnd 0.8))", 0), ("(rows mg (>= rnd 0.8))", 0),
    ]
    js, ps = jx.Session(), px.Session()
    for expr, rtol in steps:
        same_value(jx.rapids(expr, js), px.rapids(expr, ps), rtol=rtol,
                   atol=rtol, what=expr)
    ps.end()
    js.end()
