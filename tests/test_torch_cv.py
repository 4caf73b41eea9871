"""Cross-validation in the port (``h2o3_tpu_torch/models/model_base.py``:
``_fold_ids``, ``_cross_validate`` and the checks in ``train``) against
the JAX package's ``ModelBuilder`` on the same numpy-seeded frames.

Row counts are multiples of 64, so the reference's frames carry no pad
rows (tests/conftest.py's 8 devices; ROADMAP queue C).

Tolerances: fold ids exactly (Modulo, Stratified, a fold column); the
pooled out-of-fold probabilities of GBM at atol 1e-5 (the reference's
histograms are per-device partials summed by a psum, so leaves differ in
the last bits, as in tests/test_torch_gbm.py) and gaussian predictions
at 1e-5 of their scale; CV AUC within 1e-4 (the 400-bin histogram),
logloss, MSE and the summary's values at rtol 1e-4; GLM's pooled
predictions at rtol 1e-5 (tests/test_torch_glm.py's prediction
tolerance) and its metrics at rtol 1e-5; CoxPH's CV MSE at rtol 1e-3
(its fits stop where the float32 log-likelihood stops moving, as
tests/test_torch_coxph.py notes: on this frame one fold's MSE differs by
4.3e-4 relative, the others by less than 1e-6). The reference's Random folds
come from ``jax.random``: they are injected into the port
(``model_base.random_folds``) and the CV is then held as above.

Every other supervised builder's CV metrics, summary and kept out-of-fold
predictions are held to the reference's (``SAME_AS_REFERENCE``): at rtol
1e-4 and 1e-5 of the largest prediction where both packages fit alike
(DeepLearning on one minibatch of every row, its initial weights injected
into both), RuleFit at rtol 2e-3 and 5e-3 (its L1 GLM is not unique).
DRF (bootstrap draws from each package's stream) is held to the
reference by metric over three seeds, and PSVM (a chaotic float32 IPM,
whose folds the port fits on the kept rows alone) to per-fold fits on a
frame of those rows, over three frames (``BY_METRIC``). The uplift DRF's CV fails in the reference and is
refused by name in the port.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import model_base
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.models.glm import GLM
from jax_reference import _jax_compile_cache  # noqa: F401

N = 1024
TREES = dict(ntrees=4, max_depth=3, nbins=16, learn_rate=0.2, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def cv_cols(n=N, seed=3):
    """Four numeric features (one with missing values), a categorical, a
    binary, a 3-class and a numeric response, integer weights and two
    fold columns."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    g = rng.choice(np.array(["a", "b", "c"]), n)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.7 * (g == "b")
    yb = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    ym = np.array(["k0", "k1", "k2"])[np.digitize(
        X[:, 0] + 0.5 * X[:, 2] + rng.normal(scale=0.5, size=n),
        [-0.5, 0.5])]
    yg = (2 * X[:, 0] - X[:, 3] + 0.3 * rng.normal(size=n)).astype(np.float32)
    X[rng.random(n) < 0.05, 2] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols.update(g=g, yb=yb, ym=ym, yg=yg,
                w=rng.integers(1, 4, n).astype(np.float32),
                fnum=rng.choice(np.float32([3, 7, 9, 12]), n),
                fcat=rng.choice(np.array(["f1", "f2", "f3"]), n))
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = cv_cols()
    return cols, JFrame.from_arrays(cols), Frame.from_arrays(cols)


def _jfolds(builder, jf, nfolds, y):
    return np.asarray(builder._fold_ids(jf, nfolds, jf.vec(y)))[: jf.nrows]


@pytest.mark.parametrize("params,y", [
    (dict(nfolds=5), "yb"),
    (dict(nfolds=4, fold_assignment="Stratified"), "yb"),
    (dict(nfolds=3, fold_assignment="Stratified"), "ym"),
    (dict(fold_column="fnum"), "yb"),
    (dict(fold_column="fcat"), "yg"),
])
def test_fold_ids_equal_the_reference(frames, params, y):
    _, jf, pf = frames
    jb, pb = JGBM(**params), GBM(**params)
    nfolds = pb._check_folds(pf)
    assert nfolds == (params.get("nfolds")
                      or jb._fold_column_cardinality(jf))
    np.testing.assert_array_equal(
        pb._fold_ids(pf, nfolds, pf.vec(y)).numpy(),
        _jfolds(jb, jf, nfolds, y))


def test_stratified_folds_hold_every_class_in_every_fold(frames):
    _, _, pf = frames
    ids = GBM(nfolds=4, fold_assignment="Stratified")._fold_ids(
        pf, 4, pf.vec("ym")).numpy()
    codes = pf.vec("ym").data.numpy()
    for c in range(3):
        counts = np.bincount(ids[codes == c], minlength=4)
        assert counts.max() - counts.min() <= 1


def test_random_folds_are_seeded_and_in_range(frames):
    _, _, pf = frames
    a = GBM(nfolds=4, fold_assignment="Random", seed=9)._fold_ids(pf, 4)
    b = GBM(nfolds=4, fold_assignment="Random", seed=9)._fold_ids(pf, 4)
    c = GBM(nfolds=4, fold_assignment="Random", seed=10)._fold_ids(pf, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(np.unique(a.numpy())) == {0, 1, 2, 3}


@pytest.mark.parametrize("params,exc,match", [
    (dict(nfolds=3, fold_column="fnum"), ValueError, "not both"),
    (dict(fold_column="const"), ValueError, "at least 2"),
    (dict(fold_column="fna"), ValueError, "missing values"),
    (dict(fold_column="fcatna"), ValueError, "missing values"),
    (dict(nfolds=1), ValueError, "at least 2"),
    (dict(nfolds=3, fold_assignment="Stratified", _y="yg"), ValueError,
     "categorical response"),
    (dict(nfolds=3, fold_assignment="Striped"), ValueError, "Modulo"),
])
def test_refusals(frames, params, exc, match):
    cols = dict(frames[0])
    fna = cols["fnum"].copy()
    fna[5] = np.nan
    fcatna = cols["fcat"].astype(object)
    fcatna[7] = None
    cols.update(const=np.ones(N, np.float32), fna=fna, fcatna=fcatna)
    pf = Frame.from_arrays(cols)
    params = dict(params)
    y = params.pop("_y", "yb")
    with pytest.raises(exc, match=match):
        GBM(ntrees=2, max_depth=2, **params).train(
            x=["x0", "x1"], y=y, training_frame=pf)


def test_cv_with_a_checkpoint_is_refused_by_name(frames):
    """Cross-validation with a checkpoint, refused by name until the port
    had a DKV, now resumes every fold from the checkpoint's key: passing
    the Model or its key gives the same bits (tests/test_torch_dkv_params.py
    holds it to the JAX package)."""
    _, _, pf = frames
    half = GBM(ntrees=2, max_depth=2).train(y="yb", training_frame=pf,
                                            x=["x0", "x1"])
    by_model, by_key = (GBM(ntrees=4, max_depth=2, nfolds=3,
                            keep_cross_validation_predictions=True,
                            checkpoint=cp).train(y="yb", training_frame=pf,
                                                 x=["x0", "x1"])
                        for cp in (half, half.key))
    assert torch.equal(by_model.cv_holdout_predictions,
                       by_key.cv_holdout_predictions)
    assert by_model.cross_validation_metrics.auc == \
        by_key.cross_validation_metrics.auc > 0.5


def _summary_close(pm, jm, rtol, floor=0.0):
    """The summaries alike at ``rtol``, with an absolute floor of ``floor``
    x the metric's mean (the fold values' sd is a difference of them)."""
    pn, pk, prow = pm.cv_metrics_summary
    jn, jk, jrow = jm.cv_metrics_summary
    assert pn == jn and pk == jk
    for a, b in zip(prow, jrow):
        assert a[0] == b[0]
        atol = max(1e-4 if a[0] in ("auc", "pr_auc") else 0.0,
                   floor * abs(b[1]))
        np.testing.assert_allclose(a[1:], b[1:], rtol=rtol, atol=atol,
                                   err_msg=a[0])


def _metrics_close(pmm, jmm, names, rtol):
    for m in names:
        a, b = getattr(pmm, m), getattr(jmm, m)
        if m in ("auc", "pr_auc"):
            assert abs(a - b) < 1e-4, (m, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=m)


CV_CASES = {
    "gbm_binomial": (GBM, JGBM, dict(TREES, nfolds=4), "yb",
                     ("auc", "logloss", "mse")),
    "gbm_gaussian": (GBM, JGBM, dict(TREES, nfolds=3), "yg",
                     ("mse", "mae", "r2")),
    "gbm_multinomial": (GBM, JGBM, dict(TREES, nfolds=3,
                                        fold_assignment="Stratified"), "ym",
                        ("logloss", "mse", "mean_per_class_error")),
    "glm_binomial": (GLM, JGLM, dict(family="binomial", nfolds=4,
                                     lambda_=1e-3), "yb",
                     ("auc", "logloss", "mse")),
    "gbm_fold_column": (GBM, JGBM, dict(TREES, fold_column="fnum"), "yb",
                        ("auc", "logloss")),
    "gbm_weights": (GBM, JGBM, dict(TREES, nfolds=3, weights_column="w"),
                    "yb", ("auc", "logloss")),
    "glm_skip": (GLM, JGLM, dict(family="binomial", nfolds=3,
                                 missing_values_handling="Skip"), "yb",
                 ("auc", "logloss")),
}


@pytest.mark.parametrize("case", list(CV_CASES))
def test_cv_metrics_and_oof_predictions_equal_the_reference(frames, case):
    P, J, params, y, names = CV_CASES[case]
    _, jf, pf = frames
    x = ["x0", "x1", "x2", "x3", "g"]
    kw = dict(params, keep_cross_validation_predictions=True)
    jm = J(**kw).train(x=x, y=y, training_frame=jf)
    pm = P(**kw).train(x=x, y=y, training_frame=pf)
    glm = P is GLM
    rtol = 1e-5 if glm else 1e-4
    _metrics_close(pm.cross_validation_metrics, jm.cross_validation_metrics,
                   names, rtol)
    _summary_close(pm, jm, rtol if glm else 1e-3)
    jp = np.asarray(jm.cv_holdout_predictions)[:N]
    pp = pm.cv_holdout_predictions.numpy()
    np.testing.assert_array_equal(pm.cv_holdout_mask.numpy(),
                                  np.asarray(jm.cv_holdout_mask)[:N])
    scale = max(1.0, float(np.abs(jp).max()))
    np.testing.assert_allclose(pp, jp, rtol=1e-5 if glm else 0.0,
                               atol=1e-6 * scale if glm else 1e-5 * scale)
    # the pooled metrics are those of the kept predictions
    mm = model_base.compute_metrics(
        pm.cv_holdout_predictions,
        *model_base.response_as_float(pf.vec(y))[:1], pm.cv_holdout_mask,
        pm.nclasses)
    for m in names:
        assert getattr(mm, m) == getattr(pm.cross_validation_metrics, m)


def test_random_folds_by_injected_reference_ids(frames, monkeypatch):
    _, jf, pf = frames
    kw = dict(TREES, nfolds=4, fold_assignment="Random", seed=21)
    jb = JGBM(**kw)
    jm = jb.train(x=["x0", "x1", "x2"], y="yb", training_frame=jf)
    jids = _jfolds(jb, jf, 4, "yb")
    monkeypatch.setattr(model_base, "random_folds",
                        lambda n, k, seed, dev: torch.as_tensor(jids.copy()))
    pm = GBM(**kw).train(x=["x0", "x1", "x2"], y="yb", training_frame=pf)
    _metrics_close(pm.cross_validation_metrics, jm.cross_validation_metrics,
                   ("auc", "logloss"), 1e-4)
    _summary_close(pm, jm, 1e-3)


def test_weights_plus_nfolds_compose(frames):
    """CV's holdout masks compose with user weights (both are weight
    masks), as tests/test_edge_cases.py's test_weights_plus_nfolds holds
    the reference to."""
    rng = np.random.default_rng(6)
    n = 320
    x = rng.normal(size=n).astype(np.float32)
    cols = {"x": x, "w": rng.integers(1, 4, n).astype(np.float32),
            "y": np.where(x > 0, "t", "f").astype(object)}
    kw = dict(ntrees=5, max_depth=3, seed=6, nfolds=3, weights_column="w")
    pm = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(cols))
    jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_arrays(cols))
    assert 0.5 < pm.cross_validation_metrics.auc <= 1.0
    assert abs(pm.cross_validation_metrics.auc
               - jm.cross_validation_metrics.auc) < 1e-4
    assert pm.cross_validation_metrics.nobs == jm.cross_validation_metrics.nobs


def test_the_main_model_is_the_model_without_cv(frames):
    """The fold fits leave the main fit alone: its trees and training
    metrics equal a GBM trained without CV, bit for bit; its scoring
    history is its own."""
    _, _, pf = frames
    kw = dict(TREES, stopping_rounds=2, score_tree_interval=1)
    plain = GBM(**kw).train(y="yb", training_frame=pf)
    cv = GBM(nfolds=3, **kw).train(y="yb", training_frame=pf)
    for a, b in zip(plain.output["trees"], cv.output["trees"]):
        for f in ("feat", "thresh_bin", "leaf", "is_split"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert cv.training_metrics.auc == plain.training_metrics.auc
    assert cv.training_metrics.logloss == plain.training_metrics.logloss
    assert cv.scoring_history[1] and \
        [r[2:] for r in cv.scoring_history[1]] == \
        [r[2:] for r in plain.scoring_history[1]]
    assert cv.cv_holdout_predictions is None
    assert cv.cv_metrics_summary[1] == 3


def test_folds_see_no_validation_frame(frames):
    """A validation frame is scored into the main model's metrics; the
    fold fits see none (as the reference's, which read it through a
    ``getattr`` on a fresh builder): the CV is that of a run without it."""
    _, _, pf = frames
    kw = dict(TREES, nfolds=3, stopping_rounds=2)
    with_vf = GBM(**kw).train(x=["x0", "x1"], y="yb", training_frame=pf,
                              validation_frame=Frame.from_arrays(
                                  cv_cols(256, seed=8)))
    without = GBM(**kw).train(x=["x0", "x1"], y="yb", training_frame=pf)
    assert with_vf.validation_metrics is not None
    for m in ("auc", "logloss", "mse"):
        assert getattr(with_vf.cross_validation_metrics, m) == \
            getattr(without.cross_validation_metrics, m)


OTHER_BUILDERS = {
    "drf": ("gbm", "DRF", dict(ntrees=10, max_depth=3, seed=1), "yb"),
    "xgboost_dart": ("xgboost", "XGBoost", dict(booster="dart", ntrees=3,
                                                max_depth=3, seed=1), "yg"),
    "xgboost_gbtree": ("xgboost", "XGBoost", dict(ntrees=3, max_depth=3),
                       "yb"),
    "decision_tree": ("decision_tree", "DecisionTree", dict(max_depth=3),
                      "yb"),
    "naive_bayes": ("naive_bayes", "NaiveBayes", dict(), "ym"),
    # one minibatch of every row: the epoch's row order no longer matters
    "deeplearning": ("deeplearning", "DeepLearning",
                     dict(hidden=[8], epochs=20, mini_batch_size=N, seed=1),
                     "yb"),
    "gam": ("gam", "GAM", dict(family="binomial", gam_columns=["x0"]), "yb"),
    "rulefit": ("rulefit", "RuleFit", dict(max_rule_length=2, seed=1), "yg"),
    "model_selection": ("model_selection", "ModelSelection",
                        dict(mode="maxr", max_predictor_number=2), "yg"),
    "anova_glm": ("model_selection", "ANOVAGLM", dict(), "yg"),
    # surrogate GBMs of CV_CASES' size
    "infogram": ("infogram", "Infogram", dict(algorithm_params=dict(
        ntrees=4, max_depth=3, nbins=16)), "yb"),
    "isotonic": ("isotonic", "IsotonicRegression", dict(), "yg"),
    "hglm": ("hglm", "HGLM", dict(random_columns=["x1"], group_column="g"),
             "yg"),
    "psvm": ("psvm", "PSVM", dict(), "yb"),
    "uplift_drf": ("uplift", "UpliftDRF", dict(treatment_column="treat",
                                               ntrees=3, max_depth=3), "yb"),
}
#: metrics held per response kind
CV_NAMES = {"yb": ("auc", "logloss", "mse"), "yg": ("mse", "mae", "r2"),
            "ym": ("logloss", "mse")}
#: (metrics and summary rtol, out-of-fold atol as a share of the largest
#: |prediction|) of builders whose fits the port repeats up to float32
#: sums in another order (DeepLearning with its initial weights injected
#: into both packages); RuleFit's level-1 L1 GLM is not unique
#: (tests/test_torch_rulefit.py): on this frame its training MSE differs
#: by 4.5e-4 relative, its folds' MSE by up to 7.3e-4 (their sd by 6.9e-4
#: absolute, held at 2e-3 of the mean) and its holdout predictions by up
#: to 2.9e-3 of the largest
SAME_AS_REFERENCE = dict.fromkeys(
    ("xgboost_dart", "xgboost_gbtree", "decision_tree", "naive_bayes",
     "deeplearning", "gam", "model_selection", "anova_glm", "infogram",
     "isotonic", "hglm"), (1e-4, 1e-5)) | {"rulefit": (2e-3, 5e-3)}


def _builder(pkg, mod, cls):
    import importlib
    return getattr(importlib.import_module(f"{pkg}.models.{mod}"), cls)


def _inject_dl_init(monkeypatch):
    """The same numpy-drawn initial weights in both packages' fits."""
    import jax.numpy as jnp
    import h2o3_tpu.models.deeplearning as jdl
    import h2o3_tpu_torch.models.deeplearning as pdl

    def weights(sizes):
        rng = np.random.default_rng(0)
        return ([rng.normal(scale=0.3, size=(a, b)).astype(np.float32)
                 for a, b in zip(sizes, sizes[1:])],
                [np.zeros(b, np.float32) for b in sizes[1:]])

    def jinit(self, key, sizes, act):
        W, b = weights(sizes)
        return {"W": [jnp.asarray(a) for a in W],
                "b": [jnp.asarray(a) for a in b]}

    def pinit(sizes, act, dist, scale, gen, device):
        W, b = weights(sizes)
        return ([torch.tensor(a).to(device) for a in W],
                [torch.tensor(a).to(device) for a in b])

    monkeypatch.setattr(jdl.DeepLearning, "_init_params", jinit)
    monkeypatch.setattr(pdl, "_init_params", pinit)


def check_builder_cv(frames, case, monkeypatch):
    """Each builder's CV against the JAX package's on the same frame: the
    CV metrics, the per-fold summary and the kept out-of-fold predictions
    at SAME_AS_REFERENCE's tolerances. DRF and PSVM fit otherwise in each
    package and are held by metric (test_random_builders_cross_validate_
    like_the_reference); here their CV is checked for its shape. The
    cases of ``test_every_supervised_builder_cross_validates`` run in
    tests/test_torch_cv_trees.py, tests/test_torch_cv_linear.py and
    tests/test_torch_cv_rulefit.py, so that pytest-xdist's ``--dist
    loadfile`` spreads them over its workers."""
    mod, cls, params, y = OTHER_BUILDERS[case]
    cols, jf, pf = frames
    x = ["x0"] if case == "isotonic" else ["x0", "x1"]
    kw = dict(nfolds=3, keep_cross_validation_predictions=True, **params)
    if case == "uplift_drf":
        cols = dict(cols, treat=np.where(cols["w"] > 1, "treatment",
                                         "control"))
        with pytest.raises(NotImplementedError, match="cross-validate"):
            _builder("h2o3_tpu_torch", mod, cls)(**kw).train(
                x=x, y=y, training_frame=Frame.from_arrays(cols))
        # the reference fails on the uplifts too
        with pytest.raises(IndexError):
            _builder("h2o3_tpu", mod, cls)(**kw).train(
                x=x, y=y, training_frame=JFrame.from_arrays(cols))
        return
    if case == "deeplearning":
        _inject_dl_init(monkeypatch)
    m = _builder("h2o3_tpu_torch", mod, cls)(**kw).train(
        x=x, y=y, training_frame=pf)
    mm = m.cross_validation_metrics
    assert mm is not None and bool(m.cv_holdout_mask.all())
    assert m.cv_metrics_summary[1] == 3 and m.cv_metrics_summary[0]
    if case not in SAME_AS_REFERENCE:
        return
    rtol, oof_atol = SAME_AS_REFERENCE[case]
    jm = _builder("h2o3_tpu", mod, cls)(**kw).train(
        x=x, y=y, training_frame=jf)
    _metrics_close(mm, jm.cross_validation_metrics, CV_NAMES[y], rtol)
    _summary_close(m, jm, rtol, floor=rtol if case == "rulefit" else 0.0)
    jp = np.asarray(jm.cv_holdout_predictions)[:N]
    pp = m.cv_holdout_predictions.numpy()
    np.testing.assert_allclose(
        pp, jp, rtol=0.0, atol=oof_atol * float(np.nanmax(np.abs(jp))))


#: (seeds, the metric's mean over them: its tolerance) of builders whose
#: fits draw from each package's own stream or are chaotic
BY_METRIC = {
    # the bootstrap draws: tests/test_torch_drf.py's tolerances for
    # forests (AUC within 0.015, MSE within 5%); measured 0.0022 and 0.65%
    "drf": ("seed", (1, 2, 3)),
    # held to per-fold fits on the kept rows alone, not to the reference:
    # the port gathers a fold's holdout rows out of the fit, where the JAX
    # package keeps them in at a box of C = 1e-12 (its CV AUC 0.22-0.23).
    # The per-fold fits standardise by their own rows, the CV fits by the
    # whole frame's: over the three frames the CV AUCs differ from theirs
    # by at most 0.0085 and the holdout decisions' signs agree on 97.5% of
    # rows or more
    "psvm": ("frame", (3, 4, 5)),
}


def _kept_rows_holdout(mod, cls, params, y, cols) -> np.ndarray:
    """p1 of each row from a fit on the other Modulo folds' rows alone
    (a frame of those rows), 3 folds."""
    folds = np.arange(N) % 3
    out = np.zeros(N)
    for k in range(3):
        part = lambda m: Frame.from_arrays({c: np.asarray(v)[m]
                                            for c, v in cols.items()})
        fm = _builder("h2o3_tpu_torch", mod, cls)(**params).train(
            x=["x0", "x1"], y=y, training_frame=part(folds != k))
        out[folds == k] = fm._score_raw(part(folds == k))[:, 1].numpy()
    return out


def _auc(p: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    npos = int(y.sum())
    return (ranks[y].sum() - npos * (npos + 1) / 2) / (npos * (len(p) - npos))


def check_random_builder_cv(case):
    """DRF and PSVM, whose fits draw from each package's own stream or are
    chaotic, held to the reference by metric (``BY_METRIC``); their cases
    of ``test_random_builders_cross_validate_like_the_reference`` run in
    tests/test_torch_cv_trees.py."""
    mod, cls, params, y = OTHER_BUILDERS[case]
    what, seeds = BY_METRIC[case]
    kw = dict(nfolds=3, keep_cross_validation_predictions=True, **params)
    got, ref = [], []
    for s in seeds:
        cols = cv_cols(seed=s if what == "frame" else 3)
        if what == "seed":
            kw["seed"] = s
        pm = _builder("h2o3_tpu_torch", mod, cls)(**kw).train(
            x=["x0", "x1"], y=y, training_frame=Frame.from_arrays(cols))
        got.append((pm.cross_validation_metrics.auc,
                    pm.cross_validation_metrics.mse))
        if case == "psvm":
            kept = _kept_rows_holdout(mod, cls, params, y, cols)
            pp = pm.cv_holdout_predictions.numpy()[:, 1]
            assert np.mean((kept > 0.5) == (pp > 0.5)) >= 0.95, s
            ref.append((_auc(kept, np.asarray(cols[y]) == "yes"), np.nan))
            continue
        jm = _builder("h2o3_tpu", mod, cls)(**kw).train(
            x=["x0", "x1"], y=y, training_frame=JFrame.from_arrays(cols))
        ref.append((jm.cross_validation_metrics.auc,
                    jm.cross_validation_metrics.mse))
    got, ref = np.array(got), np.array(ref)
    if case == "drf":
        assert abs(got[:, 0].mean() - ref[:, 0].mean()) < 0.015
        np.testing.assert_allclose(got[:, 1].mean(), ref[:, 1].mean(),
                                   rtol=0.05)
    else:
        assert np.abs(got[:, 0] - ref[:, 0]).max() < 0.02
