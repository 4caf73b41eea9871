"""AutoML in the port (``h2o3_tpu_torch/orchestration/automl.py``) against
the JAX package's (``h2o3_tpu/orchestration/automl.py``).

The plan (``_steps``, ``_grids``, ``modeling_steps``) is compared entry
by entry. The budget's decisions (the exploitation reserve, the grids
reached and their model ids, the annealed step's parameters, the
ensembles built, the event log) are compared with every build replaced,
in both packages alike, by a stub that returns a model with metrics drawn
from its parameters (no fit: the decisions depend only on the count of
models, their ranks and the clock), for max_models 3, 5 and 10 and for a
``max_runtime_secs`` stop on a patched clock. Then one small AutoML run
in each package, at tests/test_orchestration.py's test_automl_small size
(832 rows, a multiple of 64, so no pad rows): the same leaderboard
membership and order by algo (AutoML's step models have uuid keys, so
they are compared by plan position and algo), the GLM's CV AUC within
1e-4 (no sampling), the GBM's and the ensembles' CV AUC within 0.03 (the
GBM step samples rows and columns at 0.8 from each package's own
generator).
"""

import hashlib
import re
import time
import types

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import model_base as jbase
from h2o3_tpu.orchestration.automl import AutoML as JAutoML
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import model_base as pbase
from h2o3_tpu_torch.orchestration.automl import AutoML
from h2o3_tpu_torch.utils.registry import DKV

N = 832


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


def binom_cols(n=N, seed=0):
    """tests/test_orchestration.py's _binom_frame."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    logits = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(int)
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = np.array(["yes" if v else "no" for v in y], dtype=object)
    return cols


# -- the plan ---------------------------------------------------------------

def _plan(aml):
    return ([(a, c.__name__, p) for a, c, p in aml._steps()],
            [(a, c.__name__, f, h, s) for a, c, f, h, s in aml._grids()],
            aml.modeling_steps())


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=7), dict(exclude_algos=["DRF", "deeplearning"]),
    dict(include_algos=["GBM", "StackedEnsemble"]),
    dict(include_algos=["XGBOOST"])])
def test_the_plan_equals_the_reference(kw):
    assert _plan(AutoML(max_models=5, **kw)) == \
        _plan(JAutoML(max_models=5, **kw))


# -- the budget, with stub builds ---------------------------------------------

class _Metrics(types.SimpleNamespace):
    pass


#: the parameters AutoML sets (each builder's defaults differ between the
#: packages, and are not the plan)
PLAN_KEYS = ("ntrees", "max_depth", "learn_rate", "sample_rate",
             "col_sample_rate", "col_sample_rate_per_tree", "reg_lambda",
             "lambda_", "alpha", "hidden", "epochs", "mini_batch_size",
             "nfolds", "seed", "keep_cross_validation_predictions",
             "model_id", "metalearner_algorithm")


def _plan_params(params):
    return {k: params[k] for k in PLAN_KEYS if k in params}


def _stub_train(calls):
    """A ``ModelBuilder.train`` that fits nothing: a model of the builder's
    algo and parameters, with its key (``model_id``, else one from the
    hash of its algo and plan parameters, so it does not depend on which
    of two overlapped builds came first) and metrics drawn from that hash;
    each call advances ``calls``' clock."""
    def train(self, x=None, y=None, training_frame=None, **kw):
        if self.algo == "stackedensemble" and any(
                m.cv_holdout_predictions is None
                for m in self.params["base_models"]):
            raise ValueError("all base models need CV predictions")
        calls["n"] += 1
        calls["clock"] += calls["step"]
        params = _plan_params(self.params)
        params.pop("model_id", None)
        h = int(hashlib.md5(repr((self.algo, params)).encode())
                .hexdigest()[:6], 16)
        auc = 0.6 + (h % 3000) / 1e4
        mm = _Metrics(auc=auc, logloss=1.0 - auc, rmse=0.5 - auc / 4,
                      mse=(0.5 - auc / 4) ** 2)
        key = self.params.get("model_id") or f"{self.algo}_{h:06x}"
        return types.SimpleNamespace(
            key=key, algo=self.algo, params=dict(self.params),
            response_column=y, nclasses=2, run_time_ms=calls["n"],
            cross_validation_metrics=mm, validation_metrics=None,
            training_metrics=mm, preprocessors=[],
            cv_holdout_predictions=(np.zeros(1) if self.params.get(
                "keep_cross_validation_predictions") else None),
            output=dict(metalearner=types.SimpleNamespace(
                training_metrics=mm)))
    return train


def _run_stubbed(monkeypatch, cls, mod, frame, step=0.0, **kw):
    calls = dict(n=0, clock=1000.0, step=step)
    monkeypatch.setattr(mod.ModelBuilder, "train", _stub_train(calls))
    monkeypatch.setattr(time, "time", lambda: calls["clock"])
    aml = cls(project_name="p", seed=1, **kw)
    aml.train(y="y", training_frame=frame)
    monkeypatch.undo()
    events = [(stage, re.sub(r" in [0-9.]+s", "", msg), name,
               value if name not in ("duration_secs",) else "")
              for _, _lvl, stage, msg, name, value in aml.event_log.events]
    board = [(r["model_id"], r["algo"]) for r in aml.leaderboard._sorted()]
    params = [_plan_params(m.params) for m in aml.leaderboard.models]
    return events, board, params, calls["n"]


@pytest.mark.parametrize("kw", [
    dict(max_models=3), dict(max_models=5), dict(max_models=10),
    dict(max_models=10, parallelism=1),
    dict(max_models=5, exploitation_ratio=0.0),
    dict(max_models=6, include_algos=["GBM", "XGBoost", "StackedEnsemble"]),
    dict(max_models=14),
])
def test_budget_decisions_match_the_reference(monkeypatch, kw):
    cols = binom_cols(64)
    got = _run_stubbed(monkeypatch, AutoML, pbase, Frame.from_arrays(cols),
                       **kw)
    want = _run_stubbed(monkeypatch, JAutoML, jbase,
                        JFrame.from_arrays(cols), **kw)
    assert got == want
    stages = [e[0] for e in got[0]]
    # the reserve is left for the annealed GBM from 5 models up; at 14 the
    # grid's budget (max_models less the models built) takes it
    assert ("exploit" in stages) == (
        kw["max_models"] in (5, 6, 10)
        and kw.get("exploitation_ratio", 0.1) > 0)


@pytest.mark.parametrize("secs", [250.0, 1150.0])
def test_a_runtime_stop_matches_the_reference(monkeypatch, secs):
    """No model budget, a runtime budget, and a clock that advances 100 s
    a build: both packages stop at the same build."""
    cols = binom_cols(64)
    kw = dict(max_runtime_secs=secs, parallelism=1, step=100.0)
    got = _run_stubbed(monkeypatch, AutoML, pbase, Frame.from_arrays(cols),
                       **kw)
    want = _run_stubbed(monkeypatch, JAutoML, jbase,
                        JFrame.from_arrays(cols), **kw)
    assert got == want and 0 < got[3] < 30


# -- one small run in each package -------------------------------------------

def test_a_small_automl_matches_the_reference():
    cols = binom_cols()
    kw = dict(max_models=2, nfolds=3, seed=1,
              include_algos=["GLM", "GBM", "STACKEDENSEMBLE"])
    jaml = JAutoML(**kw)
    jaml.train(y="y", training_frame=JFrame.from_arrays(cols))
    paml = AutoML(**kw)
    paml.train(y="y", training_frame=Frame.from_arrays(cols))
    jrows, prows = jaml.leaderboard._sorted(), paml.leaderboard._sorted()
    assert [r["algo"] for r in prows] == [r["algo"] for r in jrows] == \
        ["stackedensemble", "stackedensemble", "glm", "gbm"]
    assert sorted(r["model_id"] for r in prows
                  if r["algo"] == "stackedensemble") == \
        ["StackedEnsemble_AllModels_" + paml.project_name,
         "StackedEnsemble_BestOfFamily_" + paml.project_name]
    for pr, jr in zip(prows, jrows):
        tol = 1e-4 if pr["algo"] == "glm" else 0.03
        assert abs(pr["auc"] - jr["auc"]) < tol, (pr, jr)
        assert abs(pr["logloss"] - jr["logloss"]) < 10 * tol
    # the plan position of each step model: GLM, then GBM def_1
    assert [m.algo for m in paml.leaderboard.models
            if m.algo != "stackedensemble"] == ["glm", "gbm"]
    gbm = next(m for m in paml.leaderboard.models if m.algo == "gbm")
    assert gbm.params["max_depth"] == 6 and gbm.params["sample_rate"] == 0.8
    assert paml.leader.algo == jaml.leader.algo == "stackedensemble"
    stages = [e[2] for e in paml.event_log.events]
    assert stages.count("model") == 4 and "error" not in stages
