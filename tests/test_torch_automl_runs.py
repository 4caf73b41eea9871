"""AutoML runs of the port (``h2o3_tpu_torch/orchestration/automl.py``):
target encoding and the lr-annealed exploitation step at
tests/test_orchestration.py's test_automl_exploitation_and_te settings,
held against the JAX package's AutoML on the same frame, with the tree
models scoring through their encoder. The port's run repeated bit for bit
at parallelism 1 and 2 is in tests/test_torch_automl_bits.py.

Tolerances of the target-encoding run: the encoded column at rtol 1e-6
(KFold folds are Modulo in both packages, so both divide the same float32
sums; the blend's ``exp`` may differ by an ulp), the event log, the
models' x columns, their plan parameters and the leaderboard's algos
exactly, and each model's training AUC and logloss within 0.03 of the
reference's model at the same plan position (the GBM steps sample rows
and columns at 0.8 from each package's own generator). The reference's
run is the file's one JAX AutoML run, about 70 s of the file's 95 s
alone on a CPU, most of it the JAX package's per-tree dispatch."""

import re

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.orchestration.automl import AutoML as JAutoML
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.orchestration.automl import AutoML
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


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


def te_cols(n=512, seed=5):
    """test_automl_exploitation_and_te's frame: a 30-level city and x1."""
    rng = np.random.default_rng(seed)
    levels = [f"city{i:02d}" for i in range(30)]
    city = rng.choice(levels, size=n)
    effect = {lv: rng.normal() for lv in levels}
    x1 = rng.normal(size=n).astype(np.float32)
    logit = np.array([effect[c] for c in city]) + x1
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    return {"city": city, "x1": x1,
            "y": np.array(["no", "yes"], dtype=object)[y.astype(int)]}


#: the parameters AutoML's plan sets on a GBM step
PLAN_KEYS = ("ntrees", "max_depth", "learn_rate", "sample_rate",
             "col_sample_rate", "col_sample_rate_per_tree", "nfolds",
             "seed")


def _events(aml):
    """The event log without its clock: model keys (uuids in both
    packages), build seconds and epoch values are cut out."""
    out = []
    for _, lvl, stage, msg, name, value in aml.event_log.events:
        msg = re.sub(r"\b[a-z]+_[0-9a-f]{10}\b", "<key>", msg)
        msg = re.sub(r" in [0-9.]+s", "", msg)
        out.append((lvl, stage, msg, name, "" if name else value))
    return out


def _by_plan(aml):
    """Step models keyed by their plan parameters (the build order of
    overlapped builds and the ranks may differ between packages)."""
    return {tuple(m.params.get(k) for k in PLAN_KEYS): m
            for m in aml.leaderboard.models}


def test_target_encoding_and_exploitation():
    cols = te_cols()
    # parallelism 1 (the reference's settings run 2): one build at a time
    # compiles each of the JAX package's plan programs once, on one mesh;
    # the port's plan, models and leaderboard are the same bits at 1 and 2
    # (tests/test_torch_automl_bits.py)
    kw = dict(max_models=5, nfolds=0, seed=7, project_name="te",
              include_algos=["GBM", "STACKEDENSEMBLE"],
              preprocessing=["target_encoding"], exploitation_ratio=0.2,
              parallelism=1)
    jaml = JAutoML(**kw)
    jaml.train(y="y", training_frame=JFrame.from_arrays(cols))
    fr = Frame.from_arrays(cols)
    aml = AutoML(**kw)
    leader = aml.train(y="y", training_frame=fr)
    events = " ".join(aml.event_log.as_list())
    assert "target-encoded ['city'] for tree steps" in events
    assert "lr-annealed gbm" in events and "error" not in events
    assert _events(aml) == _events(jaml)
    models = aml.leaderboard.models
    assert len(models) == 5 and leader is models[0]
    assert sorted(r["algo"] for r in aml.leaderboard._sorted()) == \
        sorted(r["algo"] for r in jaml.leaderboard._sorted()) == ["gbm"] * 5
    annealed = [m for m in models if m.params["ntrees"] == 100]
    assert len(annealed) == 1 and annealed[0].params["learn_rate"] == 0.05
    got, want = _by_plan(aml), _by_plan(jaml)
    assert sorted(got) == sorted(want) and len(got) == 5
    # the encoder both packages fit: the same encoded column
    jte, = want[next(iter(want))].preprocessors
    jenc = np.asarray(jte.transform(JFrame.from_arrays(cols))
                      .vec("city_te").data)[:fr.nrows]
    for plan, m in got.items():
        jm = want[plan]
        assert m.output["x_cols"] == jm.output["x_cols"] == ["x1", "city_te"]
        pm, jmm = m.training_metrics, jm.training_metrics
        assert abs(pm.auc - jmm.auc) < 0.03, (plan, pm.auc, jmm.auc)
        assert abs(pm.logloss - jmm.logloss) < 0.03, plan
        te, = m.preprocessors
        enc = te.transform(fr)
        np.testing.assert_allclose(enc.vec("city_te").data.numpy(), jenc,
                                   rtol=1e-6)
        # the raw frame scores through the encoder, as the encoded one
        raw = m.predict(fr)
        assert torch.equal(raw.vec("pyes").data,
                           m.predict(enc).vec("pyes").data)
