"""The port's multi-process cloud on the CPU: one 2-rank gloo cloud of
``python -m h2o3_tpu_torch.launch --fork 2 --device cpu --serve``, started
once for the module, runs tests/scripts/torch_multiproc_train.py (the JAX
package's tests/scripts/multiproc_train.py scenario: 400 rows, 4 columns,
GBM of 3 trees, depth 3, 16 bins, seed 2; GLM binomial at lambda 1e-3;
split_frame, sort and fetch) while rank 0 serves REST.

Held, with the tolerances stated:

- the two ranks agree bit for bit (trees, predictions, metrics, GLM);
- their GBM trees and predictions equal a one-rank fit in this process bit
  for bit: every level's histograms and node totals are integer sums at
  the scale one rank would pick (``ops/hist.py:mesh_level_histograms``),
  and the one-rank fit takes the same plain fixed path
  (``fixed_point_on_cpu``), since the CPU path otherwise sums floats;
- their GBM holds the JAX package's single-process 8-device fit to
  tests/test_multiprocess.py's tolerance (training logloss within 1e-5;
  that test holds the 8-device fit equal to its multi-process fit);
- their GLM holds the JAX fit to tests/test_torch_glm.py's
  ``assert_same_fit`` tolerances (iterations equal, deviance rtol 1e-5,
  coefficients rtol 1e-4 with an atol of 1e-5 of the largest, predictions
  rtol 1e-5);
- ``/3/Cloud`` from rank 0 counts two ranks and a node row each;
- operations that are not rank-aware raise ``MeshUnsupported`` by name.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBM
from h2o3_tpu_torch.ops import hist as H
from jax_reference import _jax_compile_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "scripts", "torch_multiproc_train.py")
GBM_PARAMS = dict(ntrees=3, max_depth=3, nbins=16, seed=2)
GLM_PARAMS = dict(family="binomial", lambda_=1e-3, seed=2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def _cols():
    """tests/scripts/multiproc_train.py's frame."""
    rng = np.random.default_rng(9)
    n = 400
    cols = {f"x{i}": rng.normal(size=n).astype(np.float32) for i in range(4)}
    cols["y"] = np.array(["no", "yes"], dtype=object)[
        (rng.random(n) < 1 / (1 + np.exp(-2 * cols["x0"]))).astype(int)]
    return cols


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """The two ranks' results and rank 0's ``/3/Cloud``, from one cloud."""
    out = tmp_path_factory.mktemp("cloud")
    rest = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "launch.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "h2o3_tpu_torch.launch", "--fork", "2",
             "--device", "cpu", "--port", str(_free_port()), "--serve",
             "--rest-port", str(rest), SCRIPT, str(out)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 240
            paths = [out / f"rank{r}.json" for r in range(2)]
            while not all(p.exists() for p in paths):
                assert proc.poll() is None, (out / "launch.log").read_text()
                assert time.time() < deadline, "the cloud did not finish"
                time.sleep(0.1)
            ranks = [json.loads(p.read_text()) for p in paths]
            with urllib.request.urlopen(
                    f"http://localhost:{rest}/3/Cloud", timeout=30) as r:
                cloud_json = json.loads(r.read())
        finally:
            proc.terminate()
            proc.wait(timeout=60)
    return ranks, cloud_json


@pytest.fixture(scope="module")
def one_rank():
    """The GBM of one rank on the plain fixed path, in this process."""
    with H.fixed_point_on_cpu():
        m = GBM(**GBM_PARAMS).train(y="y", training_frame=Frame.from_arrays(
            _cols()))
    trees = [{f: getattr(t, f).tolist() for f in
              ("feat", "thresh_bin", "thresh_val", "na_left", "is_split",
               "leaf")} for t in m.output["trees"]]
    pred = m.predict(Frame.from_arrays(_cols())).vec("pyes").data.numpy()
    return m, trees, [float(p) for p in pred]


def test_ranks_agree_bit_for_bit(cloud):
    r0, r1 = cloud[0]
    assert r0["world"] == r1["world"] == 2 and r0["backend"] == "gloo"
    assert r0["block"] == [0, 200] and r1["block"] == [200, 400]
    for k in ("trees", "pred", "gbm_logloss", "gbm_auc", "f0", "glm_logloss",
              "glm_coef", "glm_beta", "glm_deviance", "glm_pred",
              "effective_nobs"):
        assert r0[k] == r1[k], k
    assert r0["effective_nobs"] == 400


def test_gbm_equals_a_one_rank_fit_bit_for_bit(cloud, one_rank):
    m, trees, pred = one_rank
    for r in cloud[0]:
        assert r["trees"] == trees
        assert r["pred"] == pred
        assert r["f0"] == float(m.output["f0"])
        # the metrics' float32 sums change order with the rank count
        np.testing.assert_allclose(r["gbm_logloss"],
                                   m.training_metrics.logloss, rtol=1e-6)
        np.testing.assert_allclose(r["gbm_auc"], m.training_metrics.auc,
                                   rtol=1e-6)


def test_collectives_are_the_planned_ones(cloud):
    # two all_reduces a level (counts, accumulator), two for the node
    # totals: 3 trees of depth 3
    for r in cloud[0]:
        assert r["hist_reduces"] == [3 * 3 * 2, 3 * 2]


def test_gbm_holds_the_reference_8_device_fit(cloud):
    jm = JGBM(**GBM_PARAMS).train(y="y",
                                  training_frame=JFrame.from_arrays(_cols()))
    for r in cloud[0]:
        assert r["gbm_logloss"] == pytest.approx(
            float(jm.training_metrics.logloss), abs=1e-5)


def test_glm_holds_the_reference_fit(cloud):
    jf = JFrame.from_arrays(_cols())
    jm = JGLM(**GLM_PARAMS).train(y="y", training_frame=jf)
    jbeta = np.asarray(jm.output["beta"])
    jcoef = np.asarray(jm.output["coef"])
    jp = np.asarray(jm._score_raw(jf))[:400, 1]
    for r in cloud[0]:
        assert r["glm_iterations"] == jm.output["iterations"]
        np.testing.assert_allclose(r["glm_deviance"],
                                   jm.output["residual_deviance"], rtol=1e-5)
        np.testing.assert_allclose(r["glm_beta"], jbeta, rtol=1e-4,
                                   atol=1e-5 * np.abs(jbeta).max())
        np.testing.assert_allclose(r["glm_coef"], jcoef, rtol=1e-4,
                                   atol=1e-5 * np.abs(jcoef).max())
        np.testing.assert_allclose(r["glm_pred"], jp, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(jp).max()))


def test_cloud_route_counts_the_ranks(cloud):
    c = cloud[1]
    assert c["cloud_size"] == 2 and len(c["nodes"]) == 2
    assert [n["h2o"].split(":")[0] for n in c["nodes"]] == ["rank 0",
                                                            "rank 1"]
    assert c["workers"] == [] and c["cloud_healthy"]


@pytest.mark.parametrize("op", ["group_by", "vec_arithmetic", "drf",
                                "kmeans", "gbm_nfolds", "xgboost_dart"])
def test_operations_not_rank_aware_raise_by_name(cloud, op):
    for r in cloud[0]:
        msg = r["refused"][op]
        assert msg is not None and "not rank-aware" in msg
        assert "2 ranks" in msg
