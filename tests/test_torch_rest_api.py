"""The port's REST server and client (``h2o3_tpu_torch/api/``) on the CPU:
the scenarios of ``tests/test_rest_api.py``, ``test_rest_errors.py``,
``test_flow.py`` and ``test_ldap_auth.py`` on the port's ``H2OServer``.

- Round trips: cloud, import, upload, train + poll + predict, coerced GLM
  parameters, Rapids, grids, the model payload's variable importances,
  the Flow page, jobs and their cancellation.
- Errors come back as structured ``H2OErrorV3`` JSON: 404 for unknown keys
  and routes, 400 for requests no build can satisfy, 413 for oversized
  bodies, and the server keeps serving.
- The routes of the observability and ops slice are served; both
  servers' answers on them are compared in ``test_torch_rest_parity.py``.
- Auth: Basic, form login with a session cookie, logout, and an LDAP
  simple bind (the reference's fake LDAP server), as the reference's.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.api import H2OClient, H2OServer
from h2o3_tpu_torch.api import server as pserver
from h2o3_tpu_torch.frame.frame import Frame
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


@pytest.fixture(scope="module")
def server(_cpu_port):
    s = H2OServer(port=0).start()   # ephemeral port, one for the module
    yield s
    s.stop()


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


@pytest.fixture
def client(server):
    return H2OClient(server.url)


@pytest.fixture
def bin_frame(rng):
    n = 400
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0)
    f = Frame.from_arrays({
        "a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
        "y": np.array(["yes" if t else "no" for t in y], dtype=object)},
        key="train_frame")
    DKV.put("train_frame", f)
    return f


def _err(server, path, body=None, method="POST"):
    data = urllib.parse.urlencode(body).encode() if body is not None else b""
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"{server.url}{path}", data=data if method == "POST" else None,
            method=method))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def test_cloud(client):
    st = client.cloud_status()
    assert st["cloud_healthy"] and st["cloud_size"] >= 1
    assert st["__meta"]["schema_type"] == "CloudV3"
    assert st["nodes"][0]["h2o"] == "cpu" and st["workers"] == []


def test_import_and_frames(client, tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("x,y\n1,2\n3,4\n5,6\n")
    key = client.import_file(str(p))
    fr = client.frame(key)
    assert fr["rows"] == 3 and fr["column_count"] == 2
    cols = {c["label"]: c for c in fr["columns"]}
    assert cols["x"]["mean"] == pytest.approx(3.0)
    assert cols["x"]["histogram_bins"] and \
        sum(cols["x"]["histogram_bins"]) == 3
    assert any(f["frame_id"]["name"] == key for f in client.frames())
    client.rm(key)
    with pytest.raises(RuntimeError, match="404"):
        client.frame(key)


def test_train_poll_predict(client, bin_frame):
    model = client.train("gbm", "train_frame", y="y", ntrees=5, max_depth=3)
    assert model["algo"] == "gbm"
    auc = model["output"]["training_metrics"]["auc"]
    assert auc > 0.8
    key = model["model_id"]["name"]
    pred_key = client.predict(key, "train_frame")
    pf = DKV[pred_key]
    assert pf.nrows == bin_frame.nrows
    assert "predict" in pf.names
    # the REST model is the one a direct fit of the same params gives
    from h2o3_tpu_torch.models.gbm import GBM
    direct = GBM(ntrees=5, max_depth=3).train(y="y", training_frame=bin_frame)
    assert np.array_equal(pf.vec("pyes").to_numpy(),
                          direct.predict(bin_frame).vec("pyes").to_numpy())


def test_train_glm_params_coerced(client, bin_frame):
    model = client.train("glm", "train_frame", y="y", family="binomial",
                         lambda_=0.0, max_iterations=20)
    assert model["output"]["training_metrics"]["auc"] > 0.9
    pars = {p["name"]: p["actual_value"] for p in model["parameters"]}
    assert pars["family"] == "binomial"
    assert pars["max_iterations"] == 20


def test_rapids_endpoint(client, bin_frame):
    out = client.rapids("(sum (cols train_frame 'a'))")
    ref = float(np.nansum(bin_frame.vec("a").to_numpy()))
    assert out["scalar"] == pytest.approx(ref, rel=1e-4)
    out = client.rapids("(+ (cols train_frame 'a') 1)", id="shifted")
    assert out["key"]["name"] == "shifted"
    assert DKV["shifted"].nrows == bin_frame.nrows


def test_grid_endpoint(client, bin_frame):
    g = client.grid("gbm", "train_frame", "y",
                    hyper_parameters={"max_depth": [2, 3]}, ntrees=3)
    assert len(g["model_ids"]) == 2


def test_unknown_route_and_algo(client, bin_frame):
    with pytest.raises(RuntimeError, match="404"):
        client.request("GET", "/3/NoSuchThing")
    with pytest.raises(RuntimeError, match="unknown algorithm"):
        client.train("levenshtein", "train_frame", y="y")


def test_error_does_not_kill_server(client, bin_frame):
    with pytest.raises(RuntimeError):
        client.train("glm", "train_frame", y="nope")
    assert client.cloud_status()["cloud_healthy"]


def test_a_failed_build_is_a_failed_job_with_its_reason(client, bin_frame):
    out = client.request("POST", "/3/ModelBuilders/gbm",
                         {"training_frame": "train_frame",
                          "response_column": "y", "checkpoint": "no_model",
                          "ntrees": 2})
    with pytest.raises(RuntimeError, match="checkpoint model 'no_model'"):
        client._poll(out["job"]["key"]["name"], poll_secs=0.02)
    job = client.job(out["job"]["key"]["name"])
    assert job["status"] == "FAILED" and "no_model" in job["exception"]


def test_flow_ui_served(server):
    with urllib.request.urlopen(server.url + "/") as r:
        body = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/html")
    assert "h2o3-tpu Flow" in body and "/3/Cloud" in body
    from h2o3_tpu.api.flow import FLOW_HTML
    assert body == FLOW_HTML
    with urllib.request.urlopen(server.url + "/flow/index.html") as r:
        assert r.status == 200
    for marker in ("assist", "runCell", "buildModel", "plot varimp",
                   "svgLine", "svgBar", "getFrameSummary",
                   "NodePersistentStorage/notebook", "shift+enter"):
        assert marker in body, marker


def test_client_upload_file(client, tmp_path):
    p = tmp_path / "up.csv"
    p.write_text("x,y\n1,2\n3,4\n5,6\n")
    key = client.upload_file(str(p), destination_frame="uploaded_fr")
    fr = client.frame(key)
    assert key == "uploaded_fr" and fr["rows"] == 3


def test_model_payload_variable_importances(client, bin_frame):
    out = client.train("gbm", "train_frame", y="y", ntrees=3, max_depth=3)
    vi = out["output"].get("variable_importances")
    assert vi is not None
    names = [c["name"] for c in vi["columns"]]
    assert names == ["variable", "relative_importance", "scaled_importance",
                     "percentage"]
    assert vi["rowcount"] >= 1


# -- the error surface (tests/test_rest_errors.py) -----------------------------

def test_malformed_rapids_is_structured_error(server):
    for ast in ["(unknown_op 1 2)", "(((", "(cols_py missing_frame 0)", ""]:
        code, body = _err(server, "/99/Rapids", {"ast": ast})
        assert code in (400, 404, 500), (ast, code)
        assert body["__meta"]["schema_type"] == "H2OErrorV3"
        assert body["msg"]
    with urllib.request.urlopen(f"{server.url}/3/Cloud") as r:
        assert r.status == 200


@pytest.mark.parametrize("path", ["/3/Frames/nope", "/3/Models/nope",
                                  "/3/Jobs/nope", "/99/AutoML/nope",
                                  "/99/Leaderboards/nope"])
def test_unknown_keys_are_404(server, path):
    code, body = _err(server, path, method="GET")
    assert code == 404, (path, code)
    assert body["__meta"]["schema_type"] == "H2OErrorV3"


def test_oversized_param_body_rejected(server, monkeypatch):
    monkeypatch.setattr(pserver._Handler, "MAX_PARAM_BODY", 1 << 20)
    big = b"x" * ((1 << 20) + 1024)
    req = urllib.request.Request(f"{server.url}/99/Rapids", data=big)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 413
    assert "cap" in json.loads(ei.value.read())["msg"]
    with urllib.request.urlopen(f"{server.url}/3/Cloud") as r:
        assert r.status == 200


def test_concurrent_job_cancellation(server, rng):
    n = 4000
    X = rng.normal(size=(n, 3)).astype(np.float32)
    fr = Frame.from_arrays({
        "a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
        "y": np.where(X[:, 0] > 0, "p", "n").astype(object)},
        key="cancel_fr")
    DKV.put("cancel_fr", fr)
    c = H2OClient(server.url)
    out = c.request("POST", "/3/ModelBuilders/gbm",
                    {"training_frame": "cancel_fr", "response_column": "y",
                     "ntrees": 200, "max_depth": 5})
    job_key = out["job"]["key"]["name"]
    errs = []

    def cancel():
        try:
            c.request("POST", f"/3/Jobs/{job_key}/cancel", {})
        except Exception as e:   # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=cancel) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs, errs
    for _ in range(600):
        st = c.job(job_key)["status"]
        if st in ("CANCELLED", "DONE", "FAILED"):
            break
        time.sleep(0.05)
    assert st in ("CANCELLED", "DONE")   # DONE if it outran the cancel
    c.request("POST", f"/3/Jobs/{job_key}/cancel", {})
    assert c.cloud_status()["cloud_healthy"]


def test_memory_and_logs_are_served(client):
    import logging
    logging.getLogger("h2o3_tpu_torch").warning("a line for the ring")
    mem = client.memory()
    assert {"host", "dkv", "watermarks"} <= set(mem)
    assert "a line for the ring" in client.logs(name="warn")
    assert "a line for the ring" in client.request("GET", "/3/Logs")["log"]
    with pytest.raises(RuntimeError, match="404"):
        client.request("GET", "/3/Logs/nodes/0/files/nolevel")


def test_network_test_times_the_device(client):
    out = client.request("GET", "/3/NetworkTest")
    assert out["microseconds_collective"] > 0
    assert out["table"][0]["collective_ms"] > 0


# -- auth: Basic, form login and LDAP -------------------------------------------

def _cloud(url, user=None, pw=None, cookie=None):
    req = urllib.request.Request(url + "/3/Cloud")
    if user is not None:
        cred = base64.b64encode(f"{user}:{pw}".encode()).decode()
        req.add_header("Authorization", f"Basic {cred}")
    if cookie is not None:
        req.add_header("Cookie", cookie)
    with urllib.request.urlopen(req) as r:
        return r.status, json.loads(r.read())


def test_basic_and_form_login_and_logout():
    s = H2OServer(port=0, username="ann", password="pw1").start()
    try:
        assert _cloud(s.url, "ann", "pw1")[0] == 200
        for creds in (("ann", "nope"), (None, None)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _cloud(s.url, *creds)
            assert e.value.code == 401
            assert e.value.headers["WWW-Authenticate"] == \
                "Basic realm=h2o3_tpu_torch"
        with urllib.request.urlopen(s.url + "/login") as r:
            assert b"<form" in r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(s.url + "/login", data=b"username=ann&"
                                   b"password=bad")
        assert e.value.code == 401
        with urllib.request.urlopen(s.url + "/login", data=b"username=ann&"
                                    b"password=pw1") as r:
            cookie = r.headers["Set-Cookie"].split(";")[0]
        assert _cloud(s.url, cookie=cookie)[0] == 200
        req = urllib.request.Request(s.url + "/logout", data=b"",
                                     headers={"Cookie": cookie})
        urllib.request.urlopen(req).read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _cloud(s.url, cookie=cookie)
        assert e.value.code == 401
    finally:
        s.stop()


def test_ldap_wire_format_is_the_references():
    from h2o3_tpu.api import ldap_auth as jl
    from h2o3_tpu_torch.api import ldap_auth as pl
    for args in ((1, "uid=x,dc=y", "pw"), (7, "cn=é ü,dc=z", ""),
                 (127, "uid=" + "a" * 200, "p" * 300)):
        assert pl.bind_request(*args) == jl.bind_request(*args)
    for code in (0, 49, 32):
        body = b"\x0a\x01" + bytes([code]) + b"\x04\x00\x04\x00"
        resp = b"\x30" + bytes([len(body) + 5]) + b"\x02\x01\x01\x61" + \
            bytes([len(body)]) + body
        assert pl.parse_bind_response(resp) == jl.parse_bind_response(resp)


def test_rest_stack_behind_ldap():
    from test_ldap_auth import FakeLdapServer

    from h2o3_tpu_torch.api.ldap_auth import ldap_authenticator
    ldap = FakeLdapServer("uid=alice,ou=people,dc=example,dc=org", "s3cret")
    auth = ldap_authenticator(f"ldap://127.0.0.1:{ldap.port}",
                              "uid={},ou=people,dc=example,dc=org")
    s = H2OServer(port=0, authenticator=auth).start()
    try:
        st, body = _cloud(s.url, "alice", "s3cret")
        assert st == 200 and body["cloud_healthy"]
        for creds in (("alice", "wrong"), (None, None)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _cloud(s.url, *creds)
            assert e.value.code == 401
        assert ("uid=alice,ou=people,dc=example,dc=org", "s3cret") in \
            ldap.seen
        assert not ldap_authenticator("ldap://127.0.0.1:1", "uid={},dc=x")(
            "alice", "pw")             # nothing listens: rejects closed
    finally:
        s.stop()
        ldap.close()
