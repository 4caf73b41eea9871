"""The port's cloud persist backends (``h2o3_tpu_torch/persist/cloud.py``)
against in-process fake S3, GCS and WebHDFS services on 127.0.0.1, after
``tests/test_persist_cloud.py``: ``export_file`` to and ``import_file``
from ``s3://``, ``gs://`` and ``hdfs://`` round-trip a frame (exact), the
fake checks every SigV4 signature it is sent, and the port's signature
headers equal the JAX package's byte for byte at a fixed clock, key and
payload. Missing credentials raise the reference's guidance; an
``http://`` path fails like the reference's, with ``FileNotFoundError``."""

import datetime
import json
import threading
import urllib.parse
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from h2o3_tpu.persist import cloud as jcloud
from h2o3_tpu_torch import export_file, import_file, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.persist import cloud
from h2o3_tpu_torch.utils.registry import DKV
from dataplane_pair import same_frame
from test_persist_cloud import ACCESS, SECRET, _FakeCloud


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


class _FakeHDFS(_FakeCloud):
    """The fake cloud with WebHDFS's two-step CREATE (a 307 to the data
    node, here itself) and OPEN."""

    def do_PUT(self):
        p = urllib.parse.urlparse(self.path)
        if p.path.startswith("/webhdfs/v1/"):
            q = urllib.parse.parse_qs(p.query)
            length = int(self.headers.get("Content-Length") or 0)
            data = self.rfile.read(length)
            if "noredirect" in q and "datanode" not in q:
                body = json.dumps({"Location": self._url(
                    p.path + "?op=CREATE&datanode=1")}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.store[p.path] = data
            self.send_response(201)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        super().do_PUT()

    def _url(self, path):
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}{path}"


@pytest.fixture
def fake_cloud(monkeypatch):
    _FakeCloud.store = {}
    _FakeCloud.sigv4_seen = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeHDFS)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    monkeypatch.setenv("H2O3TPU_S3_ENDPOINT", url)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", ACCESS)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SECRET)
    monkeypatch.setenv("H2O3TPU_GCS_ENDPOINT", url)
    monkeypatch.setenv("H2O3TPU_GCS_TOKEN", "fake-token")
    monkeypatch.setenv("H2O3TPU_WEBHDFS_ENDPOINT", url)
    yield srv
    srv.shutdown()
    srv.server_close()


def _frame(rng):
    return Frame.from_arrays({
        "a": rng.normal(size=40).astype(np.float32),
        "k": np.array([f"l{i % 3}" for i in range(40)], dtype=object),
        "n": rng.integers(0, 9, 40).astype(np.float32)})


@pytest.mark.parametrize("uri", ["s3://bucket/dir/f.csv",
                                 "gs://bucket/f.csv",
                                 "hdfs://namenode/user/h2o/f.csv"])
def test_export_import_round_trip(fake_cloud, rng, uri):
    fr = _frame(rng)
    assert export_file(fr, uri) == uri
    back = import_file(uri)
    same_frame(fr, back)
    assert back.key == "f_csv.hex" and DKV.get("f_csv.hex") is back
    if uri.startswith("s3"):
        assert len(_FakeCloud.sigv4_seen) == 2


def test_s3_bad_signature_rejected(fake_cloud, monkeypatch):
    import urllib.error
    cloud.MANAGER.put("s3://bucket/x.csv", b"a\n1\n")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wrong")
    with pytest.raises(urllib.error.HTTPError) as ei:
        cloud.MANAGER.get("s3://bucket/x.csv")
    assert ei.value.code == 403


def test_sign_equals_reference_byte_for_byte(monkeypatch):
    """At one fixed clock, key and payload, the port's SigV4 headers are
    the JAX package's."""
    fixed = datetime.datetime(2026, 3, 4, 5, 6, 7,
                              tzinfo=datetime.timezone.utc)

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    for mod in (cloud, jcloud):
        monkeypatch.setattr(mod.datetime, "datetime", _Clock)
    kw = dict(endpoint="https://s3.eu-west-1.amazonaws.com",
              access_key="AKIDEXAMPLE", secret_key="s3cr3t",
              region="eu-west-1")
    for method, path, payload in [("GET", "/b/k.csv", b""),
                                  ("PUT", "/b/dir/a b+c.csv", b"x,y\n1,2\n")]:
        got = cloud.PersistS3(**kw)._sign(method, path, payload)
        want = jcloud.PersistS3(**kw)._sign(method, path, payload)
        assert got == want
        assert got["x-amz-date"] == "20260304T050607Z"


def test_missing_credentials_guidance(monkeypatch):
    for v in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
              "H2O3TPU_GCS_TOKEN", "H2O3TPU_WEBHDFS_ENDPOINT"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="AWS_ACCESS_KEY_ID"):
        cloud.MANAGER.get("s3://bucket/key.csv")
    with pytest.raises(ValueError, match="H2O3TPU_GCS_TOKEN"):
        cloud.MANAGER.get("gs://bucket/key.csv")
    with pytest.raises(ValueError, match="H2O3TPU_WEBHDFS_ENDPOINT"):
        cloud.MANAGER.get("hdfs://nn/key.csv")
    with pytest.raises(ValueError, match="bucket/key"):
        cloud.MANAGER.get("s3://bucket")
    with pytest.raises(ValueError, match="no persist backend"):
        cloud.MANAGER.get("ftp://x/y")


def test_uri_schemes_route_as_the_reference(tmp_path):
    """``http(s)://`` passes the scheme check and fails the readability
    check in both packages; an unknown scheme is refused."""
    from h2o3_tpu.frame import parse as jparse
    for mod in (jparse, None):
        fn = mod.import_file if mod else import_file
        with pytest.raises(FileNotFoundError):
            fn("https://example.invalid/data/a.csv")
        with pytest.raises(ValueError, match="unknown URI scheme 'ftp'"):
            fn("ftp://host/a.csv")
    p = tmp_path / "f.csv"
    p.write_text("x\n1\n2\n")
    assert import_file("file://" + str(p)).nrows == 2
