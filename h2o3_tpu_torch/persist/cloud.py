"""Cloud persist backends — the port of ``h2o3_tpu/persist/cloud.py``:
S3, GCS and HDFS over the standard library's HTTP.

Reference: ``water/persist/PersistManager.java`` sends each URI scheme to
a ``Persist`` backend. With no cloud SDK, the backends speak the services'
plain HTTP protocols, with the reference's endpoints, variables and error
texts:

- **S3**: AWS Signature V4 (``hashlib``/``hmac``) against
  ``H2O3TPU_S3_ENDPOINT`` (default ``https://s3.<region>.amazonaws.com``),
  credentials from ``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``; any
  S3-compatible store works through the endpoint.
- **GCS**: the JSON API with a bearer token from ``H2O3TPU_GCS_TOKEN``;
  ``H2O3TPU_GCS_ENDPOINT`` overrides the host.
- **HDFS**: WebHDFS REST at ``H2O3TPU_WEBHDFS_ENDPOINT``.

``get(uri)`` and ``put(uri, data)`` are the whole interface: imports parse
a temporary file, exports upload bytes.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request


class PersistManager:
    """Scheme → backend registry (reference: PersistManager.I[] by scheme)."""

    def __init__(self):
        self._backends: dict[str, object] = {}

    def register(self, scheme: str, backend) -> None:
        self._backends[scheme.lower()] = backend

    def backend(self, uri: str):
        scheme = uri.split("://", 1)[0].lower()
        b = self._backends.get(scheme)
        if b is None:
            raise ValueError(f"no persist backend registered for "
                             f"{scheme}:// (have {sorted(self._backends)})")
        return b

    def get(self, uri: str) -> bytes:
        return self.backend(uri).get(uri)

    def put(self, uri: str, data: bytes) -> None:
        self.backend(uri).put(uri, data)

    def fetch_to_temp(self, uri: str) -> str:
        """Download to a temp file named like the object (parsers sniff the
        extension); caller unlinks."""
        import tempfile
        name = uri.rsplit("/", 1)[-1] or "object"
        suffix = os.path.splitext(name)[1] or ".csv"
        fd, tmp = tempfile.mkstemp(suffix=suffix)
        with os.fdopen(fd, "wb") as f:
            f.write(self.get(uri))
        return tmp


def _split_bucket_key(uri: str) -> tuple[str, str]:
    rest = uri.split("://", 1)[1]
    bucket, _, key = rest.partition("/")
    if not bucket or not key:
        raise ValueError(f"cloud URI needs bucket/key: {uri!r}")
    return bucket, key


class PersistS3:
    """SigV4-signed S3 REST (reference: ``water.persist.PersistS3``)."""

    def __init__(self, endpoint: str | None = None,
                 access_key: str | None = None,
                 secret_key: str | None = None, region: str | None = None):
        # overrides win; env is read PER CALL so configuration set after
        # import (tests, notebooks) takes effect
        self._endpoint, self._region = endpoint, region
        self._access_key, self._secret_key = access_key, secret_key

    @property
    def region(self) -> str:
        return self._region or os.environ.get("AWS_REGION", "us-east-1")

    @property
    def endpoint(self) -> str:
        return (self._endpoint or os.environ.get("H2O3TPU_S3_ENDPOINT")
                or f"https://s3.{self.region}.amazonaws.com")

    @property
    def access_key(self):
        return self._access_key or os.environ.get("AWS_ACCESS_KEY_ID")

    @property
    def secret_key(self):
        return self._secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY")

    # -- SigV4 (AWS General Reference, Signature Version 4) ------------------

    def _sign(self, method: str, path: str, payload: bytes) -> dict:
        if not self.access_key or not self.secret_key:
            raise ValueError(
                "S3 credentials missing: set AWS_ACCESS_KEY_ID / "
                "AWS_SECRET_ACCESS_KEY (and H2O3TPU_S3_ENDPOINT for "
                "S3-compatible stores)")
        host = urllib.parse.urlparse(self.endpoint).netloc
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(payload).hexdigest()
        canonical_headers = (f"host:{host}\n"
                             f"x-amz-content-sha256:{payload_hash}\n"
                             f"x-amz-date:{amz_date}\n")
        signed_headers = "host;x-amz-content-sha256;x-amz-date"
        canonical = "\n".join([method, urllib.parse.quote(path), "",
                               canonical_headers, signed_headers,
                               payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             hashlib.sha256(canonical.encode()).hexdigest()])

        def hm(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(hm(hm(hm(b"AWS4" + self.secret_key.encode(), datestamp),
                     self.region), "s3"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        auth = (f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={sig}")
        return {"Authorization": auth, "x-amz-date": amz_date,
                "x-amz-content-sha256": payload_hash}

    def _request(self, method: str, uri: str, data: bytes = b"") -> bytes:
        bucket, key = _split_bucket_key(uri)
        path = f"/{bucket}/{key}"
        headers = self._sign(method, path, data)
        # the request line must carry the SAME percent-encoding the
        # signature covered, or keys with spaces/non-ASCII get 403s
        req = urllib.request.Request(
            self.endpoint + urllib.parse.quote(path),
            data=data if method == "PUT" else None,
            method=method, headers=headers)
        with urllib.request.urlopen(req) as r:
            return r.read()

    def get(self, uri: str) -> bytes:
        return self._request("GET", uri)

    def put(self, uri: str, data: bytes) -> None:
        self._request("PUT", uri, data)


class PersistGCS:
    """GCS JSON-API backend (reference: ``h2o-persist-gcs``)."""

    def __init__(self, endpoint: str | None = None, token: str | None = None):
        self._endpoint, self._token = endpoint, token

    @property
    def endpoint(self) -> str:
        return (self._endpoint or os.environ.get("H2O3TPU_GCS_ENDPOINT")
                or "https://storage.googleapis.com")

    @property
    def token(self):
        return self._token or os.environ.get("H2O3TPU_GCS_TOKEN")

    def _headers(self) -> dict:
        if not self.token:
            raise ValueError("GCS token missing: set H2O3TPU_GCS_TOKEN (an "
                             "OAuth2 bearer token) and optionally "
                             "H2O3TPU_GCS_ENDPOINT")
        return {"Authorization": f"Bearer {self.token}"}

    def get(self, uri: str) -> bytes:
        bucket, key = _split_bucket_key(uri)
        url = (f"{self.endpoint}/storage/v1/b/{bucket}/o/"
               f"{urllib.parse.quote(key, safe='')}?alt=media")
        with urllib.request.urlopen(
                urllib.request.Request(url, headers=self._headers())) as r:
            return r.read()

    def put(self, uri: str, data: bytes) -> None:
        bucket, key = _split_bucket_key(uri)
        url = (f"{self.endpoint}/upload/storage/v1/b/{bucket}/o"
               f"?uploadType=media&name={urllib.parse.quote(key, safe='')}")
        req = urllib.request.Request(url, data=data, method="POST",
                                     headers=self._headers())
        urllib.request.urlopen(req).read()


class PersistWebHDFS:
    """WebHDFS/httpfs REST backend (reference: ``h2o-persist-hdfs`` — the
    SDK-free gateway protocol)."""

    def __init__(self, endpoint: str | None = None, user: str | None = None):
        self._endpoint, self._user = endpoint, user

    @property
    def endpoint(self):
        return (self._endpoint
                or os.environ.get("H2O3TPU_WEBHDFS_ENDPOINT"))

    @property
    def user(self) -> str:
        return self._user or os.environ.get("H2O3TPU_WEBHDFS_USER", "h2o")

    def _url(self, uri: str, op: str) -> str:
        if not self.endpoint:
            raise ValueError("set H2O3TPU_WEBHDFS_ENDPOINT "
                             "(http://namenode:9870) for hdfs:// access")
        path = uri.split("://", 1)[1]
        path = path.partition("/")[2] if "//" not in path else path
        return (f"{self.endpoint}/webhdfs/v1/{path}?op={op}"
                f"&user.name={self.user}")

    def get(self, uri: str) -> bytes:
        with urllib.request.urlopen(self._url(uri, "OPEN")) as r:
            return r.read()

    def put(self, uri: str, data: bytes) -> None:
        # WebHDFS CREATE is two-step: the namenode answers with a 307 to a
        # datanode, and urllib will not auto-redirect a PUT — ask for the
        # location explicitly and re-PUT there (httpfs gateways skip the
        # redirect and accept the first PUT)
        url = self._url(uri, "CREATE&overwrite=true&noredirect=true")
        req = urllib.request.Request(url, data=b"", method="PUT")
        try:
            with urllib.request.urlopen(req) as r:
                body = r.read()
                loc = r.headers.get("Location")
                if not loc and body:
                    import json as _json
                    try:
                        loc = _json.loads(body).get("Location")
                    except ValueError:
                        loc = None
        except urllib.error.HTTPError as e:
            if e.code != 307:
                raise
            loc = e.headers.get("Location")
        target = loc or url
        urllib.request.urlopen(urllib.request.Request(
            target, data=data, method="PUT")).read()


#: process-wide manager with the standard schemes (reference:
#: PersistManager's eager backend registration)
MANAGER = PersistManager()
for _scheme in ("s3", "s3a", "s3n"):
    MANAGER.register(_scheme, PersistS3())
for _scheme in ("gs", "gcs"):
    MANAGER.register(_scheme, PersistGCS())
MANAGER.register("hdfs", PersistWebHDFS())
