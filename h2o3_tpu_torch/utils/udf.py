"""User-defined metric and distribution functions uploaded as zips — the
port of ``h2o3_tpu/utils/udf.py``.

Reference: ``water/udf/``; h2o-py's ``h2o.upload_custom_metric`` and
``upload_custom_distribution`` zip generated Python source, upload it under
a key (``POST /3/PutKey``) and pass ``"python:KEY=module.Class"`` as
``custom_metric_func`` or ``custom_distribution_func``. :func:`load_cfunc`
reads the zip from the port's DKV (a :class:`~h2o3_tpu_torch.frame.parse.
RawFile` or bytes), executes the module beside a ``water.udf`` stand-in
package (the generated wrapper does ``import water.udf.CMetricFunc as
MetricFunc``) and returns an instance of the named class. SECURITY: as in
the reference, loading a UDF runs the user's code in this process.

A custom metric runs row by row on the host, as the reference's does
(:func:`metric_callable`). A custom distribution
(:class:`CustomDistribution`) is called on whole float64 columns on the
device: its ``gradient`` and ``gamma`` (and ``init``, for the initial
margin) once a boosting round, which any UDF written in elementwise
arithmetic, as h2o-py's generated ones are, computes on tensors. A UDF
that cannot (it calls ``math.*`` or branches on a value) runs the
reference's row loop on the host instead. Which path runs is decided at
first use, for ``init`` and for ``gradient`` with ``gamma``, and kept on
the distribution (``vectorized``: the gradient's, batched only where the
init is too): the batched result must equal the row loop's on the first
64 rows, or the first use raises.
"""

from __future__ import annotations

import hashlib
import io
import re
import sys
import threading
import types
import zipfile

import numpy as np
import torch

from h2o3_tpu_torch.utils.registry import DKV

__all__ = ["load_cfunc", "parse_ref", "metric_callable", "CustomDistribution",
           "resolve_distribution", "LINKS", "linkinv"]


class CMetricFunc:
    """Stand-in for ``water.udf.CMetricFunc``: subclasses provide
    ``map(pred, act, w, o, model) -> state``, ``reduce(l, r) -> state`` and
    ``metric(state) -> float``."""


class CDistributionFunc:
    """Stand-in for ``water.udf.CDistributionFunc``: subclasses provide
    ``link() -> str``, ``init(w, o, y) -> [num, den]``, ``gradient(y, f)``
    and ``gamma(w, y, z, f) -> [num, den]``."""


def _install_shim() -> None:
    """Make ``import water.udf.CMetricFunc as MetricFunc`` resolve, by
    seeding ``sys.modules``; a ``water.udf`` package already installed
    (the JAX package's, in a process that loads both) is reused."""
    if "water.udf" in sys.modules:
        return
    water = types.ModuleType("water")
    udf = types.ModuleType("water.udf")
    udf.CMetricFunc = CMetricFunc
    udf.CDistributionFunc = CDistributionFunc
    water.udf = udf
    sys.modules["water"] = water
    sys.modules["water.udf"] = udf
    sys.modules["water.udf.CMetricFunc"] = CMetricFunc  # type: ignore
    sys.modules["water.udf.CDistributionFunc"] = CDistributionFunc  # type: ignore


_REF_RE = re.compile(r"^(\w+):([^=]+)=(.+)$")


def parse_ref(ref: str) -> tuple[str, str, str]:
    """``"lang:key=module.Class"`` as (lang, key, qualified class)."""
    m = _REF_RE.match(ref)
    if not m:
        raise ValueError(f"malformed UDF reference {ref!r}; expected "
                         "'python:key=module.Class'")
    return m.group(1), m.group(2), m.group(3)


def _upload_bytes(key: str) -> bytes:
    val = DKV.get(key)
    if val is None:
        raise KeyError(f"UDF key {key!r} not found; upload it with "
                       "/3/PutKey")
    data = getattr(val, "data", val)
    if not isinstance(data, (bytes, bytearray)):
        raise TypeError(f"UDF key {key!r} does not hold raw uploaded bytes")
    return bytes(data)


def load_cfunc(ref: str):
    """An instance of the class a ``"python:KEY=module.Class"`` reference
    names: ``module.py`` from the zip under KEY, executed."""
    lang, key, qual = parse_ref(ref)
    if lang != "python":
        raise ValueError(f"unsupported UDF language {lang!r} (only "
                         "'python')")
    data = _upload_bytes(key)
    module_name, _, cls_name = qual.partition(".")
    if not cls_name:
        raise ValueError(f"UDF reference {ref!r} lacks a class name")
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        src = zf.read(module_name + ".py").decode()
    _install_shim()
    ns: dict = {"__name__": module_name}
    exec(compile(src, f"<udf {key}:{module_name}.py>", "exec"), ns)
    if cls_name not in ns:
        raise KeyError(f"class {cls_name!r} not defined by uploaded module "
                       f"{module_name!r}")
    return ns[cls_name]()


# -- custom metric -----------------------------------------------------------

def metric_callable(obj, name: str, model=None):
    """A map/reduce/metric UDF as the builders' ``(preds, y, w) -> float``
    custom metric, evaluated row by row on the host over the rows of
    ``w > 0`` (reference ``CFuncTask``): a classifier's row is ``[label,
    p0, p1, ...]`` (the label by ``model``'s ``_default_threshold`` for
    binomial where it has one, else the argmax), a regression's
    ``[prediction]``; ``act`` is ``[y]`` and the offset 0."""
    def fn(preds, y, w):
        preds = np.asarray(preds)
        y = np.asarray(y, np.float64)
        w = np.asarray(w, np.float64)
        thr = None
        if preds.ndim == 2 and preds.shape[1] == 2:
            m = model() if callable(model) else model
            t = getattr(m, "_default_threshold", None)
            thr = float(t) if t is not None else None
        acc = None
        for i in np.nonzero(w > 0)[0]:
            if preds.ndim == 2:
                probs = [float(v) for v in preds[i]]
                label = (float(probs[1] >= thr) if thr is not None
                         else float(np.argmax(preds[i])))
                row = [label] + probs
            else:
                row = [float(preds[i])]
            state = obj.map(row, [float(y[i])], float(w[i]), 0.0, None)
            acc = state if acc is None else obj.reduce(acc, state)
        return float(obj.metric(acc)) if acc is not None else float("nan")

    fn.__name__ = name
    return fn


# -- custom distribution -----------------------------------------------------

#: forward links (the initial margin's); the inverse links are
#: :func:`linkinv`, on the device
LINKS = {
    "identity": lambda x: x,
    "log": lambda x: np.log(np.maximum(x, 1e-30)),
    "logit": lambda x: np.log(np.clip(x, 1e-12, 1 - 1e-12)
                              / (1 - np.clip(x, 1e-12, 1 - 1e-12))),
    "inverse": lambda x: 1.0 / np.where(np.abs(x) < 1e-30, 1e-30, x),
}


def linkinv(link: str, f: torch.Tensor) -> torch.Tensor:
    """The inverse link of a custom distribution on margins ``f`` (reference
    ``LinkFunction*.java``; names as ``CDistributionFunc.link()`` gives
    them)."""
    if link == "log":
        return torch.exp(torch.clamp(f, -30, 30))
    if link == "logit":
        return torch.sigmoid(f)
    if link == "inverse":
        return 1.0 / torch.where(f.abs() < 1e-30, 1e-30, f)
    return f


#: rows of the first use's check of the batched path against the row loop
CHECK_ROWS = 64


class CustomDistribution:
    """A link/init/gradient/gamma UDF as the boosting loop's (g, h) pairs:
    with z = ``gradient(y, f)`` and ``[num, den] = gamma(w, y, z, f)``, g =
    -num and h = den (at least 1e-10), so the Newton leaf -sum(g)/sum(h) is
    the reference's custom leaf (``CDistributionFunc.java:49-58``); rows of
    weight 0 give g = 0 and h = 1e-10, as in the reference."""

    def __init__(self, obj, ref: str):
        self.obj = obj
        self.ref = ref
        self.link_name = str(obj.link())
        if self.link_name not in LINKS:
            raise ValueError(f"unsupported custom link {self.link_name!r}; "
                             f"have {sorted(LINKS)}")
        #: None until the first gradient; then whether it runs batched
        self.vectorized: bool | None = None
        self._init_vectorized: bool | None = None
        self._lock = threading.Lock()

    # the two forms of each function: float64 columns (tensors), or the
    # reference's row loop on host arrays
    def _gh_batched(self, F, y, w):
        z = self.obj.gradient(y, F)
        num, den = self.obj.gamma(w, y, z, F)
        num = torch.as_tensor(num, dtype=torch.float64,
                              device=F.device).expand_as(F)
        den = torch.as_tensor(den, dtype=torch.float64,
                              device=F.device).expand_as(F)
        pos = w > 0
        return (torch.where(pos, -num, 0.0),
                torch.where(pos, torch.clamp(den, min=1e-10), 1e-10))

    def _gh_rows(self, F, y, w):
        g = np.zeros_like(F)
        h = np.full_like(F, 1e-10)
        for i in np.nonzero(w > 0)[0]:
            z = float(self.obj.gradient(float(y[i]), float(F[i])))
            nd = self.obj.gamma(float(w[i]), float(y[i]), z, float(F[i]))
            g[i] = -nd[0]
            h[i] = max(nd[1], 1e-10)
        return g, h

    def _init_batched(self, y, w, o):
        num, den = self.obj.init(w, o, y)
        pos = w > 0
        num = torch.as_tensor(num, dtype=torch.float64,
                              device=y.device).expand_as(y)
        den = torch.as_tensor(den, dtype=torch.float64,
                              device=y.device).expand_as(y)
        return (torch.where(pos, num, 0.0).sum(),
                torch.where(pos, den, 0.0).sum())

    def _init_rows(self, y, w, o):
        num = den = 0.0
        for i in np.nonzero(w > 0)[0]:
            nd = self.obj.init(float(w[i]), float(o[i]), float(y[i]))
            num += nd[0]
            den += nd[1]
        return num, den

    def _check(self, what: str, batched, rows, cols: list) -> bool:
        """Whether ``batched`` computes on the first ``CHECK_ROWS`` rows of
        ``cols`` (float64 tensors) what ``rows`` computes on them as host
        arrays; False where it cannot take tensors (``math.*``, a branch on
        a value), an error where it computes otherwise."""
        n = min(CHECK_ROWS, cols[0].shape[0])
        head = [t[:n].double() for t in cols]
        try:
            got = [np.asarray(torch.as_tensor(v).cpu(), np.float64)
                   for v in batched(*head)]
        except Exception:
            return False
        want = [np.asarray(v, np.float64)
                for v in rows(*(t.cpu().numpy() for t in head))]
        if not all(np.allclose(a, b, rtol=1e-9, atol=0.0, equal_nan=True)
                   for a, b in zip(got, want)):
            raise ValueError(
                f"custom distribution {self.ref!r}: its batched {what} "
                f"differs from its row loop on the first {n} rows ({got} "
                f"against {want})")
        return True

    def f0(self, y: torch.Tensor, w: torch.Tensor,
           offset: torch.Tensor | None = None) -> float:
        """The initial margin: link(sum num / sum den) of ``init`` over the
        rows of w > 0 (reference ``DistributionFactory``'s custom init)."""
        o = torch.zeros_like(y) if offset is None else offset
        with self._lock:
            if self._init_vectorized is None:
                self._init_vectorized = self._check(
                    "init", self._init_batched, self._init_rows, [y, w, o])
        if self._init_vectorized:
            num, den = (float(v) for v in self._init_batched(
                y.double(), w.double(), o.double()))
        else:
            num, den = self._init_rows(
                *(t.double().cpu().numpy() for t in (y, w, o)))
        mu = num / max(den, 1e-30)
        return float(LINKS[self.link_name](mu))

    def grad_hess(self, F: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
        """Per-row float32 (g, h) on F's device, batched where the first
        call found the UDF computes on tensors as its row loop does."""
        with self._lock:
            if self.vectorized is None:
                self.vectorized = self._init_vectorized is not False and \
                    self._check("gradient and gamma", self._gh_batched,
                                self._gh_rows, [F, y, w])
        if self.vectorized:
            g, h = self._gh_batched(F.double(), y.double(), w.double())
            return g.float(), h.float()
        g, h = self._gh_rows(*(t.double().cpu().numpy() for t in (F, y, w)))
        return (torch.as_tensor(g.astype(np.float32)).to(F.device),
                torch.as_tensor(h.astype(np.float32)).to(F.device))


_BY_SOURCE: dict[tuple, CustomDistribution] = {}
_DIST_LOCK = threading.Lock()


def resolve_distribution(ref: str) -> CustomDistribution:
    """The custom distribution of a reference, loaded once per (reference,
    uploaded bytes): training again with the same upload reuses it (and
    its decided path); an upload replaced under the same key loads
    anew."""
    _, key, _ = parse_ref(ref)
    digest = hashlib.sha1(_upload_bytes(key)).hexdigest()
    with _DIST_LOCK:
        cd = _BY_SOURCE.get((ref, digest))
    if cd is not None:
        return cd
    cd = CustomDistribution(load_cfunc(ref), ref)
    with _DIST_LOCK:
        return _BY_SOURCE.setdefault((ref, digest), cd)
