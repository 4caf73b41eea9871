"""Compute observatory — cost accounting, signature attribution, MFU — the
port of ``h2o3_tpu/utils/costs.py``.

Every timing elsewhere in the stack is host wall-clock; this module is the
fourth observability pillar (after metrics, traces, and memory): it answers
*what fraction of the card are we using, and which input shapes did each
site see*.

Three pieces:

- :class:`AccountedSite` (via :func:`accounted`) — the counterpart of the
  reference's ``AccountedJit`` at the host-dispatched sites (the GBM's
  chunk and its batched tree growth, GLM's IRLS and multinomial steps,
  DeepLearning's epochs, the serving scorers). There is no XLA executable
  to ask, so each site declares a **cost function** written from its code
  (FLOPs and bytes of one call at a signature), and a call's **signature**
  (the shapes, dtypes and devices of its tensors plus its static values)
  stands for a compile: the first call of a new signature is recorded as
  one, with the capture's seconds for a scorer and 0 elsewhere. When a site
  sees a *second* signature the :class:`CostMeter` records a **recompile
  event** with the signature diff, as the reference does.
- :class:`CostMeter` (``COSTS``) — the process-wide registry behind
  ``GET /3/Compute``. Sampled execution probes (every
  ``H2O3TPU_COSTS_SAMPLE``-th call of a site, the first always) combine the
  recorded FLOPs with the measured time into achieved FLOP/s and bytes/s
  per loop, rated against :data:`PEAK_TABLE` —
  ``h2o3_compute_utilization{loop}`` plus arithmetic-intensity / roofline
  gauges. Off the card (the CPU, an unknown accelerator) utilization is
  ``None``, never 0 and never an exception.
- the **site scope** (:meth:`CostMeter.scope`) — a contextvar naming the
  logical site active at build time, consulted by the extension-build
  cache (``utils/compile_cache.py``) so cache hits/misses credit the loop
  that caused them.

A probe on the card records two CUDA events on the current stream around
the call and **never synchronizes**: its elapsed time is read once the end
event has completed, which :meth:`AccountedSite.settle` checks
(``Event.query``, no wait) at the site's next call, after a sync the site
already makes, and when ``/3/Compute`` is read. On the CPU the work is
synchronous and a probe is the call's wall time. ``H2O3TPU_COSTS_OFF=1``
bypasses the sites entirely (nothing recorded, no event made).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
import weakref
from collections import OrderedDict

#: logical site active for compile attribution (innermost scope wins)
_SITE: contextvars.ContextVar["str | None"] = \
    contextvars.ContextVar("h2o3_cost_site", default=None)


def enabled() -> bool:
    """Cost accounting on? (``H2O3TPU_COSTS_OFF=1`` disables; read per call
    so tests and the bench overhead probe can flip it at runtime.)"""
    return os.environ.get("H2O3TPU_COSTS_OFF", "") != "1"


def sample_every() -> int:
    """Execution-probe sampling period (``H2O3TPU_COSTS_SAMPLE``, default
    16; the first call per wrapper always samples so short sessions still
    measure something)."""
    try:
        return max(int(os.environ.get("H2O3TPU_COSTS_SAMPLE", "") or 16), 1)
    except ValueError:
        return 16


# ---------------------------------------------------------------------------
# Per-device peak table. Keyed by substring of the lowercased device name
# (``torch.cuda.get_device_name()``); rows are published per-chip peaks at
# the bf16 dense rate, the convention the reference's TPU rows use
# (utilization is MFU against it). The TPU rows are the reference's, kept so
# a name from either package resolves alike. An unmatched name (the CPU, an
# unknown card) yields None: utilization is then reported as null, NEVER 0
# and never an exception.

PEAK_TABLE = (
    ("h100", {"name": "NVIDIA H100 80GB HBM3", "flops_per_sec": 989.4e12,
              "hbm_bytes_per_sec": 3.35e12}),
    ("v5 lite", {"name": "TPU v5e", "flops_per_sec": 197e12,
                 "hbm_bytes_per_sec": 819e9}),
    ("v5e", {"name": "TPU v5e", "flops_per_sec": 197e12,
             "hbm_bytes_per_sec": 819e9}),
    ("v5p", {"name": "TPU v5p", "flops_per_sec": 459e12,
             "hbm_bytes_per_sec": 2765e9}),
    ("v6", {"name": "TPU v6e", "flops_per_sec": 918e12,
            "hbm_bytes_per_sec": 1640e9}),
    ("v4", {"name": "TPU v4", "flops_per_sec": 275e12,
            "hbm_bytes_per_sec": 1228e9}),
    ("v3", {"name": "TPU v3", "flops_per_sec": 123e12,
            "hbm_bytes_per_sec": 900e9}),
    ("v2", {"name": "TPU v2", "flops_per_sec": 46e12,
            "hbm_bytes_per_sec": 700e9}),
)

_peak_cache: "dict[str, dict | None]" = {}


def device_kind() -> str | None:
    """The card's name (``torch.cuda.get_device_name()``), or None
    without one."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:   # noqa: BLE001 — no driver → no card
        pass
    return None


def backend_peak(device_kind_: str | None = None) -> dict | None:
    """Peak {name, flops_per_sec, hbm_bytes_per_sec} for the card's name
    (or the given one), or None when it is not in the table (the CPU, an
    unknown card)."""
    if device_kind_ is None:
        device_kind_ = device_kind()
        if device_kind_ is None:
            return None
    kind = str(device_kind_).lower()
    if kind not in _peak_cache:
        _peak_cache[kind] = next(
            (row for sub, row in PEAK_TABLE if sub in kind), None)
    return _peak_cache[kind]


# ---------------------------------------------------------------------------
# Signatures: canonical hashable keys + human-readable descriptors + diffs.


def _leaf_key(x):
    """Hashable signature component for one argument: shape / dtype /
    device for tensors, the value-independent type name for Python scalars
    (a scalar's value never changes what runs, so it must not split the
    signature)."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype), str(getattr(x, "device", "")))
    return (type(x).__name__,)


def _leaf_descr(x) -> dict:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        d = {"shape": list(x.shape),
             "dtype": str(x.dtype).replace("torch.", "")}
        dev = getattr(x, "device", None)
        if dev is not None and getattr(dev, "type", "cpu") != "cpu":
            d["devices"] = [dev.index if dev.index is not None else 0]
        return d
    return {"scalar": type(x).__name__}


def signature_diff(old: dict, new: dict) -> list[str]:
    """Human-readable per-component diff between two recorded signatures —
    the payload of a recompile event: WHICH dimension / dtype / device set /
    static argument changed. ``old``/``new`` are the ``signature`` dicts
    :meth:`CostMeter.record_compile` stores ({"args": [...], "statics": {}}).
    """
    out: list[str] = []
    oa, na = old.get("args", []), new.get("args", [])
    if len(oa) != len(na):
        out.append(f"arg count: {len(oa)} -> {len(na)}")
    for i, (a, b) in enumerate(zip(oa, na)):
        if a == b:
            continue
        if "shape" in a and "shape" in b:
            sa, sb = a["shape"], b["shape"]
            if len(sa) != len(sb):
                out.append(f"arg{i}.rank: {len(sa)} -> {len(sb)}")
            else:
                for d, (x, y) in enumerate(zip(sa, sb)):
                    if x != y:
                        out.append(f"arg{i}.shape[{d}]: {x} -> {y}")
            if a.get("dtype") != b.get("dtype"):
                out.append(f"arg{i}.dtype: {a.get('dtype')} -> "
                           f"{b.get('dtype')}")
            if a.get("devices") != b.get("devices"):
                out.append(f"arg{i}.devices: {a.get('devices')} -> "
                           f"{b.get('devices')}")
        else:
            out.append(f"arg{i}: {a} -> {b}")
    os_, ns = old.get("statics", {}), new.get("statics", {})
    for k in sorted(set(os_) | set(ns)):
        if os_.get(k) != ns.get(k):
            out.append(f"static {k}: {os_.get(k)} -> {ns.get(k)}")
    return out or ["signature structure changed"]


def cost_of(model, bucket: int, n_num: int, n_cat: int
            ) -> tuple[float | None, float | None]:
    """(flops, bytes) of scoring one ``bucket`` of rows with ``model``,
    written from the scorers' code (the reference asks the executable's
    ``cost_analysis``). Bytes: the request's float32 and int32 inputs read
    once, the model's tensors read once, the float32 output written once.
    FLOPs: a tree ensemble walks each row through every tree, two
    operations (a compare and a gather) a level; a linear model does a
    multiply-add per row and coefficient. (None, None) for a model of
    neither kind."""
    from h2o3_tpu_torch.utils.memory import array_tree_bytes
    out = getattr(model, "output", None) or {}
    k = max(len(getattr(model, "response_domain", None) or ()), 1)
    nbytes = float(bucket * 4 * (n_num + n_cat) + bucket * 4 * k
                   + array_tree_bytes(out))
    trees = out.get("trees")
    if trees:
        depth = 0
        heap = getattr(trees[0], "feat", None)
        if heap is not None:
            depth = max(int(heap.shape[-1] + 1).bit_length() - 2, 1)
        flops = float(2 * bucket * len(trees) * depth)
        return flops, nbytes
    beta = out.get("beta")
    if beta is not None and hasattr(beta, "numel"):
        return float(2 * bucket * beta.numel()), nbytes
    return None, nbytes


# ---------------------------------------------------------------------------
# The registry.

#: recompile events kept per site / process-wide cap on stored signatures
MAX_SIGNATURES_PER_SITE = 32
MAX_RECOMPILE_EVENTS = 64


class CostMeter:
    """Process-wide per-site compile/cost registry (``GET /3/Compute``)."""

    def __init__(self):
        self._lock = threading.Lock()
        # site -> {"loop": str|None, "signatures": OrderedDict[key, rec],
        #          "recompiles": [event], "compiles": int,
        #          "compile_seconds": float, "eager_fallbacks": int}
        self._sites: "OrderedDict[str, dict]" = OrderedDict()
        # loop -> {"samples": int, "achieved_flops_per_sec": float, ...}
        self._loops: dict[str, dict] = {}
        self._wrappers: "weakref.WeakSet[AccountedSite]" = weakref.WeakSet()

    # -- site scope (compile-cache attribution) ------------------------------

    @contextlib.contextmanager
    def scope(self, site: str):
        """Name the logical site active for compile attribution in this
        context (innermost wins). The persistent compile-cache listeners
        read it at event time (``utils/compile_cache.py``)."""
        token = _SITE.set(site)
        try:
            yield
        finally:
            _SITE.reset(token)

    @staticmethod
    def active_site() -> str | None:
        return _SITE.get()

    # -- recording -----------------------------------------------------------

    def _site_locked(self, site: str, loop: str | None) -> dict:
        rec = self._sites.get(site)
        if rec is None:
            rec = self._sites[site] = {
                "loop": loop, "signatures": OrderedDict(), "recompiles": [],
                "compiles": 0, "compile_seconds": 0.0, "eager_fallbacks": 0}
        elif loop is not None and rec["loop"] is None:
            rec["loop"] = loop
        return rec

    def record_compile(self, site: str, signature: dict, seconds: float,
                       flops: float | None, nbytes: float | None,
                       loop: str | None = None, key=None) -> None:
        """One observed compile at ``site``. ``signature`` is the
        {"args": [...], "statics": {...}} descriptor; ``key`` its canonical
        hashable form (a repr of the descriptor when omitted). A compile of
        an already-recorded signature (a site object made anew, a cleared
        site) increments counts but is NOT a recompile event; a genuinely
        new second+ signature is."""
        from h2o3_tpu_torch.utils import telemetry as _tm
        key = key if key is not None else repr(signature)
        with self._lock:
            rec = self._site_locked(site, loop)
            rec["compiles"] += 1
            rec["compile_seconds"] = round(
                rec["compile_seconds"] + float(seconds), 6)
            known = key in rec["signatures"]
            if not known:
                prev = next(reversed(rec["signatures"].values()), None)
                rec["signatures"][key] = {
                    "signature": signature, "compile_seconds": round(
                        float(seconds), 6),
                    "flops": flops, "bytes": nbytes,
                    "compiles": 1}
                while len(rec["signatures"]) > MAX_SIGNATURES_PER_SITE:
                    rec["signatures"].popitem(last=False)
                if prev is not None:
                    rec["recompiles"].append({
                        "site": site,
                        "from": prev["signature"], "to": signature,
                        "diff": signature_diff(prev["signature"], signature),
                        "compile_seconds": round(float(seconds), 6)})
                    del rec["recompiles"][:-MAX_RECOMPILE_EVENTS]
            else:
                rec["signatures"][key]["compiles"] += 1
                rec["signatures"].move_to_end(key)
            recompiled = (not known) and len(rec["signatures"]) > 1
        _tm.COMPILES.labels(site=site).inc()
        _tm.COMPILE_SECONDS.labels(site=site).inc(float(seconds))
        if recompiled:
            _tm.RECOMPILES.labels(site=site).inc()

    def record_eager_fallback(self, site: str, loop: str | None = None
                              ) -> None:
        """A scorer whose model would not capture into a CUDA graph (a host
        sync, a data-dependent shape): it scores eagerly — counted so the
        table says so instead of silently missing."""
        with self._lock:
            self._site_locked(site, loop)["eager_fallbacks"] += 1

    def latest_cost(self, site: str) -> tuple[float | None, float | None]:
        """(flops, bytes) of the site's most recently compiled signature —
        the fallback when the caller cannot name which signature ran."""
        with self._lock:
            rec = self._sites.get(site)
            if rec is None:
                return None, None
            sig = next(reversed(rec["signatures"].values()), None)
            if sig is None:
                return None, None
            return sig["flops"], sig["bytes"]

    def cost_for(self, site: str, key) -> tuple[float | None, float | None]:
        """(flops, bytes) of one SPECIFIC recorded signature, so a sampled
        probe attributes the cost of the program that actually ran — a site
        holding several live signatures (full GBM chunk + remainder chunk,
        wide + narrow IRLS) must not rate one signature's wall time against
        another's FLOPs. (None, None) when evicted/unknown."""
        with self._lock:
            rec = self._sites.get(site)
            sig = rec["signatures"].get(key) if rec is not None else None
            if sig is None:
                return None, None
            return sig["flops"], sig["bytes"]

    # -- execution probes → achieved FLOP/s / roofline gauges ----------------

    def observe(self, site: str, seconds: float,
                flops: float | None = None,
                nbytes: float | None = None) -> None:
        """Fold one SAMPLED, synced execution of ``site``'s program (wall
        ``seconds``) into the per-loop achieved-throughput view. Cost
        defaults to the site's most recent signature. Unknown
        backends publish achieved FLOP/s but no utilization gauge — the
        REST view reports utilization null there."""
        if seconds <= 0:
            return
        from h2o3_tpu_torch.utils import telemetry as _tm
        if flops is None:
            flops, nbytes = self.latest_cost(site)
        if flops is None or flops <= 0:
            return
        achieved = flops / seconds
        achieved_b = (nbytes / seconds) if nbytes else None
        intensity = (flops / nbytes) if nbytes else None
        peak = backend_peak()
        util = (achieved / peak["flops_per_sec"]) if peak else None
        with self._lock:
            loop = (self._sites.get(site) or {}).get("loop") or site
            st = self._loops.setdefault(loop, {"samples": 0})
            st["samples"] += 1
            st["achieved_flops_per_sec"] = round(achieved, 1)
            st["achieved_bytes_per_sec"] = (round(achieved_b, 1)
                                            if achieved_b else None)
            st["arithmetic_intensity"] = (round(intensity, 3)
                                          if intensity else None)
            # six significant digits, not decimals: a memory-bound loop on
            # the card reads far below 1e-6 of the dense peak, and must
            # not round to a bogus 0
            st["utilization"] = (float(f"{util:.6g}") if util is not None
                                 else None)
            if peak and intensity is not None:
                ridge = peak["flops_per_sec"] / peak["hbm_bytes_per_sec"]
                st["roofline"] = ("compute-bound" if intensity >= ridge
                                  else "memory-bound")
            else:
                st["roofline"] = None
        _tm.ACHIEVED_FLOPS.labels(loop=loop).set(achieved)
        if achieved_b is not None:
            _tm.ACHIEVED_BYTES.labels(loop=loop).set(achieved_b)
        if intensity is not None:
            _tm.ARITH_INTENSITY.labels(loop=loop).set(intensity)
        if util is not None:
            _tm.COMPUTE_UTILIZATION.labels(loop=loop).set(util)

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /3/Compute`` payload: per-site compiles / signatures /
        costs / recompile events, per-loop achieved throughput + roofline
        position, and the backend peak row (null on unknown backends)."""
        self.settle()
        peak = backend_peak()
        kind = device_kind()
        backend = "cuda" if kind is not None else "cpu"
        with self._lock:
            sites = []
            for name, rec in self._sites.items():
                sigs = list(rec["signatures"].values())
                sites.append({
                    "site": name, "loop": rec["loop"],
                    "compiles": rec["compiles"],
                    "compile_seconds": rec["compile_seconds"],
                    "eager_fallbacks": rec["eager_fallbacks"],
                    "flops": next((s["flops"] for s in reversed(sigs)
                                   if s["flops"] is not None), None),
                    "bytes": next((s["bytes"] for s in reversed(sigs)
                                   if s["bytes"] is not None), None),
                    "signatures": [dict(s) for s in sigs],
                    "recompile_events": [dict(e) for e in rec["recompiles"]],
                })
            loops = {k: dict(v) for k, v in self._loops.items()}
        return {"backend": backend, "device_kind": kind,
                "peak": dict(peak) if peak else None,
                "sites": sites, "loops": loops,
                "signature_count": sum(len(s["signatures"]) for s in sites),
                "recompile_events": sum(len(s["recompile_events"])
                                        for s in sites)}

    def loops(self) -> dict:
        """Per-loop achieved-throughput rows only (utilization / samples /
        roofline) — the health evaluator's MFU-collapse probe reads this
        every sweep, so it must not pay :meth:`snapshot`'s full per-site
        signature copy."""
        self.settle()
        with self._lock:
            return {k: dict(v) for k, v in self._loops.items()}

    def signature_count(self) -> int:
        """Total distinct signatures across sites — the bench's
        steady-state recompile probe: a warm scenario re-run must not grow
        this."""
        with self._lock:
            return sum(len(r["signatures"]) for r in self._sites.values())

    def recompile_count(self) -> int:
        with self._lock:
            return sum(len(r["recompiles"]) for r in self._sites.values())

    # -- lifecycle -----------------------------------------------------------

    def _register_wrapper(self, w: "AccountedSite") -> None:
        self._wrappers.add(w)

    def settle(self) -> None:
        """Fold every site's completed probes in (no wait: a probe whose
        end event is still pending stays for a later read)."""
        for w in list(self._wrappers):
            w.settle()

    def clear(self) -> None:
        """Tests only: drop every record and every site's pending probes
        and seen signatures (so a same-shape scenario re-records from a
        clean slate)."""
        for w in list(self._wrappers):
            w.clear()
        with self._lock:
            self._sites.clear()
            self._loops.clear()


COSTS = CostMeter()


# ---------------------------------------------------------------------------
# The accounted site.

#: pending probes kept per site (the oldest are dropped unread beyond it)
_MAX_PENDING = 64


class AccountedSite:
    """One host-dispatched site of the compute observatory.

    ``cost(args, statics) -> (flops, bytes)`` is called once per new
    signature."""

    def __init__(self, site: str, cost=None, *, loop: str | None = None):
        self.site = site
        self.loop = loop
        self._cost = cost
        self._calls = itertools.count()
        self._lock = threading.Lock()
        self._seen: set = set()
        # (signature key, start event, end event) of sampled card calls
        self._pending: list[tuple] = []
        COSTS._register_wrapper(self)

    def clear(self) -> None:
        with self._lock:
            self._seen.clear()
            self._pending.clear()
            self._calls = itertools.count()

    def _signature(self, args, statics: dict | None = None) -> tuple:
        """(key, descriptor) of a call: each argument's shape / dtype /
        device, and the static values."""
        statics = dict(statics or {})
        key = (tuple(sorted((k, repr(v)) for k, v in statics.items())),
               tuple(_leaf_key(x) for x in args))
        descr = {"args": [_leaf_descr(x) for x in args],
                 "statics": {k: repr(v) for k, v in statics.items()}}
        return key, descr

    def _note(self, args, statics: dict | None = None) -> tuple:
        """Record the call's signature if new (the compile analog); returns
        its key."""
        key, descr = self._signature(args, statics)
        with self._lock:
            new = key not in self._seen
            self._seen.add(key)
        if new:
            flops, nbytes = (self._cost(args, dict(statics or {}))
                             if self._cost is not None else (None, None))
            COSTS.record_compile(self.site, descr, 0.0, flops, nbytes,
                                 loop=self.loop, key=key)
        return key

    @contextlib.contextmanager
    def dispatch(self, args, statics: dict | None = None):
        """``with SITE.dispatch((binned, g, w), {"depth": 6}):`` around one
        call of the site: records a new signature, and on a sampled call
        probes the time the call takes (CUDA events on the current stream
        when an argument lies on a card, the wall time on the CPU)."""
        if not enabled():
            yield
            return
        self.settle()
        key = self._note(args, statics)
        n = next(self._calls)
        if not (n == 0 or n % sample_every() == 0):
            yield
            return
        dev = next((x.device for x in args
                    if getattr(getattr(x, "device", None), "type", None)
                    == "cuda"), None)
        if dev is None:
            t0 = time.perf_counter()
            yield
            flops, nbytes = COSTS.cost_for(self.site, key)
            COSTS.observe(self.site, time.perf_counter() - t0,
                          flops=flops, nbytes=nbytes)
            return
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        yield
        end.record(torch.cuda.current_stream(dev))
        with self._lock:
            self._pending.append((key, start, end))
            del self._pending[:-_MAX_PENDING]

    def settle(self) -> None:
        """Fold in every sampled probe whose end event has completed
        (``Event.query`` — never a wait); the others stay pending."""
        with self._lock:
            if not self._pending:
                return
            done, waiting = [], []
            for p in self._pending:
                (done if p[2].query() else waiting).append(p)
            self._pending = waiting
        for key, start, end in done:
            flops, nbytes = COSTS.cost_for(self.site, key)
            COSTS.observe(self.site, start.elapsed_time(end) / 1e3,
                          flops=flops, nbytes=nbytes)


def accounted(site: str, cost=None, *,
              loop: str | None = None) -> AccountedSite:
    """The :class:`AccountedSite` of ``site`` (the port's counterpart of
    the reference's ``accounted_jit``)::

        _IRLS = accounted("glm:irls_megastep", _irls_cost, loop="glm_irls")
        with _IRLS.dispatch((X, w), {"family": family}):
            ...
    """
    return AccountedSite(site, cost, loop=loop)
