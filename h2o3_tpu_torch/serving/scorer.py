"""ScorerCache — one CUDA graph per (model, signature, bucket) — the port
of ``h2o3_tpu/serving/scorer.py``.

Reference template (PAPERS.md, the TensorFlow-serving design): build a
model's inference program once per input signature and keep it warm;
arbitrary request sizes land in padded power-of-two batch buckets so the
steady state never rebuilds. The scorer body is the model's own
:meth:`Model._score_raw` over a frame REBUILT from raw request columns
(:meth:`ServingSchema.build_frame`), so the serving path cannot drift from
``model.predict``.

The JAX package compiles one XLA executable per signature
(``jax.jit(raw_fn).lower(...).compile()``). Here a signature is one CUDA
graph: static input buffers ([bucket, n_num] float32, [bucket, n_cat]
int32) on the card, warm-up calls on a side stream, then
``torch.cuda.graph`` captures ``build_frame`` + ``_score_raw`` into the
model's memory pool (one ``graph_pool_handle`` per model and cache, so
dropping a model frees its buckets). :meth:`CompiledScorer.score` copies
the padded request into the static buffers, replays, and copies the
bucket's rows out to the host. Replays and captures are serialised
process-wide (``_DEVICE_LOCK``): a capture must not overlap another
thread's replay of a graph sharing its pool, and two seats never replay
one graph at once.

Signatures are ``(model key, id(model), n_num, n_cat, dtype, bucket)``. A
hit returns the warm scorer (counted); a miss captures at miss time,
outside the cache lock. A model whose ``_score_raw`` cannot be captured
(a host sync, a data-dependent shape) scores eagerly, and says so:
``mode`` reads ``"eager"`` with the capture's error in ``error``, and
:meth:`ScorerCache.stats` counts it. On the CPU (which the tests ask for)
there is nothing to capture and every scorer is ``"eager"``.

Each scorer is a ``score:<algo>`` site of the compute observatory
(``utils/costs.py``): a capture is recorded with its seconds
(``record_compile``, under ``COSTS.scope``), a model that scores eagerly
with ``record_eager_fallback``, and every ``H2O3TPU_COSTS_SAMPLE``-th
replay is observed at the time two CUDA events around it measured, read
after the copy out that the scorer waits on anyway; FLOPs and bytes come
from :func:`~h2o3_tpu_torch.utils.costs.cost_of`. The cache counts its
hits, misses and evictions into ``h2o3_scorer_cache_total``.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.serving.schema import ServingSchema
from h2o3_tpu_torch.utils import costs as _costs
from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

#: requests larger than the max bucket are scored in max-bucket slices
MAX_BUCKET = int(os.environ.get("H2O3TPU_SCORE_MAX_BUCKET", "4096"))

#: smallest bucket — tiny interactive requests share one graph
MIN_BUCKET = 8

#: warm-up calls on a side stream before a capture (the caching
#: allocator and cuBLAS settle their workspaces outside the graph)
WARMUP_CALLS = 2

#: serialises every capture and every replay of the process (see above)
_DEVICE_LOCK = threading.Lock()

#: one warm-up stream per device, reused by every capture: each new stream
#: that runs a matrix product gets a cuBLAS workspace of its own, kept for
#: the process's life
_WARMUP_STREAMS: dict = {}


def bucket_for(n: int) -> int:
    """Smallest power-of-two bucket holding ``n`` rows (clamped to
    [MIN_BUCKET, MAX_BUCKET])."""
    b = MIN_BUCKET
    while b < n and b < MAX_BUCKET:
        b <<= 1
    return b


def model_device(model, _depth: int = 0, _seen: set | None = None):
    """The device of the first tensor reachable from ``model`` (its trees,
    coefficients, weights), or None when it holds no tensor."""
    if _depth > 6 or model is None or isinstance(model, (str, bytes, int,
                                                         float, bool)):
        return None
    seen = set() if _seen is None else _seen
    if id(model) in seen:
        return None
    seen.add(id(model))
    if isinstance(model, torch.Tensor):
        return model.device
    if isinstance(model, dict):
        items = list(model.values())
    elif isinstance(model, (list, tuple)):
        items = list(model)
    elif hasattr(model, "__dict__") and not isinstance(model, type):
        items = list(vars(model).values())
    elif hasattr(model, "__slots__"):
        items = [getattr(model, s, None) for s in model.__slots__]
    else:
        return None
    for v in items:
        dev = model_device(v, _depth + 1, seen)
        if dev is not None:
            return dev
    return None


class CompiledScorer:
    """One signature's scorer: ``score(num, cat)`` over padded host arrays
    returns host predictions ([bucket] or [bucket, K])."""

    __slots__ = ("bucket", "mode", "device", "error", "capture_s", "site",
                 "_fn", "_graph", "_num", "_cat", "_out", "_ncalls",
                 "_flops", "_bytes")

    def __init__(self, model, schema: ServingSchema, bucket: int,
                 device: torch.device | None = None, pool=None):
        self.bucket = bucket
        self.error: str | None = None
        self.capture_s = 0.0
        self._graph = self._out = None
        dev = device if device is not None else (
            model_device(model) or resolve_device())
        self.device = dev

        def raw_fn(num, cat):
            frame = schema.build_frame(num, cat, bucket)
            return model._score_raw(frame)

        self._fn = raw_fn
        self._num = torch.zeros((bucket, len(schema.num_cols)),
                                dtype=torch.float32, device=dev)
        self._cat = torch.full((bucket, len(schema.cat_cols)), -1,
                               dtype=torch.int32, device=dev)
        self.mode = "eager"
        self._ncalls = 0
        site = self.site = f"score:{getattr(model, 'algo', 'model')}"
        n_num, n_cat = len(schema.num_cols), len(schema.cat_cols)
        self._flops, self._bytes = _costs.cost_of(model, bucket, n_num, n_cat)
        signature = {"args": [{"shape": [bucket, n_num], "dtype": "float32"},
                              {"shape": [bucket, n_cat], "dtype": "int32"}],
                     "statics": {"model": str(getattr(model, "key", None)),
                                 "bucket": str(bucket)}}
        if dev.type != "cuda":
            # the CPU runs the model's ops as they come: nothing captured
            if _costs.enabled():
                _costs.COSTS.record_eager_fallback(site, loop="scoring")
            return
        try:
            # captured under the site's scope: its seconds, FLOPs and
            # signature show in /3/Compute beside the training loops
            with _costs.COSTS.scope(site):
                t0 = time.perf_counter()
                self._capture(raw_fn, dev, pool)
                self.capture_s = time.perf_counter() - t0
            self.mode = "graph"
            if _costs.enabled():
                _costs.COSTS.record_compile(site, signature, self.capture_s,
                                            self._flops, self._bytes,
                                            loop="scoring")
        except Exception as e:   # noqa: BLE001 — a sync or a data shape
            # inside _score_raw: scored eagerly, never quietly (mode,
            # error and ScorerCache.stats say so)
            self._graph = self._out = None
            self.error = f"{type(e).__name__}: {e}"
            if _costs.enabled():
                _costs.COSTS.record_eager_fallback(site, loop="scoring")

    def _capture(self, raw_fn, dev: torch.device, pool) -> None:
        with _DEVICE_LOCK:
            caller = torch.cuda.current_stream(dev)
            side = _WARMUP_STREAMS.get(dev)
            if side is None:
                side = _WARMUP_STREAMS[dev] = torch.cuda.Stream(device=dev)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    raw_fn(self._num, self._cat)
            caller.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the batcher threads of other models go on
            # launching and copying on their own streams meanwhile
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = raw_fn(self._num, self._cat)
            self._graph, self._out = graph, out

    def score(self, num: np.ndarray, cat: np.ndarray) -> np.ndarray:
        return self.score_timed(num, cat)[0]

    def score_timed(self, num: np.ndarray, cat: np.ndarray
                    ) -> tuple[np.ndarray, float | None]:
        """(predictions, seconds on the card). On a card two CUDA events
        bracket the copy in and the replay — when costs are on or the ops
        plane meters tenants — and are read after the copy out, which
        waits for them anyway; None otherwise."""
        n, self._ncalls = self._ncalls, self._ncalls + 1
        timed = self.device.type == "cuda" and (
            _costs.enabled()
            or "h2o3_tpu_torch.ops_plane.tenancy" in sys.modules)
        with _DEVICE_LOCK:
            if timed:
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            self._num.copy_(torch.from_numpy(np.ascontiguousarray(num)))
            self._cat.copy_(torch.from_numpy(np.ascontiguousarray(cat)))
            if self._graph is not None:
                self._graph.replay()
                out = self._out
            else:
                out = self._fn(self._num, self._cat)
            if timed:
                end.record(stream)
            # the copy to the host waits for the replay on this stream (a
            # new host tensor; on the CPU ``out`` is new every call)
            host = out.detach().cpu().numpy()
        device_s = start.elapsed_time(end) / 1e3 if timed else None
        if device_s is not None and _costs.enabled() \
                and n % _costs.sample_every() == 0:
            # this scorer's OWN cost: several buckets and models share the
            # score:<algo> site
            _costs.COSTS.observe(self.site, device_s, flops=self._flops,
                                 nbytes=self._bytes)
        return host, device_s


class ScorerCache:
    """Thread-safe signature → :class:`CompiledScorer` cache with
    per-model grouping (evicting a model drops all its signatures and its
    graphs' memory pool)."""

    def __init__(self):
        self._lock = lockwitness.lock("serving.scorer.ScorerCache._lock")
        # (model key, id(model), n_num, n_cat, dtype, bucket) -> scorer
        self._entries: dict[tuple, CompiledScorer] = {}
        # (model key, id(model)) -> the graphs' memory pool of that model
        self._pools: dict[tuple, object] = {}
        self.hits = 0
        self.misses = 0
        self._pinned_bucket: int | None = None

    # -- bucket pinning (ops-plane recompile-storm remediation) --------------

    def pin_bucket(self, bucket: int) -> int:
        """Pin a floor bucket: requests whose natural bucket is SMALLER
        score in the pinned one instead, collapsing a storm of churning
        small signatures onto one warm graph (padding waste bounded by
        the pin). Returns the clamped pin actually installed."""
        b = MIN_BUCKET
        while b < bucket and b < MAX_BUCKET:
            b <<= 1
        with self._lock:
            self._pinned_bucket = b
        return b

    def unpin_bucket(self) -> None:
        with self._lock:
            self._pinned_bucket = None

    def pinned_bucket(self) -> "int | None":
        with self._lock:
            return self._pinned_bucket

    def bucket_for(self, n: int) -> int:
        """Bucket selection honoring the pin — the batcher's sole seam
        (module-level :func:`bucket_for` stays the pure natural law)."""
        natural = bucket_for(n)
        with self._lock:
            pin = self._pinned_bucket
        return pin if pin is not None and pin > natural else natural

    def compiled_buckets(self) -> "list[int]":
        """Distinct buckets with a captured (or eager) signature."""
        with self._lock:
            return sorted({sig[5] for sig in self._entries})

    @staticmethod
    def _signature(model, schema: ServingSchema, bucket: int) -> tuple:
        # id(model) versions the cache: a reloaded model under the same DKV
        # key is a new object and must capture against its new tensors
        return (getattr(model, "key", None), id(model),
                len(schema.num_cols), len(schema.cat_cols), "f32i32", bucket)

    def _pool_for(self, token: tuple, device: torch.device):
        with self._lock:
            pool = self._pools.get(token)
            if pool is None and device.type == "cuda":
                pool = self._pools[token] = torch.cuda.graph_pool_handle()
            return pool

    def get(self, model, schema: ServingSchema, bucket: int) -> CompiledScorer:
        sig = self._signature(model, schema, bucket)
        with self._lock:
            entry = self._entries.get(sig)
            if entry is not None:
                self.hits += 1
                _tm.SCORER_CACHE.labels(event="hit").inc()
                return entry
        # capture OUTSIDE the cache lock: a cold signature must not stall
        # warm-signature scorers for the time a warm-up and capture take
        dev = model_device(model) or resolve_device()
        entry = CompiledScorer(model, schema, bucket, device=dev,
                               pool=self._pool_for(sig[:2], dev))
        with self._lock:
            won = self._entries.setdefault(sig, entry)
            self.misses += 1
        _tm.SCORER_CACHE.labels(event="miss").inc()
        return won

    def drop_model(self, model) -> int:
        """Evict every signature of ``model`` and its pool; returns how
        many dropped (their graphs' memory returns to the allocator once
        no caller holds a scorer)."""
        token = (getattr(model, "key", None), id(model))
        with self._lock:
            victims = [s for s in self._entries if s[:2] == token]
            for s in victims:
                del self._entries[s]
            self._pools.pop(token, None)
        if victims:
            _tm.SCORER_CACHE.labels(event="evict").inc(len(victims))
        return len(victims)

    def modes(self) -> dict:
        """Each signature's mode by model key and bucket, with the capture
        error of an eager one."""
        with self._lock:
            entries = list(self._entries.items())
        out: dict = {}
        for sig, sc in sorted(entries, key=lambda kv: (str(kv[0][0]),
                                                       kv[0][5])):
            out.setdefault(str(sig[0]), []).append(
                {"bucket": sig[5], "mode": sc.mode,
                 "capture_s": sc.capture_s, "error": sc.error})
        return out

    def stats(self) -> dict:
        with self._lock:
            scorers = list(self._entries.values())
            out = {"signatures": len(scorers),
                   "hits": self.hits, "misses": self.misses,
                   "pinned_bucket": self._pinned_bucket}
        out["graph"] = sum(s.mode == "graph" for s in scorers)
        out["eager"] = len(scorers) - out["graph"]
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pools.clear()
            self.hits = self.misses = 0
