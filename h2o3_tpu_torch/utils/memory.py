"""The memory meter — the port of ``h2o3_tpu/utils/memory.py``.

Reference: ``water/MemoryManager.java`` budgets the K/V store, and CloudV3
serves each node's ``free_mem``/``max_mem``. The :class:`MemoryMeter`
counts bytes at three levels:

1. per DKV key: a frame's resident column bytes (``Frame.nbytes``), a
   model's array bytes, a raw upload's length, a spilled value's bytes on
   disk, registered at ``DKV.put``/``remove``;
2. per process and device: host RSS from ``/proc/self/status`` and the
   card's allocator counters (``torch.cuda.memory_stats()``,
   ``torch.cuda.mem_get_info()``); where no card is in use (the CPU), the
   bytes of the tensors the DKV's frames hold, as the reference falls back
   to ``jax.live_arrays()``;
3. watermarks: monotonic peaks of both.

A :class:`LeakDetector` follows the keyed bytes across the Cleaner's
sweeps and flags keys that keep growing, or that sit untouched above a
size floor, for ``H2O3TPU_LEAK_SWEEPS`` sweeps.

The port's tensors carry no padding, so a device byte is counted once per
unpadded tensor: its numbers are smaller than the JAX package's, which
counts each column at its padded length. The meter publishes the
reference's gauges (``h2o3_dkv_bytes{kind}``, ``h2o3_host_rss_bytes``,
``h2o3_device_bytes_in_use`` and their peaks), the same numbers
:meth:`MemoryMeter.summary` serves.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

#: consecutive sweeps of growth / idleness before a key is flagged
LEAK_SWEEPS = int(os.environ.get("H2O3TPU_LEAK_SWEEPS", "4"))

#: keys below this byte floor are never flagged
LEAK_MIN_BYTES = int(os.environ.get("H2O3TPU_LEAK_MIN_BYTES", str(1 << 20)))

_KB = 1024


def _tensor_bytes(t) -> int:
    return int(t.numel() * t.element_size())


def array_tree_bytes(obj, _depth: int = 0, host_only: bool = False,
                     _seen: set | None = None) -> int:
    """Summed bytes of every numpy array and tensor reachable through
    dicts, lists, tuples and object attributes (depth 8), each object
    visited once: a model's artifact size. ``host_only`` counts numpy
    arrays and CPU tensors and skips tensors on a card."""
    if _depth > 8 or obj is None:
        return 0
    if isinstance(obj, (str, bytes, int, float, bool)):
        return len(obj) if isinstance(obj, bytes) else 0
    seen = set() if _seen is None else _seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        if host_only and obj.device.type != "cpu":
            return 0
        return _tensor_bytes(obj)
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = vars(obj).values()
    else:
        return 0
    return sum(array_tree_bytes(v, _depth + 1, host_only, seen)
               for v in items)


def value_kind_bytes(value) -> tuple[str, int]:
    """(kind, bytes) of a DKV value, by type name, so the meter imports
    no frame or model module."""
    tname = type(value).__name__
    if tname in ("Frame", "SparseFrame") and hasattr(value, "nbytes"):
        return "frame", int(value.nbytes)
    if tname in ("SwappedFrame", "SwappedValue"):
        # spilled: no resident bytes; its bytes on disk stay registered so
        # the view reconciles across a sweep
        return "spilled", int(getattr(value, "disk_bytes", 0) or 0)
    if tname == "RawFile":
        return "raw", len(getattr(value, "data", b"") or b"")
    if tname == "Job":
        return "job", 0
    if hasattr(value, "algo") and hasattr(value, "output"):
        out = getattr(value, "output", None) or {}
        stamped = out.get("artifact_bytes") if isinstance(out, dict) \
            else None
        return "model", int(stamped) if stamped else array_tree_bytes(value)
    return "other", 0


def value_host_bytes(value) -> int:
    """The host-resident part of a DKV value: a frame's host values and
    compressed payloads, a raw upload's bytes and a model's host arrays;
    tensors on the card are left out."""
    if type(value).__name__ == "Frame":
        total = 0
        for v in getattr(value, "vecs", []):
            host = getattr(v, "host_values", None)
            if host is not None:
                total += int(getattr(host, "nbytes", 0))
            comp = getattr(v, "compressed", None)
            if comp is not None:
                total += int(comp.nbytes)
        return total
    kind, nbytes = value_kind_bytes(value)
    if kind == "raw":
        return nbytes
    if kind == "model":
        return array_tree_bytes(value, host_only=True)
    return 0


def vec_nbytes(vec) -> int:
    """One column's resident bytes (:attr:`Vec.nbytes`: its tensor if it
    exists now, never built for the count, its compressed payload and its
    host values)."""
    return int(vec.nbytes)


def host_stats() -> dict:
    """Process and machine memory from /proc: rss_bytes, rss_peak_bytes
    (VmHWM), total_bytes, available_bytes; zeros where /proc is
    unreadable."""
    out = {"rss_bytes": 0, "rss_peak_bytes": 0,
           "total_bytes": 0, "available_bytes": 0}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * _KB
                elif line.startswith("VmHWM:"):
                    out["rss_peak_bytes"] = int(line.split()[1]) * _KB
    except (OSError, ValueError, IndexError):
        pass
    if out["rss_peak_bytes"] < out["rss_bytes"]:
        out["rss_peak_bytes"] = out["rss_bytes"]
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    out["total_bytes"] = int(line.split()[1]) * _KB
                elif line.startswith("MemAvailable:"):
                    out["available_bytes"] = int(line.split()[1]) * _KB
    except (OSError, ValueError, IndexError):
        pass
    return out


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_stats() -> dict:
    """The card's memory: the caching allocator's bytes in use, its peak
    and the card's total, from ``torch.cuda.memory_stats()`` and
    ``mem_get_info()``. Without a card in use, the bytes of the tensors
    the DKV's frames hold (``source`` names which ran)."""
    if _cuda_in_use():
        devices = []
        total = peak = limit = 0
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            in_use = int(ms.get("allocated_bytes.all.current", 0))
            d_peak = int(ms.get("allocated_bytes.all.peak", in_use))
            d_limit = int(torch.cuda.mem_get_info(i)[1])
            devices.append({"device": f"cuda:{i}", "bytes_in_use": in_use,
                            "peak_bytes_in_use": d_peak,
                            "bytes_limit": d_limit,
                            "reserved_bytes": int(ms.get(
                                "reserved_bytes.all.current", 0))})
            total += in_use
            peak += d_peak
            limit += d_limit
        return {"source": "memory_stats", "bytes_in_use": total,
                "peak_bytes_in_use": peak, "bytes_limit": limit,
                "devices": devices}
    per: dict[str, int] = {}
    for t in _keyed_tensors():
        per[str(t.device)] = per.get(str(t.device), 0) + _tensor_bytes(t)
    return {"source": "keyed_tensors", "bytes_in_use": sum(per.values()),
            "peak_bytes_in_use": 0, "bytes_limit": 0,
            "devices": [{"device": k, "bytes_in_use": v,
                         "peak_bytes_in_use": 0, "bytes_limit": 0}
                        for k, v in sorted(per.items())]}


def _keyed_tensors() -> list[torch.Tensor]:
    """Each distinct tensor the DKV's frames hold now, once (columns
    sliced out of one upload share their storage and count apart, as
    views of their own bytes)."""
    from h2o3_tpu_torch.utils.registry import DKV
    seen: dict[int, torch.Tensor] = {}
    for _k, value in DKV.raw_items():
        for v in getattr(value, "vecs", None) or ():
            t = getattr(v, "_data", None)
            if isinstance(t, torch.Tensor):
                seen[id(t)] = t
    return list(seen.values())


def fast_device_bytes() -> tuple[int, int] | None:
    """(bytes in use, peak) of the cards, or None without a card in use:
    the allocator's counters, cheap enough for a hot path."""
    if not _cuda_in_use():
        return None
    total = peak = 0
    for i in range(torch.cuda.device_count()):
        total += int(torch.cuda.memory_allocated(i))
        peak += int(torch.cuda.max_memory_allocated(i))
    return total, peak


class LeakDetector:
    """Flags keys whose bytes grow, or that sit resident and untouched,
    for ``sweeps`` consecutive sweeps, at or above ``min_bytes``."""

    def __init__(self, sweeps: int = LEAK_SWEEPS,
                 min_bytes: int = LEAK_MIN_BYTES):
        self.sweeps = max(int(sweeps), 1)
        self.min_bytes = int(min_bytes)
        self.generation = 0
        # key -> {"kind", "bytes", "grow", "idle"}
        self._state: dict[str, dict] = {}

    def observe(self, keyed: dict[str, tuple[str, int]],
                accessed: set[str]) -> None:
        self.generation += 1
        for k in set(self._state) - set(keyed):
            del self._state[k]
        for key, (kind, nbytes) in keyed.items():
            st = self._state.get(key)
            if st is None:
                self._state[key] = {"kind": kind, "bytes": nbytes,
                                    "grow": 0, "idle": 0}
                continue
            st["grow"] = st["grow"] + 1 if nbytes > st["bytes"] else 0
            st["idle"] = 0 if key in accessed else st["idle"] + 1
            st["bytes"] = nbytes
            st["kind"] = kind

    def report(self) -> list[dict]:
        """Flagged keys, largest first."""
        out = []
        for key, st in self._state.items():
            if st["bytes"] < self.min_bytes:
                continue
            reasons = []
            if st["grow"] >= self.sweeps:
                reasons.append("growing")
            if st["idle"] >= self.sweeps:
                reasons.append("idle")
            if reasons:
                out.append({"key": key, "kind": st["kind"],
                            "bytes": st["bytes"],
                            "growth_sweeps": st["grow"],
                            "idle_sweeps": st["idle"], "reasons": reasons})
        out.sort(key=lambda r: -r["bytes"])
        return out

    def reset(self) -> None:
        self.generation = 0
        self._state.clear()


class MemoryMeter:
    """Thread-safe byte accountant; one instance, :data:`MEMORY`. The DKV
    registers keys on put and remove, the Cleaner advances the leak
    sweeps."""

    def __init__(self):
        self._lock = lockwitness.lock("utils.memory.MemoryMeter._lock")
        # key -> (kind, bytes, host_bytes)
        self._keyed: dict[str, tuple[str, int, int]] = {}
        self._by_kind: dict[str, int] = {}
        self._host_total = 0
        self._accessed: set[str] = set()
        self._host_peak = 0
        self._device_peak = 0
        self._exported_kinds: set[str] = set()
        self.detector = LeakDetector()

    def register(self, key: str, value) -> None:
        kind, nbytes = value_kind_bytes(value)
        host = value_host_bytes(value)
        with self._lock:
            self._set_locked(key, kind, nbytes, host)
            self._accessed.add(key)
            self._export_locked()

    def unregister(self, key: str) -> None:
        with self._lock:
            self._drop_locked(key)
            self._accessed.discard(key)
            self._export_locked()

    def clear(self) -> None:
        with self._lock:
            self._keyed.clear()
            self._by_kind.clear()
            self._host_total = 0
            self._accessed.clear()
            self.detector.reset()
            self._export_locked()

    def _export_locked(self) -> None:
        """Push per-kind totals into the ``h2o3_dkv_bytes`` gauges while
        holding the meter's lock, so a later total is never published
        before an earlier one; kinds exported before but absent now are
        written as 0."""
        totals = dict(self._by_kind)
        stale = self._exported_kinds - set(totals)
        self._exported_kinds |= set(totals)
        for kind, total in totals.items():
            _tm.DKV_BYTES.labels(kind=kind).set(max(total, 0))
        for kind in stale:
            _tm.DKV_BYTES.labels(kind=kind).set(0)

    def note_access(self, key: str) -> None:
        """A DKV get touched the key: its idle streak ends at the next
        sweep."""
        with self._lock:
            self._accessed.add(key)

    def _set_locked(self, key: str, kind: str, nbytes: int,
                    host: int) -> None:
        self._drop_locked(key)
        self._keyed[key] = (kind, nbytes, host)
        self._by_kind[kind] = self._by_kind.get(kind, 0) + nbytes
        self._host_total += host

    def _drop_locked(self, key: str) -> None:
        old = self._keyed.pop(key, None)
        if old is not None:
            self._by_kind[old[0]] -= old[1]
            self._host_total -= old[2]

    def refresh(self) -> None:
        """Count every key's bytes again from the live DKV values (catches
        a column added to a resident frame), under the store's lock so a
        concurrent remove is not brought back (store, then meter)."""
        from h2o3_tpu_torch.utils.registry import DKV
        with DKV._lock:
            fresh = {key: (*value_kind_bytes(value),
                           value_host_bytes(value))
                     for key, value in DKV._store.items()}
            with self._lock:
                self._keyed = fresh
                self._by_kind = {}
                self._host_total = 0
                for kind, nbytes, host in fresh.values():
                    self._by_kind[kind] = self._by_kind.get(kind, 0) + nbytes
                    self._host_total += host
                self._export_locked()

    def sample(self, rss: int | None = None,
               dev: int | None = None) -> tuple[int, int]:
        """(host RSS, device bytes in use), raising the monotonic peaks.
        On a card the device bytes are the allocator's counters
        (:func:`fast_device_bytes`): a build samples twice, and
        ``device_stats``' ``mem_get_info`` costs milliseconds a call."""
        if rss is None:
            rss = host_stats()["rss_bytes"]
        if dev is None:
            fast = fast_device_bytes()
            dev = fast[0] if fast is not None else \
                device_stats()["bytes_in_use"]
        # peaks raised AND published under the lock, so the monotonic
        # gauges never visibly decrease
        with self._lock:
            self._host_peak = max(self._host_peak, rss)
            self._device_peak = max(self._device_peak, dev)
            _tm.HOST_RSS_BYTES.set(rss)
            _tm.DEVICE_BYTES.set(dev)
            _tm.HOST_RSS_PEAK_BYTES.set(self._host_peak)
            _tm.DEVICE_PEAK_BYTES.set(self._device_peak)
        return rss, dev

    @property
    def watermarks(self) -> dict:
        with self._lock:
            return {"host_rss_peak_bytes": self._host_peak,
                    "device_peak_bytes": self._device_peak}

    def leak_sweep(self) -> None:
        """Advance one leak-detector generation over the registered bytes
        (the Cleaner calls it on every budgeted sweep, so it stays
        O(keys))."""
        with self._lock:
            keyed = {k: (kind, nbytes)
                     for k, (kind, nbytes, _host) in self._keyed.items()}
            accessed = set(self._accessed)
            self._accessed.clear()
            self.detector.observe(keyed, accessed)

    def idle_streaks(self) -> dict[str, int]:
        """Per key, the sweeps in a row without a DKV access: the
        Cleaner's first measure of coldness."""
        with self._lock:
            return {k: st["idle"] for k, st in self.detector._state.items()}

    def leak_report(self) -> dict:
        with self._lock:
            return {"sweeps": self.detector.generation,
                    "flag_after_sweeps": self.detector.sweeps,
                    "min_bytes": self.detector.min_bytes,
                    "flagged": self.detector.report()}

    def dkv_totals(self) -> tuple[int, dict[str, int], int]:
        """(total bytes, bytes by kind, key count) of the registered
        view."""
        with self._lock:
            by_kind = dict(self._by_kind)
            n = len(self._keyed)
        return sum(by_kind.values()), by_kind, n

    def dkv_host_bytes(self) -> int:
        with self._lock:
            return max(self._host_total, 0)

    def key_bytes(self, key: str) -> int:
        with self._lock:
            rec = self._keyed.get(key)
            return rec[1] if rec is not None else 0

    def top_keys(self, n: int = 10) -> list[dict]:
        with self._lock:
            rows = [{"key": k, "kind": kind, "bytes": b}
                    for k, (kind, b, _host) in self._keyed.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:n]

    def summary(self, top_n: int = 10, refresh: bool = True) -> dict:
        """Host and device numbers, keyed totals, the largest keys,
        watermarks, the leak report and the Cleaner's spill view (the
        reference's ``/3/Memory``)."""
        if refresh:
            self.refresh()
        host = host_stats()
        dev = device_stats()
        self.sample(rss=host["rss_bytes"], dev=dev["bytes_in_use"])
        total, by_kind, nkeys = self.dkv_totals()
        from h2o3_tpu_torch.utils.cleaner import CLEANER
        return {"host": host, "device": dev,
                "dkv": {"total_bytes": total, "by_kind": by_kind,
                        "keys": nkeys},
                "top_keys": self.top_keys(top_n),
                "watermarks": self.watermarks,
                "leaks": self.leak_report(),
                "spill": CLEANER.stats()}


#: the process-wide meter (reference: the MemoryManager singleton)
MEMORY = MemoryMeter()
