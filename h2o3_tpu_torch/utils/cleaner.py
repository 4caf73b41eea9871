"""The Cleaner — spill of cold DKV values under a memory budget — the port
of ``h2o3_tpu/utils/cleaner.py``.

Reference: ``water/Cleaner.java`` writes the least recently used DKV values
to the ice_root when memory runs short and reloads them on the next access
(``water/Value.java``'s spill state); ``water/MemoryManager.java`` keeps
the budget. A sweep evicts in two tiers, cheapest first:

1. **Derived-view drop.** A compressed column's tensor is a view of its
   host payload (:mod:`h2o3_tpu_torch.ingest.encode`): dropping it frees
   device bytes at no I/O, and the next access builds it again.
2. **Per-value spill.** Cold frames and raw uploads go to the ice_root; the
   key holds a :class:`SwappedFrame` or :class:`SwappedValue` stub whose
   bytes on disk stay registered under the ``spilled`` kind. ``DKV.get``
   faults a stub back in and sweeps again.

The reference's middle tier drops the resharded mesh views a frame
registers in the DKV; one card has no mesh views, so the port has no such
tier. Victims are ordered by the memory meter's idle streaks (sweeps
without a DKV access), then by the LRU clock.

Lock order: the I/O lock (re-entrant, since a fault-in's own ``put``
sweeps again) is taken before the store's lock and never after it; the
stub's compare-and-swap and ``DKV.remove(key, only_if=...)`` take the
store's lock inside.

Enable with :func:`enable_cleaner` or ``H2O3TPU_HBM_BUDGET`` (bytes; off
by default).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
import uuid

from h2o3_tpu_torch.utils.registry import DKV


def discard_snapshot(path: str) -> None:
    """Delete a spill artifact (a frame snapshot is a folder, a raw spill
    a file), under the I/O lock so a discard never pulls a snapshot from
    under a fault-in that is reading it."""
    with CLEANER._io_lock:
        with contextlib.suppress(OSError):
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)


class SwappedFrame:
    """DKV stub for a spilled frame (reference: Value on-disk state); it
    remembers the device the frame goes back to."""

    def __init__(self, key: str, path: str, nrows: int, ncols: int,
                 disk_bytes: int = 0, device=None):
        self.key = key
        self.path = path
        self.nrows = nrows
        self.ncols = ncols
        self.disk_bytes = int(disk_bytes)
        self.device = device

    def __repr__(self) -> str:
        return f"SwappedFrame({self.key} @ {self.path})"


class SwappedValue:
    """DKV stub for a spilled non-frame value (a RawFile's bytes)."""

    def __init__(self, key: str, path: str, value_kind: str,
                 disk_bytes: int, meta: dict | None = None):
        self.key = key
        self.path = path
        self.value_kind = value_kind
        self.disk_bytes = int(disk_bytes)
        self.meta = meta or {}

    def __repr__(self) -> str:
        return f"SwappedValue({self.key} [{self.value_kind}] @ {self.path})"


class Cleaner:
    def __init__(self, budget_bytes: int | None = None,
                 ice_root: str | None = None):
        env = os.environ.get("H2O3TPU_HBM_BUDGET")
        self.budget = budget_bytes if budget_bytes is not None else (
            int(env) if env else None)
        self.ice_root = ice_root or os.path.join(
            tempfile.gettempdir(), "h2o3_tpu_ice")
        # the LRU clock, written from every DKV put/get/remove thread
        self._lock = threading.Lock()
        self._touch: dict[str, float] = {}
        # serializes the sweep's snapshot writes against fault-in reads;
        # re-entrant because a fault-in's own DKV.put sweeps again
        self._io_lock = threading.RLock()
        # spill and restore counts (the ``spill`` view of the summary)
        self._spills = 0
        self._spill_bytes = 0
        self._restores = 0
        self._restore_bytes = 0
        self._view_drops = 0
        self._view_drop_bytes = 0

    # -- bookkeeping ---------------------------------------------------------

    @staticmethod
    def _value_bytes(v) -> int:
        """Resident bytes of a frame (building no compressed column's
        view) or of a raw upload."""
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.parse import RawFile
        if isinstance(v, Frame):
            return int(v.nbytes)
        if isinstance(v, RawFile):
            return len(v.data or b"")
        return 0

    def touch(self, key: str) -> None:
        with self._lock:
            self._touch[key] = time.monotonic()

    def forget(self, key: str) -> None:
        """Drop LRU state for a removed key (DKV.remove calls this)."""
        with self._lock:
            self._touch.pop(key, None)

    def forget_all(self) -> None:
        """Drop all LRU state (DKV.clear calls this)."""
        with self._lock:
            self._touch.clear()

    def last_touched(self, key: str) -> float:
        with self._lock:
            return self._touch.get(key, 0.0)

    def _spillable_values(self):
        """(key, value) for every DKV value the sweeper may evict: frames
        and raw upload payloads, never jobs/models/stubs."""
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.parse import RawFile
        out = []
        for k, v in DKV.raw_items():
            if isinstance(v, (Frame, RawFile)):
                out.append((k, v))
        return out

    def stats(self) -> dict:
        """The spill view (the reference's ``/3/Memory`` ``spill``):
        budget, counters, and what sits on disk now."""
        spilled = []
        for k, v in DKV.raw_items():
            if isinstance(v, (SwappedFrame, SwappedValue)):
                spilled.append({"key": k, "disk_bytes": v.disk_bytes,
                                "kind": getattr(v, "value_kind", "frame")})
        with self._lock:
            return {"budget_bytes": self.budget, "ice_root": self.ice_root,
                    "spill_count": self._spills,
                    "spill_bytes": self._spill_bytes,
                    "restore_count": self._restores,
                    "restore_bytes": self._restore_bytes,
                    "view_drops": self._view_drops,
                    "view_drop_bytes": self._view_drop_bytes,
                    "spilled_keys": sorted(spilled,
                                           key=lambda r: -r["disk_bytes"]),
                    "spilled_disk_bytes": sum(r["disk_bytes"]
                                              for r in spilled)}

    # -- sweep ---------------------------------------------------------------

    def _cold_order(self, items):
        """Victim order: longest idle streak first (the memory meter's leak
        detector), then least recently touched."""
        from h2o3_tpu_torch.utils.memory import MEMORY
        idle = MEMORY.idle_streaks()
        return sorted(items,
                      key=lambda kv: (-idle.get(kv[0], 0),
                                      self.last_touched(kv[0])))

    def sweep(self, protect: str | None = None) -> list[str]:
        """Evict cold values until the resident bytes are under budget;
        returns the spilled keys. The first tier drops compressed columns'
        derived tensors (no I/O), the second spills whole values to the
        ice_root behind stubs."""
        if self.budget is None:
            return []
        # each budgeted sweep advances one leak-detector generation
        from h2o3_tpu_torch.utils.memory import MEMORY
        MEMORY.leak_sweep()
        values = self._spillable_values()
        total = sum(self._value_bytes(v) for _, v in values)
        if total <= self.budget:
            return []
        for k, v in self._cold_order(values):
            if total <= self.budget or k == protect:
                continue
            drop = getattr(v, "drop_device_views", None)
            if drop is None:
                continue
            freed = drop()
            if freed:
                total -= freed
                with self._lock:
                    self._view_drops += 1
                    self._view_drop_bytes += freed
                MEMORY.register(k, v)   # count the slimmer frame
        if total <= self.budget:
            return []
        os.makedirs(self.ice_root, exist_ok=True)
        spilled = []
        with self._io_lock:    # never rewrite a snapshot a fault-in reads
            for k, v in self._cold_order(values):
                if total <= self.budget:
                    break
                if k == protect:
                    continue
                with DKV._lock:    # raw read: is this value still current?
                    if DKV._store.get(k) is not v:
                        continue   # put, removed or restored since
                nbytes = self._value_bytes(v)
                if self._spill_one(k, v):
                    total -= nbytes
                    spilled.append(k)
        return spilled

    def force_spill(self, keys, limit: int = 2) -> list[str]:
        """Spill the named DKV keys whatever the budget's headroom (the
        data waits on disk behind a stub; the next get faults it back).
        Only frames and raw uploads spill, at most ``limit`` of them;
        returns the keys spilled."""
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.parse import RawFile
        os.makedirs(self.ice_root, exist_ok=True)
        spilled: list[str] = []
        with self._io_lock:
            for k in keys:
                if len(spilled) >= limit:
                    break
                with DKV._lock:
                    v = DKV._store.get(k)
                if isinstance(v, (Frame, RawFile)) and self._spill_one(k, v):
                    spilled.append(k)
        return spilled

    def _spill_one(self, key: str, value) -> bool:
        """Write ``value`` under the ice_root (a unique path per spill: a
        restored key's snapshot is discarded after the install, and a new
        spill must never share it) and put its stub in by
        compare-and-swap; the caller holds the I/O lock."""
        from h2o3_tpu_torch.frame.parse import RawFile
        from h2o3_tpu_torch.persist.frame_io import save_frame, snapshot_bytes
        if isinstance(value, RawFile):
            path = os.path.join(self.ice_root,
                                f"{key}.{uuid.uuid4().hex[:8]}.raw")
            with open(path, "wb") as fh:
                fh.write(value.data)
            stub = SwappedValue(key, path, "raw", len(value.data),
                                meta={"name": value.name})
            kind, nbytes = "raw", len(value.data)
        else:
            nbytes = self._value_bytes(value)
            path = os.path.join(self.ice_root,
                                f"{key}.{uuid.uuid4().hex[:8]}")
            save_frame(value, path)
            stub = SwappedFrame(key, path, value.nrows, value.ncols,
                                disk_bytes=snapshot_bytes(path),
                                device=value.device)
            kind = "frame"
        if not self._cas_stub(key, value, stub):
            return False     # the key changed during the write: no spill
        self._note_spill(kind, nbytes)
        return True

    def _cas_stub(self, key: str, expected, stub) -> bool:
        """Install a spill stub ONLY while the store still holds the value
        the snapshot was taken from. The snapshot write happens outside the
        store lock (it's slow), so a concurrent put of a NEW value under
        the same key must win — otherwise the stub would resurrect stale
        data on the next fault-in (lost update)."""
        if not DKV.replace_if(key, expected, stub):
            discard_snapshot(stub.path)
            return False
        return True

    def _note_spill(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self._spills += 1
            self._spill_bytes += nbytes

    def _note_restore(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self._restores += 1
            self._restore_bytes += nbytes

    def _resolve_loop(self, key: str, stub, live_type, load, kind: str):
        """Shared fault-in driver: load the snapshot under the IO lock,
        CAS the restored value in, and on a lost race ADOPT whatever
        superseded our stub — a live value wins outright, a NEWER stub
        (the key was re-put and re-spilled mid-restore) is resolved in its
        place (never hand back the stale load), and a concurrent remove is
        honored (the load is returned but never resurrected). Bounded —
        under pathological thrash the latest load is still correct data
        for the caller."""
        value = None
        for _ in range(8):
            with self._io_lock:
                with DKV._lock:
                    cur = DKV._store.get(key)
                if isinstance(cur, live_type):
                    return cur            # racing restore/user-put won
                if isinstance(cur, (SwappedFrame, SwappedValue)) \
                        and cur is not stub:
                    stub = cur            # newer spill superseded ours
                elif cur is None and value is not None:
                    return value          # removed mid-restore: honor it
                try:
                    value = load(stub)
                except OSError:
                    # the key was removed AND its snapshot discarded before
                    # we got the IO lock — the key is simply gone
                    return value
            if DKV.replace_if(key, stub, value):
                self._note_restore(kind, self._value_bytes(value)
                                   or getattr(stub, "disk_bytes", 0))
                discard_snapshot(stub.path)   # store owns the data again
                self.touch(key)
                self.sweep(protect=key)
                return value
        return value

    def resolve(self, key: str, stub: SwappedFrame):
        """Fault a spilled frame back in (sweeping others to stay under
        budget). Serialized against sweeps via the IO lock, and installed
        by compare-and-swap: a racing restore/user-put wins — never hand
        back a torn load, never resurrect stale data."""
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.persist.frame_io import load_frame

        def load(st):
            fr = load_frame(st.path, device=st.device)
            fr.key = key
            return fr

        return self._resolve_loop(key, stub, Frame, load, "frame")

    def resolve_value(self, key: str, stub: SwappedValue):
        """Fault a spilled non-frame value back in."""
        if stub.value_kind != "raw":
            raise ValueError(f"unknown spilled value kind {stub.value_kind!r}")
        from h2o3_tpu_torch.frame.parse import RawFile

        def load(st):
            with open(st.path, "rb") as fh:
                return RawFile(fh.read(), name=st.meta.get("name", "upload"))

        return self._resolve_loop(key, stub, RawFile, load, "raw")


CLEANER = Cleaner()


def enable_cleaner(budget_bytes: int, ice_root: str | None = None) -> Cleaner:
    """Turn on automatic spill with the given resident-byte budget."""
    CLEANER.budget = int(budget_bytes)
    if ice_root:
        CLEANER.ice_root = ice_root
    return CLEANER


def disable_cleaner() -> None:
    CLEANER.budget = None
