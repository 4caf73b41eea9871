"""Keyed object registry (the DKV) and its key locks — the port of
``h2o3_tpu/utils/registry.py``.

Reference: ``water/DKV.java`` + ``water/Key.java``. One process holds every
frame, model, grid and segment-models object a user addresses by key; the
port's store is a process-local name → object dict behind one lock, as the
JAX package's is.

Every ``put`` registers the key's bytes with the memory meter
(:data:`h2o3_tpu_torch.utils.memory.MEMORY`) and, for frames and raw
uploads, lets the Cleaner (:mod:`h2o3_tpu_torch.utils.cleaner`) sweep
under its budget; ``get`` faults a spilled value back in and notes the
access; ``remove`` and ``clear`` unregister and delete spilled snapshots.
The meter and the Cleaner are imported at call time: they import this
module. Lock order: the store's lock, then the meter's; the Cleaner's I/O
lock is taken before the store's and never inside it.

Every operation counts into ``h2o3_dkv_puts``/``_gets``/``_removes`` and
sets ``h2o3_dkv_keys``; with the ops plane loaded, a put tags the key to the
request's tenant (its byte ledger) and a remove untags it. The locks are
the reference's named ones (``utils/lockwitness.py``). Left out: the mesh
views a keyed frame registers (``{key}::mesh[...]``): one card has no
mesh.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Any, Iterator

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

#: the Cleaner's stubs of spilled values, and the values it may spill
_STUBS = ("SwappedFrame", "SwappedValue")
_SPILLABLE = ("Frame", "RawFile")


def _tenancy():
    """The ops plane's tenancy module ONLY if already imported — processes
    that tag nothing do not pay its import on the DKV's hot path."""
    return sys.modules.get("h2o3_tpu_torch.ops_plane.tenancy")


class KeyedStore:
    """Name → object store (reference: the DKV singleton)."""

    def __init__(self):
        self._lock = lockwitness.rlock("utils.registry.KeyedStore._lock")
        self._store: dict[str, Any] = {}

    def put(self, key: str | None, value: Any) -> str | None:
        if key is None:
            return None
        from h2o3_tpu_torch.utils.memory import MEMORY
        with self._lock:
            old = self._store.get(key)
            self._store[key] = value
            n = len(self._store)
            # inside the store's lock: a racing remove must not leave the
            # meter counting a key the store no longer holds
            MEMORY.register(key, value)
        _tm.DKV_PUTS.inc()
        _tm.DKV_KEYS.set(n)
        ten = _tenancy()
        if ten is not None:
            # the byte ledger attributes this key to whoever the request
            # context says is putting it
            ten.QUOTAS.tag_key(key)
        if old is not None and old is not value \
                and type(old).__name__ in _STUBS:
            # a put over a spilled key retires its snapshot
            from h2o3_tpu_torch.utils.cleaner import CLEANER, discard_snapshot
            discard_snapshot(old.path)
            CLEANER.forget(key)
        if type(value).__name__ in _SPILLABLE:
            from h2o3_tpu_torch.utils.cleaner import CLEANER
            CLEANER.touch(key)
            CLEANER.sweep(protect=key)
        return key

    def replace_if(self, key: str, expected: Any, value: Any) -> bool:
        """Atomic compare-and-swap: install ``value`` only while the store
        still holds ``expected`` (by identity). It registers the bytes but
        runs no sweep: the Cleaner's spill and fault-in call it holding
        their I/O lock, and sweep themselves outside the store's lock."""
        from h2o3_tpu_torch.utils.memory import MEMORY
        with self._lock:
            if self._store.get(key) is not expected:
                return False
            self._store[key] = value
            n = len(self._store)
            MEMORY.register(key, value)
        _tm.DKV_PUTS.inc()
        _tm.DKV_KEYS.set(n)
        return True

    def _resolve(self, key: str, value: Any) -> Any:
        """A spilled value faulted back in; a live frame or upload touched
        on the LRU clock."""
        tname = type(value).__name__
        if tname in _STUBS:
            from h2o3_tpu_torch.utils.cleaner import CLEANER
            return (CLEANER.resolve(key, value) if tname == "SwappedFrame"
                    else CLEANER.resolve_value(key, value))
        if tname in _SPILLABLE:
            from h2o3_tpu_torch.utils.cleaner import CLEANER
            if CLEANER.budget is not None:
                CLEANER.touch(key)
        return value

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            v = self._store.get(key, default)
        _tm.DKV_GETS.inc()
        if v is None:
            return v
        from h2o3_tpu_torch.utils.memory import MEMORY
        MEMORY.note_access(key)    # ends the key's idle streak
        return self._resolve(key, v)

    def __getitem__(self, key: str) -> Any:
        with self._lock:
            v = self._store[key]
        _tm.DKV_GETS.inc()
        from h2o3_tpu_torch.utils.memory import MEMORY
        MEMORY.note_access(key)
        return self._resolve(key, v)

    def remove(self, key: str, *, only_if: Any = None) -> Any:
        """Remove ``key`` and return its value (None if absent or
        spilled); with ``only_if``, only while the store still holds that
        exact object. A spilled key's snapshot is deleted."""
        from h2o3_tpu_torch.utils.cleaner import CLEANER, discard_snapshot
        from h2o3_tpu_torch.utils.memory import MEMORY
        with self._lock:
            if only_if is not None and self._store.get(key) is not only_if:
                return None
            v = self._store.pop(key, None)
            n = len(self._store)
            MEMORY.unregister(key)
        _tm.DKV_REMOVES.inc()
        _tm.DKV_KEYS.set(n)
        ten = _tenancy()
        if ten is not None:
            ten.QUOTAS.untag_key(key)
        CLEANER.forget(key)
        if type(v).__name__ in _STUBS:
            discard_snapshot(v.path)
            return None
        return v

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._store.keys())

    def raw_items(self) -> list[tuple[str, Any]]:
        """A snapshot of (key, value) pairs."""
        with self._lock:
            return list(self._store.items())

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def clear(self) -> None:
        from h2o3_tpu_torch.utils.cleaner import CLEANER, discard_snapshot
        from h2o3_tpu_torch.utils.memory import MEMORY
        with self._lock:
            items = list(self._store.values())
            self._store.clear()
            MEMORY.clear()
        _tm.DKV_REMOVES.inc(len(items))
        _tm.DKV_KEYS.set(0)
        for v in items:
            if type(v).__name__ in _STUBS:
                discard_snapshot(v.path)
        CLEANER.forget_all()


class KeyLocks:
    """Key-level read/write locks (reference: ``water/Lockable.java``): a
    build write-locks its destination model key, so a concurrent delete or
    a second build into the same key waits for it.

    Readers are shared and never blocked by waiting writers (a thread that
    holds a read lock may take more); a writer needs exclusivity but
    re-enters in its own thread. Unknown keys lock fine. Every acquisition,
    a mixed write and read set included, goes through one :meth:`locked`
    call that takes its keys in one global sort order, so multi-key users
    cannot deadlock one another. Waits are bounded (1 s) and re-check
    their predicate, so a lost notify costs a second, not a hang.
    """

    def __init__(self):
        self._cond = lockwitness.condition(
            "utils.registry.KeyLocks._cond", lock=threading.Lock())
        # key -> [readers, writer thread ident | None, writer depth]
        self._state: dict[str, list] = {}

    def _entry(self, key: str) -> list:
        return self._state.setdefault(key, [0, None, 0])

    def _gc(self, key: str) -> None:
        st = self._state.get(key)
        if st is not None and st[0] == 0 and st[1] is None:
            del self._state[key]

    @contextlib.contextmanager
    def locked(self, write=(), read=()):
        """Write locks on ``write`` and read locks on ``read``, all taken in
        one globally sorted pass. None keys are skipped; a key in both
        sets locks as write."""
        wset = {k for k in write if k}
        rset = {k for k in read if k} - wset
        plan = sorted([(k, True) for k in wset] + [(k, False) for k in rset])
        me = threading.get_ident()
        with self._cond:
            for k, is_write in plan:
                st = self._entry(k)
                if is_write:
                    while (st[1] is not None and st[1] != me) or \
                            (st[1] is None and st[0] > 0):
                        self._cond.wait(timeout=1.0)
                        st = self._entry(k)
                    st[1] = me
                    st[2] += 1
                else:
                    while st[1] is not None and st[1] != me:
                        self._cond.wait(timeout=1.0)
                        st = self._entry(k)
                    st[0] += 1
        try:
            yield
        finally:
            with self._cond:
                for k, is_write in plan:
                    st = self._entry(k)
                    if is_write:
                        st[2] -= 1
                        if st[2] == 0:
                            st[1] = None
                    else:
                        st[0] -= 1
                    self._gc(k)
                self._cond.notify_all()

    def read(self, *keys: str | None):
        return self.locked(read=keys)

    def write(self, *keys: str | None):
        return self.locked(write=keys)


#: the process's registry and its key locks
DKV = KeyedStore()
LOCKS = KeyLocks()
