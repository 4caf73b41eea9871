"""Keyed object registry (the DKV) and its key locks — the port of
``h2o3_tpu/utils/registry.py``.

Reference: ``water/DKV.java`` + ``water/Key.java``. One process holds every
frame, model, grid and segment-models object a user addresses by key; the
port's store is a process-local name → object dict behind one lock, as the
JAX package's is.

Left out, each with the part of the port that will bring it:

- ``MEMORY`` metering of the bytes a key holds (``utils/memory.py``) and
  the Cleaner's spill to disk, fault-in of swapped values and its LRU
  sweep (``utils/cleaner.py``): the data plane's memory manager.
- The mesh views a keyed frame registers (``{key}::mesh[...]``): one card
  has no mesh.
- Telemetry counters (``DKV_PUTS``, ``DKV_KEYS``, ...) and the ops plane's
  per-tenant key tagging: observability and ops.
- The lock-order witness (``utils/lockwitness.py``): plain ``threading``
  locks stand in for its named locks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator


class KeyedStore:
    """Name → object store (reference: the DKV singleton)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._store: dict[str, Any] = {}

    def put(self, key: str | None, value: Any) -> str | None:
        if key is None:
            return None
        with self._lock:
            self._store[key] = value
        return key

    def replace_if(self, key: str, expected: Any, value: Any) -> bool:
        """Atomic compare-and-swap: install ``value`` only while the store
        still holds ``expected`` (by identity)."""
        with self._lock:
            if self._store.get(key) is not expected:
                return False
            self._store[key] = value
        return True

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._store.get(key, default)

    def __getitem__(self, key: str) -> Any:
        with self._lock:
            return self._store[key]

    def remove(self, key: str, *, only_if: Any = None) -> Any:
        """Remove ``key`` and return its value (None if absent); with
        ``only_if``, only while the store still holds that exact object."""
        with self._lock:
            if only_if is not None and self._store.get(key) is not only_if:
                return None
            return self._store.pop(key, None)

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
        with self._lock:
            self._store.clear()


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
        self._cond = threading.Condition(threading.Lock())
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
