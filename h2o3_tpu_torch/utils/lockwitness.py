"""Runtime lock-order witness — the port of
``h2o3_tpu/utils/lockwitness.py``.

Opt-in (``H2O3TPU_LOCKWITNESS=1``): the factories below return plain
``threading`` primitives when the witness is unarmed — zero overhead, no
wrapper in the hot path — and instrumented wrappers when armed.  Armed
wrappers record, per thread, the actual acquisition order of every
witnessed lock:

- **dynamic edges** — each (held, newly-acquired) pair actually executed;
- **inversions** — both orientations of a pair observed (the runtime
  shadow of a lock-order cycle);
- **held-by-thread** — live held-lock sets, fed to the blackbox thread
  dump so a wedge post-mortem shows who holds what.

The JAX package's static analyzer (``h2o3_tpu.tools.lockorder``) and this
module share one identity scheme — the literal name passed to a factory is
the lock's identity — so a witnessed run of the port can be checked against
a static lock graph (:meth:`LockWitness.validate`). The port's names are the
reference's at the same places.

Arming is decided at *creation* time: module-level singletons pick it up
from the environment at import, tests arm explicitly before constructing.
The env var is read per call, never cached at import .
"""

from __future__ import annotations

import os
import threading
from typing import Any

__all__ = ["lock", "rlock", "condition", "armed", "WITNESS", "LockWitness"]


def armed() -> bool:
    """Whether locks created *now* would be witnessed."""
    return os.environ.get("H2O3TPU_LOCKWITNESS", "") == "1"


class LockWitness:
    """Process-global recorder of witnessed acquisition order."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # (held, acquired) -> observation count
        self._edge_counts: dict[tuple[str, str], int] = {}
        # per-thread held stacks (ident -> names, reentrant names repeat)
        self._held: dict[int, list[str]] = {}
        self._thread_names: dict[int, str] = {}
        self._acquisitions = 0

    # -- recording (called from wrappers, armed runs only) -------------------

    def record_acquire(self, name: str) -> None:
        ident = threading.get_ident()
        with self._mu:
            stack = self._held.setdefault(ident, [])
            self._thread_names[ident] = threading.current_thread().name
            self._acquisitions += 1
            if name not in stack:  # reentrant re-acquire orders nothing
                for h in dict.fromkeys(stack):
                    e = (h, name)
                    self._edge_counts[e] = self._edge_counts.get(e, 0) + 1
            stack.append(name)

    def record_release(self, name: str) -> None:
        ident = threading.get_ident()
        with self._mu:
            stack = self._held.get(ident)
            if not stack:
                return
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break
            if not stack:
                del self._held[ident]

    # -- inspection ----------------------------------------------------------

    def edges(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._edge_counts)

    def inversions(self) -> list[tuple[str, str]]:
        """Pairs observed in BOTH orders — a live ABBA hazard. Each pair
        once, smaller name first."""
        edges = self.edges()
        return sorted({(min(a, b), max(a, b)) for (a, b) in edges
                       if (b, a) in edges})

    def held_by_thread(self) -> dict[int, list[str]]:
        with self._mu:
            return {i: list(dict.fromkeys(s))
                    for i, s in self._held.items() if s}

    def acquisitions(self) -> int:
        with self._mu:
            return self._acquisitions

    def report(self) -> dict[str, Any]:
        """JSON-ready summary for the self-validation gate."""
        edges = self.edges()
        return {
            "acquisitions": self.acquisitions(),
            "edges": sorted(f"{a}->{b}" for (a, b) in edges),
            "edge_counts": {f"{a}->{b}": n for (a, b) in sorted(edges)
                            for n in [edges[(a, b)]]},
            "inversions": [f"{a}<->{b}" for a, b in self.inversions()],
        }

    def validate(self, static_edges: set[tuple[str, str]],
                 static_locks: set[str]) -> dict[str, list[str]]:
        """Diff the witnessed run against the static graph: dynamic edges
        or lock names the analyzer doesn't know mean its call-graph (or
        the identity contract) has gone stale."""
        edges = self.edges()
        missing = sorted(f"{a}->{b}" for (a, b) in edges
                         if (a, b) not in static_edges)
        unknown = sorted({n for e in edges for n in e} - static_locks)
        return {"missing_from_static": missing, "unknown_locks": unknown}

    def reset(self) -> None:
        with self._mu:
            self._edge_counts.clear()
            self._held.clear()
            self._thread_names.clear()
            self._acquisitions = 0


WITNESS = LockWitness()


class _WitnessedLock:
    """Wrapper over Lock/RLock: records acquire/release order. Matches the
    ``threading`` context-manager protocol (``__enter__`` returns the
    ``acquire`` result, like the C implementation)."""

    __slots__ = ("_inner", "name")

    def __init__(self, inner, name: str) -> None:
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            WITNESS.record_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        WITNESS.record_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<witnessed {self._inner!r} name={self.name!r}>"


class _WitnessedCondition:
    """Wrapper over Condition. ``wait`` keeps the lock in the witnessed
    held set — the waiter still *logically* owns it (matches the static
    model, and a wedge dump should show the waiter as the holder)."""

    __slots__ = ("_inner", "name")

    def __init__(self, inner: threading.Condition, name: str) -> None:
        self._inner = inner
        self.name = name

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            WITNESS.record_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        WITNESS.record_release(self.name)

    def wait(self, timeout: float | None = None) -> bool:
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<witnessed {self._inner!r} name={self.name!r}>"


# -- factories ---------------------------------------------------------------
#
# The name argument MUST be the lock's static identity:
# ``<module>.<Class>.<attr>`` / ``<module>.<NAME>`` relative to the
# package root, as in the reference — the identity is the literal.

def lock(name: str):
    """A ``threading.Lock`` — witnessed when the witness is armed."""
    inner = threading.Lock()
    return _WitnessedLock(inner, name) if armed() else inner


def rlock(name: str):
    """A ``threading.RLock`` — witnessed when the witness is armed."""
    inner = threading.RLock()
    return _WitnessedLock(inner, name) if armed() else inner


def condition(name: str, lock: Any = None):
    """A ``threading.Condition`` (optionally over an existing raw lock) —
    witnessed when the witness is armed. Acquisition goes through the
    condition, so the condition's name is the identity."""
    inner = threading.Condition(lock)
    return _WitnessedCondition(inner, name) if armed() else inner
