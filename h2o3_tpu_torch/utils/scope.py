"""Scope — temp-key lifetime tracking — the port of
``h2o3_tpu/utils/scope.py``, over the port's DKV
(:mod:`h2o3_tpu_torch.utils.registry`).

Reference: ``water/Scope.java`` — ``Scope.enter()``/``Scope.exit(keep...)``
brackets an operation; every key created inside is deleted at exit unless
explicitly kept. The reference threads this through every ModelBuilder so
intermediate frames never leak into the DKV.

Here the DKV is a single registry, so a scope snapshots the key set at entry
and removes the difference at exit (minus ``keep``). Nesting works the
obvious way; ``track`` force-registers keys created through side channels.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from h2o3_tpu_torch.utils.registry import DKV

# per-thread like the reference (Scope.java keys its stack by thread):
# concurrent REST handlers must not pop each other's frames
_local = threading.local()


def _stack_of() -> list[dict]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def enter() -> None:
    _stack_of().append({"pre": set(DKV.keys()), "tracked": set()})


def track(key: str) -> str:
    """Explicitly mark a key for cleanup at scope exit."""
    stack = _stack_of()
    if stack:
        stack[-1]["tracked"].add(key)
    return key


def untrack(key: str) -> str:
    stack = _stack_of()
    if stack:
        stack[-1]["tracked"].discard(key)
    return key


def exit(*keep: str) -> None:
    """Remove keys created since the matching :func:`enter`, except ``keep``
    (and anything a still-open outer scope already owned)."""
    stack = _stack_of()
    frame = stack.pop()
    keep_set = set(keep)
    new = (set(DKV.keys()) - frame["pre"]) | frame["tracked"]
    for k in new - keep_set:
        if k in DKV:
            DKV.remove(k)
    if stack:    # surviving keys become the outer scope's responsibility
        stack[-1]["tracked"] |= keep_set & set(DKV.keys())


@contextmanager
def scope(*keep: str):
    """``with scope("result_key"): ...`` — the context-manager form."""
    enter()
    try:
        yield
    finally:
        exit(*keep)
