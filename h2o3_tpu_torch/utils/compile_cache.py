"""The kernel-build cache — one switch, observable hit/miss counts — the
port of ``h2o3_tpu/utils/compile_cache.py``.

The JAX package persists XLA executables across processes. The port's
compiled artifact is its CUDA kernel library, which ``ops/_build.py``
builds with nvcc on first use into a file named by a hash of its sources
and flags: a later process with the same sources loads it instead of
rebuilding. This module makes that cache observable and places it.

Behavior is controlled by ``H2O3TPU_COMPILE_CACHE``:

- unset → caller's default (``enable()`` is opt-in; session init passes
  ``default_on=False``);
- ``0``/``off`` → disabled;
- ``1``/``on`` → enabled at the default directory (``ops/_build.py``'s
  ``build/`` beside the package);
- any other value → enabled at that path: the library builds and loads
  there.

Once enabled, every ``ops/_build.build()`` counts a **hit** (a library for
the sources' hash was there and is reused) or a **miss** (nvcc rebuilt
it), split by the :class:`~h2o3_tpu_torch.utils.costs.CostMeter` site
active at the time (``by_site``); :func:`stats` snapshots them plus the
on-disk entry count.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_state = {"enabled": False, "dir": None, "hits": 0, "misses": 0,
          "by_site": {}}


def _default_dir() -> str:
    from h2o3_tpu_torch.ops import _build
    return str(_build.BUILD_DIR)


def note(kind: str) -> None:
    """Count one build-cache event (``"hits"`` or ``"misses"``) against the
    site active now; called by ``ops/_build.build``, and a no-op until
    :func:`enable`."""
    from h2o3_tpu_torch.utils.costs import COSTS
    site = COSTS.active_site() or "(unattributed)"
    with _lock:
        if not _state["enabled"]:
            return
        _state[kind] += 1
        per = _state["by_site"].setdefault(site, {"hits": 0, "misses": 0})
        per[kind] += 1


def enable(cache_dir: str | None = None, *, default_on: bool = False) -> bool:
    """Configure the build cache per the env policy above. Returns True
    when the cache is active. Idempotent; never raises."""
    env = os.environ.get("H2O3TPU_COMPILE_CACHE", "").strip()
    if env.lower() in ("0", "off", "false"):
        return False
    if not env and not default_on and cache_dir is None:
        return False
    if env and env.lower() not in ("1", "on", "true"):
        cache_dir = env
    from pathlib import Path

    from h2o3_tpu_torch.ops import _build
    if cache_dir:
        _build.BUILD_DIR = Path(cache_dir)
    with _lock:
        _state["enabled"] = True
        _state["dir"] = str(_build.BUILD_DIR)
    return True


def stats() -> dict:
    """{enabled, dir, entries, hits, misses, by_site} — ``entries`` counts
    the libraries on disk (an absolute view; hits/misses are this process
    only, ``by_site`` splits them by the CostMeter site active at build
    time)."""
    with _lock:
        out = {"enabled": _state["enabled"], "dir": _state["dir"],
               "hits": _state["hits"], "misses": _state["misses"],
               "by_site": {k: dict(v)
                           for k, v in _state["by_site"].items()}}
    entries = 0
    if out["dir"]:
        try:
            entries = sum(1 for e in os.scandir(out["dir"])
                          if e.name.endswith(".so"))
        except OSError:
            pass
    out["entries"] = entries
    return out


def reset() -> None:
    """Tests only: disabled, counts zeroed."""
    with _lock:
        _state.update(enabled=False, dir=None, hits=0, misses=0, by_site={})
