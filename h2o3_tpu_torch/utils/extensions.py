"""Pluggable extensions + lifecycle listeners (the Extensions SPI) — the
port of ``h2o3_tpu/utils/extensions.py``.

Reference: ``water/ExtensionManager.java`` discovers ``AbstractH2OExtension``
and ``RestApiExtension`` implementations via Java ``ServiceLoader`` on the
classpath and runs their init hooks during node startup;
``water/ListenerService.java`` fans lifecycle events (cloud up, job results)
out to registered listeners.

Python analog: there is no classpath scanning in a Python process, so
discovery is explicit — modules named in ``$H2O3TPU_EXTENSIONS`` (comma-
separated import paths) are imported when a session or server starts, and a
module registers itself at import time via :func:`register`.  Extensions can
contribute node-init hooks, REST routes (the ``RestApiExtension`` analog —
served by :mod:`h2o3_tpu_torch.api.server` after the built-in table), and
event listeners.

Events reported by the framework (superset of the reference's
``ListenerService.report`` call sites): ``cloud_up``, ``model_build_start``,
``model_build_end`` (from ``ModelBuilder.train``), ``job_done``.
"""
from __future__ import annotations

import logging
import os
import threading

log = logging.getLogger("h2o3_tpu_torch")

__all__ = ["H2OExtension", "register", "extensions", "init_all",
           "rest_routes", "add_listener", "remove_listener", "report",
           "load_env_extensions", "reset"]


class H2OExtension:
    """Base class (reference ``water/AbstractH2OExtension.java``): subclass,
    set ``name``, optionally override ``init`` / ``routes`` / ``on_event``,
    and pass an instance to :func:`register`."""

    name: str = "extension"
    enabled: bool = True

    def init(self) -> None:
        """Node-startup hook (reference ``onLocalNodeStarted``)."""

    def routes(self):
        """REST contributions: ``[(regex_path, http_method, fn)]`` where
        ``fn(handler, *groups)`` is a bound-style handler taking the live
        request handler (reference ``RestApiExtension.registerEndPoints``)."""
        return []

    def on_event(self, event: str, **info) -> None:
        """Lifecycle callback (reference ``ListenerService.report``)."""


_LOCK = threading.Lock()
_EXTENSIONS: list[H2OExtension] = []
_LISTENERS: list = []          # bare callables: (event, **info) -> None
_INITED: set[int] = set()


def register(ext: H2OExtension) -> H2OExtension:
    with _LOCK:
        if all(e is not ext for e in _EXTENSIONS):
            _EXTENSIONS.append(ext)
    return ext


def extensions() -> list[H2OExtension]:
    return [e for e in _EXTENSIONS if e.enabled]


def init_all() -> None:
    """Run pending init hooks exactly once per extension (the reference
    guards double-init the same way: ``ExtensionManager.registerCoreExtensions``
    is one-shot)."""
    for e in extensions():
        if id(e) not in _INITED:
            _INITED.add(id(e))
            try:
                e.init()
            except Exception:          # noqa: BLE001 — a broken extension
                log.exception("extension %s failed to init", e.name)
                e.enabled = False      # must not take the node down


def rest_routes():
    out = []
    for e in extensions():
        out.extend(e.routes())
    return out


def add_listener(cb) -> None:
    with _LOCK:
        if cb not in _LISTENERS:
            _LISTENERS.append(cb)


def remove_listener(cb) -> None:
    with _LOCK:
        if cb in _LISTENERS:
            _LISTENERS.remove(cb)


def report(event: str, **info) -> None:
    """Fan an event out to listeners and extensions; listener failures are
    logged, never raised into the training/serving path."""
    for cb in list(_LISTENERS):
        try:
            cb(event, **info)
        except Exception:              # noqa: BLE001
            log.exception("listener failed on %s", event)
    for e in extensions():
        try:
            e.on_event(event, **info)
        except Exception:              # noqa: BLE001
            log.exception("extension %s failed on %s", e.name, event)


_ENV_LOADED: set[str] = set()


def load_env_extensions() -> None:
    """Import modules named in $H2O3TPU_EXTENSIONS (they self-register on
    import — the ServiceLoader analog)."""
    import importlib
    for mod in filter(None, os.environ.get("H2O3TPU_EXTENSIONS", "").split(",")):
        mod = mod.strip()
        if mod and mod not in _ENV_LOADED:
            _ENV_LOADED.add(mod)
            try:
                importlib.import_module(mod)
            except Exception:          # noqa: BLE001
                log.exception("failed to load extension module %s", mod)


def reset() -> None:
    """Test hook: drop all registrations."""
    with _LOCK:
        _EXTENSIONS.clear()
        _LISTENERS.clear()
        _INITED.clear()
        _ENV_LOADED.clear()
