"""h2o.init / connect / cluster — the client-session entry points — the port
of ``h2o3_tpu/session.py``.

Reference: ``h2o-py/h2o/h2o.py`` — ``h2o.init()`` starts-or-attaches a local
node and keeps a module-level connection; ``h2o.connect()`` attaches to a
running cluster; ``h2o.cluster()`` exposes status/shutdown.

Here ``init`` boots the in-process REST server (the "node" is this process
and its card) and returns a client bound to it; ``connect`` attaches to any
running server of the port or of the JAX package. The multi-host arguments
(``coordinator_address``, ``num_processes``, ``process_id``) join a
multi-process cloud first (:func:`~h2o3_tpu_torch.parallel.distributed.
init_distributed`); only rank 0 serves REST. ``init`` enables the kernel-build cache (``utils/compile_cache.py``,
``H2O3TPU_COMPILE_CACHE``) where the reference enables its XLA cache.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:   # lazy at runtime: api.server imports __version__
    from h2o3_tpu_torch.api.client import H2OClient

_server = None
_client = None


def init(port: int = 54321, strict_port: bool = False,
         coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> "H2OClient":
    """Start (once) an in-process server and bind the module client
    (h2o-py: ``h2o.init``). Falls back to an ephemeral port unless
    ``strict_port``.

    Multi-host: pass ``coordinator_address`` with ``num_processes`` and
    ``process_id`` to join a process-spanning cloud first — every process
    calls ``init`` with the same coordinator and blocks until the cloud
    forms (reference ``waitForCloudSize``); only rank 0 serves REST and
    gets a client, the others get None. See also ``python -m
    h2o3_tpu_torch.launch``. Without a coordinator the other two are
    ignored, as in the JAX package."""
    from h2o3_tpu_torch.api.client import H2OClient
    from h2o3_tpu_torch.api.server import H2OServer
    from h2o3_tpu_torch.utils import compile_cache
    from h2o3_tpu_torch.utils.telemetry import install_log_ring
    install_log_ring()   # session startup: /3/Logs serves from here on
    # the kernel-build cache (H2O3TPU_COMPILE_CACHE=1|path)
    compile_cache.enable()
    global _server, _client
    if _client is not None:
        return _client
    if coordinator_address is not None:
        from h2o3_tpu_torch.parallel.distributed import (init_distributed,
                                                         process_index)
        init_distributed(coordinator_address, num_processes, process_id)
        if process_index() != 0:
            return None
    try:
        _server = H2OServer(port=port).start()
    except OSError:
        if strict_port:
            raise
        _server = H2OServer(port=0).start()
    _client = H2OClient(_server.url)
    return _client


def connect(url: str) -> "H2OClient":
    """Attach to a running server (h2o-py: ``h2o.connect``)."""
    from h2o3_tpu_torch.api.client import H2OClient
    global _client
    _client = H2OClient(url)
    _client.cloud_status()      # fail fast on a dead address
    return _client


def cluster() -> dict:
    """Cluster status (h2o-py: ``h2o.cluster().show_status()``)."""
    if _client is None:
        raise RuntimeError(
            "not connected: call h2o3_tpu_torch.init() or connect()")
    return _client.cloud_status()


def shutdown() -> None:
    """Stop the in-process server and drop the connection.

    When this process OWNS the server, stop it directly — issuing the REST
    /3/Shutdown as well would race two teardowns of the same socketserver
    from different threads."""
    global _server, _client
    if _server is not None:
        _server.stop()
    elif _client is not None:
        try:
            _client.shutdown()
        except Exception:    # noqa: BLE001 — server may already be gone
            pass
    _server = _client = None


def connection():
    return _client
