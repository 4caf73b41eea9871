"""Multi-process launcher — the port of ``h2o3_tpu/launch.py``
(``java -jar h2o.jar`` / ``multiNodeUtils.sh``).

Reference: a multi-node H2O cluster is N JVMs started with the same cloud
name; each calls ``H2O.main`` → ``waitForCloudSize``. Here::

    # one process per host, the same script everywhere
    python -m h2o3_tpu_torch.launch --coordinator host0:7337 \\
        --num-processes 2 --process-id $I train.py [script args...]

    # or fork an N-rank cloud on this host: each rank takes the card
    # rank % device_count (several ranks may share one), or the CPU
    python -m h2o3_tpu_torch.launch --fork 2 train.py
    python -m h2o3_tpu_torch.launch --fork 2 --device cpu train.py

Each process joins the cloud through ``init_distributed`` (blocking until
every process has connected, the reference's ``waitForCloudSize``),
installs the spanning mesh, then runs the script. Every process runs the
same script: each rank trains on its row block and the fits' sums are
reduced over the ranks. ``--serve`` serves the REST API from rank 0.
"""

from __future__ import annotations

import argparse
import os
import runpy
import signal
import subprocess
import sys
import time


def _run_script(script: str, argv: list[str]) -> None:
    sys.argv = [script] + argv
    runpy.run_path(script, run_name="__main__")


def _reap(procs: list) -> int:
    """Wait for every forked rank, in any order; the first failure tears
    down the rest (a dead coordinator would leave the others blocked in
    the join forever). Returns the first non-zero exit code, or 0."""
    rc, pending = 0, set(procs)
    while pending:
        for p in list(pending):
            code = p.poll()
            if code is None:
                continue
            pending.discard(p)
            rc = code or rc
            if code != 0:
                for q in pending:
                    q.terminate()
        time.sleep(0.05)
    return rc


def main(args=None) -> int:
    ap = argparse.ArgumentParser(prog="h2o3_tpu_torch.launch",
                                 description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (rank 0's host)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--fork", type=int, default=None, metavar="N",
                    help="fork an N-rank cloud on this host")
    ap.add_argument("--devices-per-process", type=int, default=None,
                    help="accepted for the JAX launcher's command lines: a "
                         "rank holds one device, its card or --device")
    ap.add_argument("--device", default=None,
                    help="the ranks' device: 'cpu' for a CPU cloud; by "
                         "default each rank's card (rank %% cards)")
    ap.add_argument("--port", type=int, default=7337,
                    help="with --fork: coordinator port")
    ap.add_argument("--serve", action="store_true",
                    help="serve the REST API from rank 0 after clouding "
                         "(instead of, or in addition to, running a script)")
    ap.add_argument("--rest-port", type=int, default=54321)
    ap.add_argument("--ldap-login", default=None, metavar="URL",
                    help="gate the REST API behind an LDAP simple bind "
                         "(ldap://host:port; reference water/H2O.java "
                         "-ldap_login)")
    ap.add_argument("--ldap-user-template", default=None, metavar="DN",
                    help="bind-DN template with one {} for the login name, "
                         "e.g. 'uid={},ou=people,dc=example,dc=org'")
    ap.add_argument("script", nargs="?", default=None)
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(args)
    if not ns.serve and ns.script is None:
        ap.error("a script is required unless --serve is given")
    if ns.ldap_login and not ns.ldap_user_template:
        ap.error("--ldap-login needs --ldap-user-template")

    if ns.fork:
        procs = []
        for pid in range(ns.fork):
            cmd = [sys.executable, "-m", "h2o3_tpu_torch.launch",
                   "--coordinator", f"localhost:{ns.port}",
                   "--num-processes", str(ns.fork), "--process-id", str(pid)]
            if ns.device:
                cmd += ["--device", ns.device]
            if ns.serve:
                cmd += ["--serve", "--rest-port", str(ns.rest_port)]
                if ns.ldap_login:
                    cmd += ["--ldap-login", ns.ldap_login,
                            "--ldap-user-template", ns.ldap_user_template]
            if ns.script is not None:
                cmd += [ns.script] + ns.script_args
            procs.append(subprocess.Popen(cmd, env=dict(os.environ)))

        def _stop(signum, _frame):
            raise SystemExit(128 + signum)

        # a terminated launcher takes its ranks down with it (the finally)
        signal.signal(signal.SIGTERM, _stop)
        try:
            return _reap(procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()

    from h2o3_tpu_torch.parallel.distributed import (init_distributed,
                                                     process_index)
    if ns.device is not None:
        from h2o3_tpu_torch.device import set_device
        set_device(ns.device)
    if ns.coordinator is not None:
        init_distributed(ns.coordinator, ns.num_processes, ns.process_id,
                         device=ns.device)
    # the kernel-build cache (H2O3TPU_COMPILE_CACHE=1|path): every rank
    # reuses the library a first build left
    from h2o3_tpu_torch.utils import compile_cache
    compile_cache.enable()
    if ns.serve and process_index() == 0:
        # only rank 0 serves (reference: the REST API of the cloud's first
        # node); the other ranks are cloud members
        from h2o3_tpu_torch.api.server import H2OServer
        authenticator = None
        if ns.ldap_login:
            from h2o3_tpu_torch.api.ldap_auth import ldap_authenticator
            authenticator = ldap_authenticator(ns.ldap_login,
                                               ns.ldap_user_template)
        server = H2OServer(port=ns.rest_port, host="0.0.0.0",
                           authenticator=authenticator).start()
        print(f"h2o3_tpu_torch REST serving on {server.url}", flush=True)
    if ns.script is not None:
        _run_script(ns.script, ns.script_args)
    if ns.serve:
        # keep serving after the (optional) setup script: the server runs
        # on a daemon thread, so returning would tear it down; the other
        # ranks stay cloud members until they are stopped
        import threading
        threading.Event().wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
