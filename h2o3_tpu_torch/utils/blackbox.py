"""Black-box post-mortem — the dump that happens when REST cannot.

The port of ``h2o3_tpu/utils/blackbox.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: ``POST /3/Diagnostics/bundle`` (utils/health.py) answers "what
does the system look like" — but only while the REST server answers. The
two failure classes an operator most needs diagnosed are exactly the ones
it cannot serve through: a **wedged** process (the REST accept loop or
the health sweep stalled past a deadline — every probe then hangs) and a
**fatal exit** (the process dies before anyone asks). This module is the
aircraft black box for both:

- a **watchdog thread** monitors heartbeats stamped by the watched loops
  (:meth:`BlackBox.beat` — the REST accept loop beats from
  ``service_actions`` every poll, the health sweep beats once per sweep).
  A watched heartbeat silent past its deadline
  (``max(H2O3TPU_BLACKBOX_STALL_SECS, 8×period)``) is a wedge: the
  watchdog dumps a post-mortem straight to disk;
- **exit hooks** (``atexit`` + a chained ``SIGTERM`` handler + a chained
  ``sys.excepthook``) dump when the process dies while still **armed** —
  an orderly ``H2OServer.stop()`` disarms first, so a clean shutdown
  never dumps; an exit that skipped shutdown is by definition unplanned.

The dump is a gzip tar written directly to the Cleaner's ``ice_root``
(*no REST involved — the wedge being diagnosed would block it*), exactly
**once per process**, containing the flight record, all thread stacks,
the trace ring, the incident ring, the ActionLog, the log-ring tail, and
the same secrets-redacted config dump as the diagnostics bundle
(``redacted_config`` — the name-pattern redaction contract is shared, not
reimplemented). Every member is individually fault-isolated: a sick
registry records its error string instead of sinking the dump.

``H2O3TPU_BLACKBOX_OFF=1`` disables arming entirely. Knobs (resolved at
:meth:`BlackBox.arm`): ``…_STALL_SECS`` (default
30), ``…_CHECK_SECS`` (watchdog cadence, default 1s). docs/OBSERVABILITY
"Flight recorder & post-mortems" carries the trigger matrix.
"""

from __future__ import annotations

import atexit
import io
import json
import logging
import os
import signal
import sys
import tarfile
import threading
import time
import traceback

from h2o3_tpu_torch.utils import lockwitness

_LOG = logging.getLogger("h2o3_tpu_torch")


def blackbox_off() -> bool:
    return os.environ.get("H2O3TPU_BLACKBOX_OFF", "") == "1"


def _env_float(name: str, default: float, lo: float) -> float:
    try:
        return max(float(os.environ.get(name, "") or default), lo)
    except ValueError:
        return default


def _jsonable(obj) -> bytes:
    return json.dumps(obj, indent=1, default=str).encode()


# -- dump members (each fault-isolated by the builder loop) ------------------

def _member_flight() -> bytes:
    from h2o3_tpu_torch.utils.flight import FLIGHT
    return _jsonable(FLIGHT.export())


def _member_threads() -> bytes:
    """Every live thread's stack — the wedge's smoking gun (which frame
    is the stalled loop parked in). When the lock witness is armed, each
    thread also lists the witnessed locks it currently holds, so a wedge
    dump shows who holds what without reading the stacks."""
    names = {t.ident: t.name for t in threading.enumerate()}
    # {} when unarmed: nothing is ever recorded
    held = lockwitness.WITNESS.held_by_thread()
    out = []
    for ident, frame in sys._current_frames().items():
        out.append({"thread_id": ident,
                    "name": names.get(ident, f"thread-{ident}"),
                    "held_locks": held.get(ident, []),
                    "stack": traceback.format_stack(frame)})
    return _jsonable(out)


def _member_traces() -> bytes:
    from h2o3_tpu_torch.utils.tracing import TRACER
    return _jsonable(TRACER.list_traces())


def _member_incidents() -> bytes:
    from h2o3_tpu_torch.utils.incidents import INCIDENTS
    return _jsonable(INCIDENTS.export())


def _member_actions() -> bytes:
    """The ActionLog — only when the ops plane is loaded (the dump path
    must not be the thing that imports it)."""
    acts = sys.modules.get("h2o3_tpu_torch.ops_plane.actions")
    return _jsonable(acts.ACTIONS.list() if acts is not None else [])


def _member_logs() -> bytes:
    from h2o3_tpu_torch.utils import telemetry as _tm
    return "\n".join(_tm.install_log_ring().lines()[-200:]).encode()


def _member_config() -> bytes:
    # the SAME name-pattern redaction as the diagnostics bundle — one
    # contract, two consumers
    from h2o3_tpu_torch.utils.health import redacted_config
    return _jsonable(redacted_config())


#: member name -> builder; the dump loop fault-isolates each one
DUMP_MEMBERS = (
    ("flight.json", _member_flight),
    ("threads.json", _member_threads),
    ("traces.json", _member_traces),
    ("incidents.json", _member_incidents),
    ("actions.json", _member_actions),
    ("logs.txt", _member_logs),
    ("config.json", _member_config),
)


class BlackBox:
    """The watchdog + exit-hook post-mortem dumper. One process-wide
    instance (:data:`BLACKBOX`) is armed by ``H2OServer.start`` and
    disarmed by ``H2OServer.stop``; private instances (tests/bench)
    carry their own once-per-instance fire flag and dump directory."""

    def __init__(self, dump_dir: "str | None" = None):
        self._lock = lockwitness.lock("utils.blackbox.BlackBox._lock")
        self._dump_dir = dump_dir
        self._watch: "dict[str, float]" = {}      # name -> expected period
        self._beats: "dict[str, float]" = {}      # name -> last monotonic
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._armed = False
        self._fired = False
        self._last_dump: "str | None" = None
        self._hooks_installed = False
        self._prev_sigterm = None
        self._prev_excepthook = None
        self.stall_secs = 30.0
        self.check_secs = 1.0

    # -- heartbeats ----------------------------------------------------------

    def watch(self, name: str, period_s: float) -> None:
        """Register a heartbeat to monitor; ``period_s`` is the loop's
        expected cadence (the wedge deadline scales with it, so a slow
        sweep interval doesn't false-positive)."""
        with self._lock:
            self._watch[name] = max(float(period_s), 0.01)
            self._beats[name] = time.monotonic()

    def unwatch(self, name: str) -> None:
        with self._lock:
            self._watch.pop(name, None)
            self._beats.pop(name, None)

    def beat(self, name: str) -> None:
        """Stamp a heartbeat (cheap — one locked dict write; unwatched
        names are ignored so call sites never need to know the arming
        state)."""
        with self._lock:
            if name in self._watch:
                self._beats[name] = time.monotonic()

    def wedged(self) -> "tuple[str, float] | None":
        """The first watched heartbeat silent past its deadline, as
        ``(name, silence_s)`` — None when everything is beating."""
        now = time.monotonic()
        with self._lock:
            for name, period in self._watch.items():
                deadline = max(self.stall_secs, 8.0 * period)
                silence = now - self._beats.get(name, now)
                if silence > deadline:
                    return name, round(silence, 3)
        return None

    # -- lifecycle -----------------------------------------------------------

    def arm(self) -> bool:
        """Start the watchdog and install the exit hooks (idempotent;
        False when already armed or ``H2O3TPU_BLACKBOX_OFF=1``). Env
        knobs resolve here, not at import."""
        if blackbox_off():
            return False
        with self._lock:
            if self._armed:
                return False
            self.stall_secs = _env_float(
                "H2O3TPU_BLACKBOX_STALL_SECS", 30.0, 0.1)
            self.check_secs = _env_float(
                "H2O3TPU_BLACKBOX_CHECK_SECS", 1.0, 0.05)
            self._armed = True
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="h2o3-blackbox")
            self._thread.start()
        self._install_hooks()
        return True

    def disarm(self, timeout: float = 5.0) -> None:
        """Orderly shutdown: stop the watchdog and neutralize the exit
        hooks (they check the armed flag) — a disarmed process never
        dumps at exit."""
        with self._lock:
            thread = self._thread
            self._thread = None
            self._armed = False
            self._stop.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=timeout)

    def armed(self) -> bool:
        with self._lock:
            return self._armed

    def fired(self) -> bool:
        with self._lock:
            return self._fired

    def last_dump(self) -> "str | None":
        with self._lock:
            return self._last_dump

    def _run(self) -> None:
        # bounded wait: disarm() wakes it, the cadence bounds it
        while not self._stop.wait(self.check_secs):
            with self._lock:
                if self._thread is not threading.current_thread():
                    return
            try:
                wedge = self.wedged()
                if wedge is not None:
                    name, silence = wedge
                    self.dump(f"wedge:{name}",
                              detail={"heartbeat": name,
                                      "silence_s": silence,
                                      "deadline_s": max(
                                          self.stall_secs,
                                          8.0 * self._watch.get(name, 0))})
            except Exception:   # noqa: BLE001 — the watchdog must outlive
                _LOG.exception("blackbox watchdog check failed")

    # -- exit hooks ----------------------------------------------------------

    def _install_hooks(self) -> None:
        """atexit + chained SIGTERM + chained excepthook — once per
        instance; every hook re-checks the armed flag so disarm works
        without uninstalling (uninstalling chained handlers races)."""
        with self._lock:
            if self._hooks_installed:
                return
            self._hooks_installed = True
            atexit.register(self._on_exit)
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_uncaught
            try:
                # only the main thread may set signal handlers; an
                # embedded arm() from a worker thread just skips the
                # signal hook
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
            except ValueError:
                self._prev_sigterm = None

    def _on_exit(self) -> None:
        if self.armed():
            # exiting while still armed = shutdown never ran — unplanned
            self.dump("atexit-while-armed")

    def _on_uncaught(self, exc_type, exc, tb) -> None:
        if self.armed():
            try:
                self.dump(f"uncaught:{exc_type.__name__}",
                          detail={"error": f"{exc_type.__name__}: {exc}"})
            except Exception:   # noqa: BLE001 — never mask the real crash
                pass
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _on_sigterm(self, signum, frame) -> None:
        if self.armed():
            try:
                self.dump("SIGTERM")
            except Exception:   # noqa: BLE001 — never block the kill
                pass
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    # -- the dump ------------------------------------------------------------

    def dump(self, reason: str, detail: "dict | None" = None
             ) -> "str | None":
        """Write the post-mortem tar.gz to ``ice_root`` — exactly once
        per instance (a persistent wedge must not fill the disk with
        identical dumps). Returns the path, or None when already fired.
        REST is never involved."""
        with self._lock:
            if self._fired:
                return None
            self._fired = True
            watches = {n: {"period_s": p,
                           "silence_s": round(
                               time.monotonic() - self._beats.get(n, 0), 3)}
                       for n, p in self._watch.items()}
        now = int(time.time())
        members: "list[tuple[str, bytes]]" = [
            ("reason.json", _jsonable({
                "reason": reason, "detail": detail or {},
                "pid": os.getpid(), "ts": now,
                "at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                    time.gmtime(now)),
                "watched": watches}))]
        for name, build in DUMP_MEMBERS:
            try:
                members.append((name, build()))
            except Exception as e:   # noqa: BLE001 — a sick member must
                # not sink the post-mortem; its slot records the failure
                members.append((name + ".error",
                                f"{type(e).__name__}: {e}".encode()))
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            for name, data in members:
                info = tarfile.TarInfo(name=f"h2o3_postmortem/{name}")
                info.size = len(data)
                info.mtime = now
                tar.addfile(info, io.BytesIO(data))
        out_dir = self._dump_dir
        if out_dir is None:
            from h2o3_tpu_torch.utils.cleaner import CLEANER
            out_dir = CLEANER.ice_root
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"h2o3_postmortem_{os.getpid()}_{now}.tar.gz")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        with self._lock:
            self._last_dump = path
        _LOG.error("blackbox post-mortem (%s) written to %s", reason, path)
        return path

    def reset(self) -> None:
        """Forget the fired flag and watches (tests/bench only — a real
        process fires at most once)."""
        with self._lock:
            self._fired = False
            self._last_dump = None
            self._watch.clear()
            self._beats.clear()


#: the process-wide black box (armed by ``H2OServer.start``; the health
#: sweep and the REST accept loop beat it unconditionally — beats to an
#: unwatched name are ignored)
BLACKBOX = BlackBox()
