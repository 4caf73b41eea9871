"""Job — a unit of work with status, progress and cancellation — the port
of ``h2o3_tpu/models/job.py`` (reference: ``water/Job.java``).

A Job runs its function on the caller's thread or on a worker thread
(``run(fn, background=True)``) and records status, progress, timing, the
result and any exception. :meth:`Job.cancel` asks the work to stop: the
next :meth:`Job.update` raises :class:`JobCancelled` inside it, and a
builder that keeps partial results polls :attr:`Job.should_stop`. The
reference's DKV registration, deadlines (``max_runtime_secs``), dispatch
retry accounting and tracing spans belong to the observability and ops
slice and are left out.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable


class JobCancelled(Exception):
    pass


class Job:
    CREATED, RUNNING, DONE, FAILED, CANCELLED = (
        "CREATED", "RUNNING", "DONE", "FAILED", "CANCELLED")

    def __init__(self, description: str, key: str | None = None):
        self.key = key or f"job_{uuid.uuid4().hex[:12]}"
        self.description = description
        self.status = Job.CREATED
        self.progress = 0.0
        self.progress_msg = ""
        self.start_time: float | None = None
        self.end_time: float | None = None
        self.exception: BaseException | None = None
        self.result: Any = None
        # guards the fields a worker thread writes while another reads them
        self._lock = threading.Lock()
        self._cancel_requested = threading.Event()
        self._done = threading.Event()

    def run(self, fn: Callable[["Job"], Any],
            background: bool = False) -> "Job":
        """Execute ``fn(job)``, on a daemon thread when ``background``;
        ``fn`` reports through :meth:`update`."""
        if background:
            threading.Thread(target=self._exec, args=(fn,),
                             daemon=True).start()
        else:
            self._exec(fn)
        return self

    def _exec(self, fn) -> None:
        with self._lock:
            self.status = Job.RUNNING
            self.start_time = time.time()
        try:
            result = fn(self)
            with self._lock:
                # status last: a reader that sees it finished sees the rest
                self.result = result
                self.progress = 1.0
                self.status = (Job.CANCELLED
                               if self._cancel_requested.is_set()
                               else Job.DONE)
        except JobCancelled:
            with self._lock:
                self.status = Job.CANCELLED
        except Exception as e:    # the Job carries the error to its caller
            with self._lock:
                self.status = Job.FAILED
                self.exception = e
        finally:
            with self._lock:
                self.end_time = time.time()
            self._done.set()

    def update(self, progress: float, msg: str = "") -> None:
        with self._lock:
            self.progress = float(progress)
            self.progress_msg = msg
        if self._cancel_requested.is_set():
            raise JobCancelled(self.key)

    @property
    def cancelled(self) -> bool:
        return self._cancel_requested.is_set()

    @property
    def should_stop(self) -> bool:
        """The cooperative stop signal (an explicit cancel)."""
        return self._cancel_requested.is_set()

    def cancel(self) -> None:
        self._cancel_requested.set()

    def join(self, timeout: float | None = None) -> "Job":
        self._done.wait(timeout)
        return self

    def __repr__(self) -> str:
        return (f"Job({self.key}, {self.status}, {self.progress:.0%}, "
                f"{self.description!r})")
