"""Job — a unit of work with status, progress and cancellation — the port
of ``h2o3_tpu/models/job.py`` (reference: ``water/Job.java``).

A Job runs its function on the caller's thread or on a worker thread
(``run(fn, background=True)``) and records status, progress, timing, the
result and any exception. :meth:`Job.cancel` asks the work to stop: the
next :meth:`Job.update` raises :class:`JobCancelled` inside it, and a
builder that keeps partial results polls :attr:`Job.should_stop`, which
also trips once the job has outlived ``max_runtime_secs`` (counted in
``h2o3_job_deadline_exceeded_total``). Dispatch retries that
:func:`h2o3_tpu_torch.ops.map_reduce.retrying` absorbs are credited to
every Job on the context's stack (:func:`note_dispatch_retry`). A Job
captures the creating request's span context and runs its work as a
``job:<description>`` span in that trace. The library Job is not put into
the DKV: the REST layer registers the jobs it hands out.
"""

from __future__ import annotations

import contextvars
import threading
import time
import traceback
import uuid
from typing import Any, Callable

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import tracing as _tracing


class JobCancelled(Exception):
    pass


#: innermost-first stack of Jobs executing on this context — the REST path
#: nests a library Job inside the REST Job, and dispatch-retry accounting
#: must land on BOTH so /3/Jobs pollers see the retries the build absorbed
_JOB_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "h2o3_job_stack", default=())


def current_job() -> "Job | None":
    """The innermost Job executing on this context, if any."""
    stack = _JOB_STACK.get()
    return stack[0] if stack else None


def note_dispatch_retry(n: int = 1) -> None:
    """Credit ``n`` dispatch retries to every Job on this context's stack
    (called by :func:`h2o3_tpu_torch.ops.map_reduce.retrying`)."""
    for j in _JOB_STACK.get():
        with j._lock:
            j.retries += int(n)


class Job:
    CREATED, RUNNING, DONE, FAILED, CANCELLED = (
        "CREATED", "RUNNING", "DONE", "FAILED", "CANCELLED")

    def __init__(self, description: str, key: str | None = None,
                 max_runtime_secs: float = 0.0):
        self.key = key or f"job_{uuid.uuid4().hex[:12]}"
        self.description = description
        self.status = Job.CREATED
        self.progress = 0.0
        self.progress_msg = ""
        self.start_time: float | None = None
        self.end_time: float | None = None
        self.exception: BaseException | None = None
        self.traceback: str | None = None
        self.result: Any = None
        # a deadline enforced cooperatively in update()/should_stop,
        # absorbed dispatch-retry counts, and the attempt history of an
        # exhausted retry budget
        self.max_runtime_secs = float(max_runtime_secs or 0.0)
        self.deadline_exceeded = False
        self.retries = 0
        self.retry_history: list | None = None
        # guards the fields a worker thread writes while another reads them
        self._lock = lockwitness.lock("models.job.Job._lock")
        self._cancel_requested = threading.Event()
        self._partial_accepted = False
        self._done = threading.Event()
        # the creating request's span context rides into the worker thread
        # (contextvars do not cross threads); capture() RETAINS the trace
        # until the job span ends — the request's root span may close
        # (response sent) before the background thread even starts
        self._span_ctx = _tracing.TRACER.capture()
        self.trace_id = (self._span_ctx.trace_id
                         if self._span_ctx is not None else None)

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
        # adopt the creating request's span context: the job's work is a
        # child span in that trace, and the retention taken at construction
        # is released when the job span ends
        token = _JOB_STACK.set((self,) + _JOB_STACK.get())
        with _tracing.TRACER.adopt(self._span_ctx,
                                   f"job:{self.description}", kind="job",
                                   attrs={"job": self.key}) as jspan:
            with self._lock:
                self.status = Job.RUNNING
                self.start_time = time.time()
            try:
                result = fn(self)
                with self._lock:
                    # status last: a reader that sees it finished sees the
                    # rest
                    self.result = result
                    self.progress = 1.0
                    self.status = (Job.CANCELLED
                                   if self._cancel_requested.is_set()
                                   else Job.DONE)
            except JobCancelled:
                with self._lock:
                    self.status = Job.CANCELLED
                if jspan is not None:
                    jspan.set_status("cancelled")
            except Exception as e:    # the Job carries the error to its caller
                # an exhausted dispatch-retry budget (DispatchFailed) lands
                # its per-attempt history here so pollers see what was tried
                with self._lock:
                    self.status = Job.FAILED
                    self.exception = e
                    self.traceback = traceback.format_exc()
                    self.retry_history = getattr(e, "history", None)
                if jspan is not None:
                    jspan.set_status("error")
                    jspan.set_attrs(exception=f"{type(e).__name__}: {e}")
            finally:
                _JOB_STACK.reset(token)
                with self._lock:
                    self.end_time = time.time()
                self._done.set()

    def _check_deadline(self) -> bool:
        """True once the job has outlived ``max_runtime_secs`` (reference:
        ``Job.update`` throws when the work budget is spent). Trips the
        cancellation flag, so the normal-return path lands on CANCELLED:
        builders that keep partial results (GBM's built trees) return them
        and the job still reads as deadline-terminated."""
        if self.max_runtime_secs <= 0 or self.start_time is None \
                or self.deadline_exceeded:
            return self.deadline_exceeded
        if time.time() - self.start_time > self.max_runtime_secs:
            from h2o3_tpu_torch.utils.telemetry import JOB_DEADLINE_EXCEEDED
            with self._lock:
                self.deadline_exceeded = True
                self.progress_msg = (f"max_runtime_secs="
                                     f"{self.max_runtime_secs:g} exceeded")
            self._cancel_requested.set()
            JOB_DEADLINE_EXCEEDED.inc()
        return self.deadline_exceeded

    def keep_partial(self) -> None:
        """A partial-result builder ACCEPTED the stop signal: it stopped
        its loop and is finalizing what it built. Later ``update`` calls
        must not re-raise, or finalization itself would be cancelled — the
        job still terminates CANCELLED."""
        with self._lock:
            self._partial_accepted = True

    def update(self, progress: float, msg: str = "") -> None:
        self._check_deadline()
        with self._lock:
            self.progress = float(progress)
            if not self.deadline_exceeded:
                self.progress_msg = msg
        if self._cancel_requested.is_set() and not self._partial_accepted:
            raise JobCancelled(self.key)

    @property
    def cancelled(self) -> bool:
        return self._cancel_requested.is_set()

    @property
    def should_stop(self) -> bool:
        """The cooperative stop signal — an explicit cancel OR the deadline.
        Builders that keep partial results check it between chunks and
        break instead of letting ``update`` raise."""
        return self._cancel_requested.is_set() or self._check_deadline()

    def cancel(self) -> None:
        self._cancel_requested.set()

    def join(self, timeout: float | None = None) -> "Job":
        self._done.wait(timeout)
        return self

    @property
    def run_time(self) -> float:
        end = self.end_time or time.time()
        return (end - self.start_time) if self.start_time else 0.0

    def __repr__(self) -> str:
        return (f"Job({self.key}, {self.status}, {self.progress:.0%}, "
                f"{self.description!r})")
