"""Job — a unit of work with status and progress — a minimal port of
``h2o3_tpu/models/job.py``. It runs its function synchronously and records
status, progress, timing and any exception (reference: ``water/Job.java``);
the reference's DKV registration, cancellation, deadlines, tracing and
background threads are left out of this slice.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable


class Job:
    CREATED, RUNNING, DONE, FAILED = "CREATED", "RUNNING", "DONE", "FAILED"

    def __init__(self, description: str, key: str | None = None):
        self.key = key or f"job_{uuid.uuid4().hex[:12]}"
        self.description = description
        self.status = Job.CREATED
        self.progress = 0.0
        self.progress_msg = ""
        self.start_time: float | None = None
        self.end_time: float | None = None
        self.exception: Exception | None = None
        self.result: Any = None

    def run(self, fn: Callable[["Job"], Any]) -> "Job":
        """Execute ``fn(job)``; ``fn`` reports through :meth:`update`."""
        self.status = Job.RUNNING
        self.start_time = time.time()
        try:
            self.result = fn(self)
            self.progress = 1.0
            self.status = Job.DONE
        except Exception as e:    # the Job carries the error to its caller
            self.status = Job.FAILED
            self.exception = e
        finally:
            self.end_time = time.time()
        return self

    def update(self, progress: float, msg: str = "") -> None:
        self.progress = float(progress)
        self.progress_msg = msg

    def __repr__(self) -> str:
        return (f"Job({self.key}, {self.status}, {self.progress:.0%}, "
                f"{self.description!r})")
