"""Overlapped model builds — the port of
``h2o3_tpu/orchestration/parallel_build.py``.

The reference overlaps independent builds on its fork/join pools
(``hex/grid/GridSearch.java`` parallel builds,
``water/ParallelizationTask.java``). Here they are host threads: while one
build's kernels run on the card, another build's host work (binning,
split search, the enqueue of its device ops) proceeds, and each build
leases a CUDA stream of its own from the scheduler
(:mod:`~h2o3_tpu_torch.orchestration.scheduler`). The GIL serialises the
host enqueue, so the gain is bounded by the share of host time spent
outside Python. The JAX package carried its tracing span into the pool
threads; the port carries the submitter's ``contextvars`` the same way
(tracing itself waits for the observability slice).
"""

from __future__ import annotations

import contextvars
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Iterable


def windowed_parallel(
    items: Iterable[Any],
    par: int,
    can_submit: Callable[[int], bool],
    run_one: Callable[[Any], Any],
    scheduler=None,
    job_meta: Callable[[Any], dict] | None = None,
) -> tuple[list[tuple[Any, Any, Exception | None]], bool]:
    """Run ``run_one(item)`` over a lazy item stream with at most ``par`` in
    flight. ``can_submit(n)`` gates each submission (budget, deadline) and
    receives the count of successful or in-flight builds, so a failed build
    releases its budget; the stream is never advanced past the gate, so a
    huge space stays unenumerated.

    With a ``scheduler`` every build runs inside one of its leases, sized by
    ``job_meta(item)`` (``rows``, ``algo``).

    Returns ``(results, stream_exhausted)``: results are ``(item, result,
    exc)`` in submission order, whatever order the builds finish in, and
    ``stream_exhausted`` is False when the gate, not the stream's end,
    stopped the run."""
    if scheduler is not None:
        inner = run_one

        def run_one(item):   # noqa: F811 — the leased wrapper on purpose
            meta = job_meta(item) if job_meta is not None else {}
            with scheduler.lease(**meta):
                return inner(item)

    it = iter(items)
    if par <= 1:
        out: list = []
        n_ok = 0
        for item in it:
            if not can_submit(n_ok):
                return out, False
            try:
                out.append((item, run_one(item), None))
                n_ok += 1
            except Exception as e:          # noqa: BLE001 — recorded per item
                out.append((item, None, e))
        return out, True

    results: dict[int, tuple] = {}
    futs: dict = {}
    n_sub = 0
    n_failed = 0
    stream_ended = False
    with ThreadPoolExecutor(max_workers=par,
                            thread_name_prefix="model-build") as ex:
        while True:
            # the gate sees successes and in-flight builds: a failure that
            # completed released its budget, so a closed gate can reopen
            while (not stream_ended and len(futs) < par
                   and can_submit(n_sub - n_failed)):
                try:
                    item = next(it)
                except StopIteration:
                    stream_ended = True
                    break
                # pool threads do not inherit the submitter's context
                ctx = contextvars.copy_context()
                futs[ex.submit(ctx.run, run_one, item)] = (n_sub, item)
                n_sub += 1
            if not futs:
                break
            done, _ = wait(list(futs), return_when=FIRST_COMPLETED)
            for f in done:
                i, item = futs.pop(f)
                try:
                    results[i] = (item, f.result(), None)
                except Exception as e:      # noqa: BLE001
                    results[i] = (item, None, e)
                    n_failed += 1
    return [results[i] for i in sorted(results)], stream_ended
