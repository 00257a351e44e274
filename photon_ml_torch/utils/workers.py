"""Shared worker-pool plumbing for the host-side data pipelines.

Port of ``photon_ml_tpu/utils/workers.py``. Producer/consumer pipelines
fan CPU work over two pool shapes: a thread pool (the default; the
dominant work releases the GIL — numpy sort/segment passes) and a
spawn-context process pool for workloads where GIL-holding Python work
dominates. This module is the one implementation of that choice.

Spawn, not fork: the parent holds live CUDA runtime threads, and forking
them is undefined; spawn re-imports cleanly. Per-worker context (big
read-only arrays) ships once per worker through the pool initializer
instead of once per task, and so does the main process's trace context: a
spawn worker adopts a spilling tracer parented under the span that
built the pool. The reference's fault-plan shipping waits for the fault
injector (slices 9–10).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars

from photon_ml_torch import obs

# Per-process context installed by the pool initializer (empty in the
# main process and in thread-mode workers, which share its state).
_WORKER_CTX: dict = {}


def worker_ctx() -> dict:
    """The per-process worker context (see ``init_worker``)."""
    return _WORKER_CTX


def init_worker(ctx: dict) -> None:
    """Process-pool initializer: install the shipped context (and, when
    the main process is tracing, a spilling worker tracer) inside the fresh
    worker interpreter."""
    _WORKER_CTX.update(ctx)
    trace_ctx = ctx.get("obs_trace")
    if trace_ctx is not None:
        obs.adopt_worker_context(trace_ctx)


class _PropagatingThreadPool(cf.ThreadPoolExecutor):
    """Thread pool whose tasks run under a COPY of the submitter's
    contextvars — worker-side spans parent under the span that
    submitted them instead of floating at the trace root."""

    def submit(self, fn, /, *args, **kwargs):
        ctx = contextvars.copy_context()
        return super().submit(ctx.run, fn, *args, **kwargs)


def make_pool(mode: str, workers: int, ctx: dict,
              thread_name_prefix: str = "pml-worker"):
    """A thread or spawn-process executor with ``ctx`` installed in every
    process-mode worker (thread-mode workers see the main process's state
    directly and need no initializer). Both shapes propagate the active
    trace context: threads via contextvars, processes via the shipped
    ctx + the tracer's spill file (docs/OBSERVABILITY.md)."""
    if mode == "process":
        import multiprocessing as mp

        trace_ctx = obs.worker_context()
        if trace_ctx is not None:
            ctx = {**ctx, "obs_trace": trace_ctx}
        return cf.ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("spawn"),
            initializer=init_worker, initargs=(ctx,))
    return _PropagatingThreadPool(max_workers=workers,
                                  thread_name_prefix=thread_name_prefix)
