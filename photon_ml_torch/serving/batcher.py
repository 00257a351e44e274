"""Micro-batcher: queue scoring requests, flush on size or deadline.

Port of ``photon_ml_tpu/serving/batcher.py``. A flush happens when
``max_batch`` requests are queued or when the OLDEST queued request has
waited ``max_wait_ms``: an idle service scores a lone request after at
most one wait window, and a busy one ships full batches.

Batch SHAPES are the flush function's concern (the service pads each
flush to a power-of-two bucket); the batcher's concern is time: one
worker thread, one condition variable, futures for the callers.

Tracing: with a tracer active, each flush is a ``serving.flush`` span
(the service parents each request's ``serving.request`` span into it)
and each request records its enqueue wall-clock stamp at submit; off,
both are one ``None`` check.

Failure contract — a future returned by ``submit`` ALWAYS resolves:

- a flush that raises fails exactly its batch's futures and the loop
  keeps serving;
- a flush that returns the wrong number of scores fails the batch with a
  defined error;
- the worker thread is supervised: if it dies anyway (a BaseException),
  every pending future fails fast with ``BatcherDied`` and a fresh worker
  starts (``restarts`` counts them);
- each request carries a deadline: an entry that expires in the queue
  fails with ``DeadlineExceeded``;
- the queue is bounded (``max_queue``): when it is full, ``submit``
  raises ``BatcherQueueFull`` at once (load shedding).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from photon_ml_torch import obs

logger = logging.getLogger("photon_ml_torch.serving")

# Process-wide request ids, assigned at submit, so a request is
# addressable across the thread boundary (attribution payload, logs).
_REQUEST_IDS = itertools.count(1)


class BatcherQueueFull(RuntimeError):
    """Admission control: the request queue is at ``max_queue``; the
    caller should shed load (HTTP: 503). Carries the observed ``depth``
    and ``max_queue``."""

    def __init__(self, message: str, depth: Optional[int] = None,
                 max_queue: Optional[int] = None):
        super().__init__(message)
        self.depth = depth
        self.max_queue = max_queue


class BatcherDied(RuntimeError):
    """The worker thread died while this request was pending; the
    request was NOT scored, and retrying it is safe."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it was scored."""


@dataclass(eq=False)  # identity semantics: requests may hold numpy arrays
class _Entry:
    request: object
    future: Future = field(default_factory=Future)
    # Monotonic: the flush deadline and the request latency are durations.
    enqueued_at: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None  # monotonic; None = no deadline
    request_id: int = 0  # assigned at submit (_REQUEST_IDS)
    # Stage attribution, filled by the flush function BEFORE the future
    # resolves — whoever holds the future reads it race-free after
    # ``result()``.
    attribution: Optional[dict] = None
    # Wall-clock enqueue stamp, taken only when tracing is on: anchors
    # the request's span on the trace's cross-thread time axis
    # (durations still come off ``enqueued_at``'s monotonic clock).
    t0_epoch_ns: Optional[int] = None


def bucket_batch(n: int, max_batch: int) -> int:
    """Padded batch size for ``n`` requests: next power of two, capped at
    ``max_batch``. A log-sized set of shapes keeps every batch shape the
    scorer sees within O(log max_batch) buckets."""
    if n >= max_batch:
        return max_batch
    return 1 << max(0, (int(n) - 1)).bit_length()


class MicroBatcher:
    """Supervised background flusher over a bounded-delay request queue.

    ``flush_fn(entries)`` scores ``entries`` (at most ``max_batch``) and
    returns one float per entry, in order. It runs on the worker thread;
    exceptions propagate to every future in the flush.
    """

    def __init__(
        self,
        flush_fn: Callable[[Sequence[_Entry]], Sequence[float]],
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        on_worker_death: Optional[Callable[[BaseException], None]] = None,
        on_deadline: Optional[Callable[[int], None]] = None,
        depth_gauge=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._flush_fn = flush_fn
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = None if max_queue is None else int(max_queue)
        self.default_deadline = (None if default_deadline_s is None
                                 else float(default_deadline_s))
        self._on_worker_death = on_worker_death
        self._on_deadline = on_deadline
        # A gauge (set() + peak tracking) observed on every queue
        # transition.
        self._depth_gauge = depth_gauge
        self._queue: list[_Entry] = []
        self._inflight: list[_Entry] = []  # batch being flushed right now
        self._cond = threading.Condition()
        self._running = True
        self.restarts = 0  # worker deaths recovered from
        self.expired = 0  # entries failed on their deadline
        self._worker = self._spawn_worker()

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(target=self._loop,
                             name="photon-serving-batcher",
                             daemon=True)
        t.start()
        return t

    def submit(self, request, deadline_s: Optional[float] = None) -> Future:
        """Queue one request. Raises ``BatcherQueueFull`` when admission
        control rejects it; otherwise the returned future ALWAYS
        resolves — with the score, the flush error, ``DeadlineExceeded``,
        or ``BatcherDied``."""
        entry = _Entry(request)
        entry.request_id = next(_REQUEST_IDS)
        if obs.tracer() is not None:
            entry.t0_epoch_ns = time.time_ns()
        ttl = self.default_deadline if deadline_s is None else deadline_s
        if ttl is not None:
            entry.deadline = entry.enqueued_at + float(ttl)
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is closed")
            depth = len(self._queue)
            if self.max_queue is not None and depth >= self.max_queue:
                raise BatcherQueueFull(
                    f"scoring queue is full ({depth} pending, "
                    f"max {self.max_queue}); shedding load",
                    depth=depth, max_queue=self.max_queue)
            self._queue.append(entry)
            if self._depth_gauge is not None:
                self._depth_gauge.set(depth + 1)
            self._cond.notify()
        return entry.future

    # -- worker ------------------------------------------------------------

    def _expire_locked(self, now: float) -> list[_Entry]:
        """Remove queued entries whose deadline passed (caller holds the
        lock); their futures are failed OUTSIDE the lock by the caller."""
        if not any(e.deadline is not None for e in self._queue):
            return []
        expired = [e for e in self._queue
                   if e.deadline is not None and now >= e.deadline]
        if expired:
            dead = {id(e) for e in expired}
            self._queue = [e for e in self._queue if id(e) not in dead]
            if self._depth_gauge is not None:
                self._depth_gauge.set(len(self._queue))
        return expired

    def _fail_entries(self, entries: Sequence[_Entry],
                      exc: BaseException) -> None:
        for e in entries:
            if not e.future.done():
                e.future.set_exception(exc)

    def _loop(self) -> None:
        # Supervision wrapper: _serve only exits cleanly on close().
        # Anything escaping it fails every pending future fast and
        # restarts the worker, so no submitter hangs on a dead thread.
        try:
            self._serve()
        except BaseException as exc:
            self._recover(exc)

    def _recover(self, exc: BaseException) -> None:
        logger.exception("batcher worker died (%s) — failing pending "
                         "futures and restarting", type(exc).__name__)
        with self._cond:
            # The batch mid-flush when the thread died is no longer
            # queued; it must fail fast too, or its callers hang.
            pending = self._inflight + self._queue
            self._inflight = []
            self._queue = []
            if self._depth_gauge is not None:
                self._depth_gauge.set(0)
            restart = self._running
            if restart:
                self.restarts += 1
                self._worker = self._spawn_worker()
        self._fail_entries(pending, BatcherDied(
            f"batcher worker died: {type(exc).__name__}: {exc}"))
        if restart and self._on_worker_death is not None:
            try:
                self._on_worker_death(exc)
            except Exception:
                logger.exception("on_worker_death callback failed")

    def _serve(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait()
                if not self._running and not self._queue:
                    return
                # Wait out the remainder of the oldest entry's window
                # unless the batch is already full (or we're draining);
                # entries whose own deadline expires first are failed,
                # not flushed.
                expired = self._expire_locked(time.monotonic())
                deadline = (self._queue[0].enqueued_at + self.max_wait
                            if self._queue else 0.0)
                while (self._running and self._queue
                       and len(self._queue) < self.max_batch
                       and (left := deadline - time.monotonic()) > 0):
                    entry_deadlines = [e.deadline for e in self._queue
                                       if e.deadline is not None]
                    if entry_deadlines:
                        left = min(left, max(
                            0.0, min(entry_deadlines) - time.monotonic()))
                    self._cond.wait(timeout=max(left, 1e-4))
                    expired.extend(self._expire_locked(time.monotonic()))
                    deadline = (self._queue[0].enqueued_at + self.max_wait
                                if self._queue else 0.0)
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
                self._inflight = batch
                if self._depth_gauge is not None:
                    self._depth_gauge.set(len(self._queue))
            if expired:
                self.expired += len(expired)
                self._fail_entries(expired, DeadlineExceeded(
                    "request expired in the scoring queue"))
                if self._on_deadline is not None:
                    try:
                        self._on_deadline(len(expired))
                    except Exception:
                        logger.exception("on_deadline callback failed")
            if not batch:
                continue
            try:
                # One span per device flush; off, one None check a batch.
                with obs.span("serving.flush", cat="serving",
                              rows=len(batch)):
                    scores = self._flush_fn(batch)
                if len(scores) != len(batch):
                    # A silent zip() over a short result would leave the
                    # tail pending forever; fail loudly instead.
                    raise RuntimeError(
                        f"flush returned {len(scores)} scores for "
                        f"{len(batch)} requests")
                for entry, score in zip(batch, scores):
                    if not entry.future.done():
                        entry.future.set_result(score)
            except Exception as exc:  # propagate to callers, keep serving
                self._fail_entries(batch, exc)
            # NOT a finally: a BaseException must leave _inflight set so
            # the supervisor (_recover) can fail this batch fast.
            with self._cond:
                self._inflight = []

    def close(self) -> None:
        """Drain the queue, then stop the worker (idempotent)."""
        with self._cond:
            self._running = False
            worker = self._worker
            self._cond.notify_all()
        if worker.is_alive():
            worker.join()
