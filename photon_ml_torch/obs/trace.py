"""Span/Tracer hierarchical tracing core (docs/OBSERVABILITY.md).

Port of ``photon_ml_tpu/obs/trace.py``: hierarchical spans on monotonic
clocks, exported as Chrome trace-event JSON (loadable in
``chrome://tracing`` or https://ui.perfetto.dev). A span times the HOST
side of its site; work the site enqueues on a CUDA stream runs later, so
device time belongs to ``torch.profiler`` or to CUDA events read where
the host already waits (the streamed chunk transfers,
``ops/streaming_sparse.py``, record theirs that way).

Design rules:

* **Finally-safe by construction** — the blessed API is the context
  manager (``with tracer.span("name"): ...``); the raw pair
  (``tracer.start()`` / ``Span.end()``) exists only for bridge-style code
  whose open and close live in different callbacks.
* **Monotonic durations, wall-clock anchors** — a span's duration comes
  off ``time.perf_counter()`` (an NTP step must not dent a measurement);
  its POSITION on the timeline is anchored by one ``time.time_ns()``
  timestamp so spans from different PROCESSES (spawn pool workers) land
  on one comparable axis.
* **Contextvar parenting** — the current span lives in a
  ``contextvars.ContextVar``, so nesting follows the call structure, not
  the class structure, and thread pools propagate it by running tasks
  under a copied context (``utils/workers.make_pool``). Spawn-pool
  workers cannot share the main process's tracer object; they adopt a
  process-local tracer that SPILLS finished spans to a shared JSONL file
  (one atomic appended line per span) which the main process merges at
  export.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Optional

# The current span (an id string), propagated by contextvar so nesting
# follows the call structure across `with` scopes and copied contexts.
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "photon_obs_current_span", default=None)


class Span:
    """One timed scope. Use as a context manager, or close with
    :meth:`end` from a ``finally``."""

    __slots__ = ("tracer", "name", "cat", "span_id", "parent_id", "args",
                 "tid", "t0_perf", "t0_epoch_ns", "dur", "_token", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 span_id: str, parent_id: Optional[str], args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args
        self.tid = threading.get_ident()
        # Duration base is monotonic; the epoch stamp is a
        # TIMESTAMP anchoring the span on the cross-process time axis.
        self.t0_perf = time.perf_counter()
        self.t0_epoch_ns = time.time_ns()
        self.dur = None  # seconds; None while open
        self._token = _CURRENT.set(span_id)
        self._done = False
        tracer._opened(self)

    def set(self, **args) -> "Span":
        """Attach/overwrite span attributes (visible in the trace args)."""
        self.args.update(args)
        return self

    def end(self, **args) -> None:
        """Close the span (idempotent) and record it on the tracer."""
        if self._done:
            return
        self._done = True
        self.dur = time.perf_counter() - self.t0_perf
        if args:
            self.args.update(args)
        try:
            _CURRENT.reset(self._token)
        except ValueError:
            # Closed from a different context than it was opened in
            # (bridge pairs across callbacks): restore the parent
            # explicitly so later spans in THIS context nest correctly.
            _CURRENT.set(self.parent_id)
        self.tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.end()


class Tracer:
    """Process-local span recorder with Chrome trace-event export.

    ``spill_path`` makes finished spans ALSO append to a JSONL file —
    the cross-process merge channel for spawn-pool workers (each line is
    one complete Chrome event; O_APPEND keeps concurrent writers from
    interleaving). ``default_parent`` seeds the parent of root spans
    (a worker tracer parents its roots under the main process's span that
    submitted the work).
    """

    def __init__(self, label: str = "driver",
                 spill_path: Optional[str] = None,
                 default_parent: Optional[str] = None):
        self.label = label
        self.spill_path = spill_path
        self.default_parent = default_parent
        self.pid = os.getpid()
        self.epoch_ns = time.time_ns()  # export time base (timestamp)
        self._lock = threading.Lock()
        self._finished: list[Span] = []
        self._live: dict[str, Span] = {}  # open spans, by id
        self._instants: list[dict] = []
        self._deferred: list[tuple] = []  # (fn, args), run at export
        self._seq = 0
        self._started_total = 0

    # -- span lifecycle ----------------------------------------------------

    def _new_id(self) -> str:
        with self._lock:
            self._seq += 1
            self._started_total += 1
            return f"{self.pid:x}.{self._seq:x}"

    def _opened(self, span: Span) -> None:
        with self._lock:
            self._live[span.span_id] = span

    def span(self, name: str, cat: str = "app", **args) -> Span:
        """Open a span as a context manager (the blessed, finally-safe
        API): ``with tracer.span("stream.pass"): ...``."""
        parent = _CURRENT.get() or self.default_parent
        return Span(self, name, cat, self._new_id(), parent, dict(args))

    def start(self, name: str, cat: str = "app",
              parent: Optional[str] = None, **args) -> Span:
        """RAW begin — the caller owns the matching :meth:`Span.end`.
        Only for open/close pairs that cannot share a lexical scope
        (the event bridge); anywhere else use :meth:`span`."""
        p = parent if parent is not None else (_CURRENT.get()
                                               or self.default_parent)
        return Span(self, name, cat, self._new_id(), p, dict(args))

    def instant(self, name: str, cat: str = "app", **args) -> None:
        """A zero-duration marker event (Chrome ``ph: "i"``)."""
        now_ns = time.time_ns()
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._ts_us(now_ns), "epoch_ns": now_ns,
              "pid": self.pid, "tid": threading.get_ident(),
              "args": args}
        with self._lock:
            self._instants.append(ev)
        self._spill(ev)

    def current(self) -> Optional[str]:
        """The current contextvar span id (the worker-ctx parent seed)."""
        return _CURRENT.get() or self.default_parent

    def record_complete(self, name: str, cat: str = "app", *,
                        t0_epoch_ns: int, dur_s: float,
                        parent: Optional[str] = None,
                        tid: Optional[int] = None, **args) -> str:
        """Record an already-measured interval as a CLOSED span.

        For queue-crossing scopes whose open and close are observed after
        the fact from measured timestamps — a serving request's life from
        enqueue (HTTP handler thread) to respond (batcher worker thread)
        is attributed in one place, AFTER the interval ended, so there is
        no live ``Span`` to carry across threads. The span never touches
        the contextvar (nothing can nest "inside" a finished interval)
        and needs no ``end()``: it is born closed. Returns the span id so
        callers can parent attribution children under it.
        """
        sp = object.__new__(Span)
        sp.tracer = self
        sp.name = name
        sp.cat = cat
        sp.span_id = self._new_id()
        sp.parent_id = parent
        sp.args = dict(args)
        sp.tid = threading.get_ident() if tid is None else tid
        sp.t0_perf = 0.0  # unused: dur is explicit
        sp.t0_epoch_ns = int(t0_epoch_ns)
        sp.dur = float(dur_s)
        sp._token = None
        sp._done = True
        with self._lock:
            self._finished.append(sp)
        if self.spill_path is not None:  # skip the event build otherwise
            self._spill(self._event(sp))
        return sp.span_id

    def defer(self, fn, *args) -> None:
        """Queue ``fn(*args)`` to run at export, before the trace is
        built: a hot path hands over the raw material of spans it has
        already measured (one list append under the lock) and the export
        records them (``record_complete``), off the hot path. The
        serving flush does this for its requests' spans: the batcher's
        worker thread is the service's critical path."""
        with self._lock:
            self._deferred.append((fn, args))

    def _run_deferred(self) -> None:
        with self._lock:
            todo, self._deferred = self._deferred, []
        for fn, args in todo:
            fn(*args)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._live.pop(span.span_id, None)
            self._finished.append(span)
        self._spill(self._event(span))

    # -- export ------------------------------------------------------------

    def _ts_us(self, epoch_ns: int) -> float:
        return (epoch_ns - self.epoch_ns) / 1e3

    def _event(self, sp: Span, unfinished: bool = False) -> dict:
        dur = sp.dur if sp.dur is not None \
            else time.perf_counter() - sp.t0_perf
        args = dict(sp.args)
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        if unfinished:
            args["unfinished"] = True
        return {"name": sp.name, "cat": sp.cat, "ph": "X",
                "ts": self._ts_us(sp.t0_epoch_ns), "dur": dur * 1e6,
                "pid": self.pid, "tid": sp.tid, "args": args}

    def open_spans(self) -> int:
        with self._lock:
            return len(self._live)

    def chrome_trace(self, other_data: Optional[dict] = None) -> dict:
        """The full Chrome trace-event JSON object: finished spans,
        instants, spilled worker-process spans, and process/thread
        metadata. Unclosed spans export with ``args.unfinished`` so
        ``cli/obs.py verify`` can flag the leak instead of hiding it."""
        self._run_deferred()
        with self._lock:
            finished = list(self._finished)
            live = list(self._live.values())
            instants = list(self._instants)
            open_count = len(live)
            started = self._started_total
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": f"photon {self.label}"}}]
        events += [self._event(sp) for sp in finished]
        events += [self._event(sp, unfinished=True) for sp in live]
        events += instants
        events += self._read_spill()
        meta = {"open_spans": open_count, "spans_started": started,
                "clock_epoch_ns": self.epoch_ns}
        if other_data:
            meta.update(other_data)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": meta}

    def dump(self, path: str, other_data: Optional[dict] = None) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(other_data), f, default=str)
        os.replace(tmp, path)

    # -- cross-process spill -----------------------------------------------

    def _spill(self, event: dict) -> None:
        if self.spill_path is None or self.pid == _SPILL_OWNER_PID.get(
                self.spill_path):
            return
        try:
            line = json.dumps(event, default=str) + "\n"
            # One O_APPEND write per line: concurrent worker processes
            # append whole lines without interleaving.
            fd = os.open(self.spill_path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, line.encode())
            finally:
                os.close(fd)
        except OSError as e:
            # Tracing must never take down the work it observes.
            import logging

            logging.getLogger("photon_ml_torch.obs").warning(
                "span spill to %s failed: %s", self.spill_path, e)

    def _read_spill(self) -> list[dict]:
        if self.spill_path is None or not os.path.exists(self.spill_path):
            return []
        out = []
        with open(self.spill_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = dict(json.loads(line))
                except ValueError:
                    continue  # torn tail line from a killed worker
                # Worker clocks anchor on the epoch; rebase onto ours.
                if "epoch_ns" in ev:
                    ev["ts"] = self._ts_us(int(ev.pop("epoch_ns")))
                out.append(ev)
        return out

    def mark_spill_owner(self) -> None:
        """Record that THIS process owns the spill file (the main one): its
        own spans stay in memory; only other processes append."""
        if self.spill_path is not None:
            _SPILL_OWNER_PID[self.spill_path] = self.pid
            try:
                # Stale content from a previous run must not merge into
                # this one's export (workers recreate the file lazily).
                os.remove(self.spill_path)
            except OSError:
                pass  # absent is the normal case


# spill_path → owning (main process) pid; workers never match and thus
# spill.
_SPILL_OWNER_PID: dict = {}


class WorkerTracer(Tracer):
    """A spawn-pool worker's tracer: every finished span goes straight to
    the spill file with an absolute epoch stamp (the main process rebases onto
    its own clock at export)."""

    def _event(self, sp: Span, unfinished: bool = False) -> dict:
        ev = super()._event(sp, unfinished)
        # Ship the absolute stamp; the main process's ``ts`` base differs.
        ev["epoch_ns"] = sp.t0_epoch_ns
        ev.pop("ts", None)
        return ev
