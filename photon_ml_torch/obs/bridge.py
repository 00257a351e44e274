"""Event→span bridge: lifecycle events become spans, counters, instants.

Port of ``photon_ml_tpu/obs/bridge.py``. Every finally-guarded
``*Start``/``*Finish`` pair (Training, StreamStage and Scoring here;
Staging and Ingest come with the slices that emit them —
utils/events.py)
becomes a span with ZERO call-site rewrites: the bridge is one listener
on the event emitter. Because events fire synchronously in the emitting
thread and the pairs are finally-guarded, opening the span on Start and
closing it on Finish puts it exactly where a hand-written ``with`` block
would — including contextvar parenting, so explicit spans opened INSIDE
a lifecycle nest under it.

Non-pair events feed the metrics registry (recovery, watchdog and
coordinate-update counters) and drop instant markers on the timeline.
The counter table is the reference's whole table: events of slices not
ported yet simply never arrive.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from photon_ml_torch.utils import events as ev_mod

logger = logging.getLogger("photon_ml_torch.obs")

# *Start/*Finish pair prefix → the event field that keys concurrent
# scopes of the same kind (None: at most one open scope of that kind).
_PAIR_KEYS = {
    "Training": "task",
    "Staging": "label",
    "StreamStage": "shard_id",
    "Ingest": None,
    "Scoring": "source",
}

# Event class name → counter fed from the event stream.
_EVENT_COUNTERS = {
    "StagingRetry": "photon_staging_retries_total",
    "StagingStraggler": "photon_staging_stragglers_total",
    "CheckpointRecovered": "photon_checkpoint_recoveries_total",
    "BootRecovered": "photon_boot_recoveries_total",
    "IngestFallback": "photon_ingest_fallbacks_total",
}


class EventSpanBridge:
    """One emitter listener; register via :func:`install_bridge`."""

    def __init__(self, tracer=None, metrics=None):
        # None = resolve the active runtime object per event, so the
        # bridge keeps working across obs.enable()/disable() cycles.
        self._tracer = tracer
        self._metrics = metrics
        self._open: dict[tuple, object] = {}
        self.opened = 0
        self.closed = 0

    def _active(self):
        from photon_ml_torch import obs

        return (self._tracer if self._tracer is not None else obs.tracer(),
                self._metrics if self._metrics is not None
                else obs.metrics())

    def stats(self) -> dict:
        return {"bridge_spans_opened": self.opened,
                "bridge_spans_closed": self.closed,
                "bridge_spans_leaked": len(self._open)}

    def __call__(self, event: ev_mod.Event) -> None:
        tracer, metrics = self._active()
        if tracer is None and metrics is None:
            return
        name = type(event).__name__
        args = dataclasses.asdict(event)
        if name.endswith("Start"):
            self._on_start(tracer, name[:-5], args)
        elif name.endswith("Finish"):
            self._on_finish(name[:-6], args)
        else:
            self._on_point(tracer, metrics, name, args)

    # -- pair handling -----------------------------------------------------

    def _scope_key(self, kind: str, args: dict) -> tuple:
        field = _PAIR_KEYS.get(kind)
        return (kind, args.get(field) if field else None)

    def _on_start(self, tracer, kind: str, args: dict) -> None:
        if tracer is None:
            return
        key = self._scope_key(kind, args)
        if key in self._open:
            # A Start with its predecessor still open means a leaked
            # scope upstream — close the stale one so
            # the trace shows two bounded spans, not one covering both.
            logger.warning("bridge: %s scope %r reopened while open — "
                           "closing the stale span", kind, key[1])
            self._end(key, {"stale": True})
        # The bridge is the sanctioned raw-pair user: open and close
        # arrive as separate event callbacks, pairing delegated to the
        # finally guards at the emit sites.
        self._open[key] = tracer.start(
            f"{_snake(kind)}", cat="lifecycle", **args)
        self.opened += 1

    def _on_finish(self, kind: str, args: dict) -> None:
        self._end(self._scope_key(kind, args), args)

    def _end(self, key: tuple, args: dict) -> None:
        span = self._open.pop(key, None)
        if span is None:
            return  # Finish without Start (bridge installed mid-scope)
        span.end(**args)
        self.closed += 1

    def close_all(self) -> None:
        """Close anything still open (the shutdown path) so the dumped
        trace never contains phantom open lifecycle spans."""
        for key in list(self._open):
            self._end(key, {"closed_at_shutdown": True})

    # -- point events ------------------------------------------------------

    def _on_point(self, tracer, metrics, name: str, args: dict) -> None:
        if metrics is not None:
            counter = _EVENT_COUNTERS.get(name)
            if counter is not None:
                metrics.counter(counter).inc()
            elif name == "StagingShard":
                metrics.counter("photon_staging_shards_total",
                                source=str(args.get("source"))).inc()
            elif name == "IngestBlock":
                metrics.counter("photon_ingest_chunks_total",
                                source=str(args.get("source"))).inc()
                metrics.counter("photon_ingest_records_total").inc(
                    float(args.get("records") or 0))
            elif name == "WatchdogAlert":
                metrics.counter("photon_watchdog_alerts_total",
                                kind=str(args.get("kind"))).inc()
            elif name == "KernelFallback":
                metrics.counter("photon_kernel_fallbacks_total",
                                kernel=str(args.get("kernel"))).inc()
            elif name == "CoordinateUpdate":
                metrics.histogram(
                    "photon_coordinate_update_seconds").observe(
                        float(args.get("train_seconds") or 0.0))
            elif name == "ScoringBatch":
                metrics.counter("photon_scoring_rows_total").inc(
                    float(args.get("rows") or 0))
        if tracer is not None and name != "ScoringBatch":
            # ScoringBatch is per-flush in serving — too hot for a
            # timeline marker; its volume lives in the counter above.
            args.pop("validation", None)  # free-form dict, not trace args
            tracer.instant(_snake(name), cat="event", **args)


def _snake(name: str) -> str:
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i and not name[i - 1].isupper():
            out.append("_")
        out.append(c.lower())
    return "".join(out)


_INSTALLED: Optional[EventSpanBridge] = None


def install_bridge(emitter: Optional[ev_mod.EventEmitter] = None
                   ) -> EventSpanBridge:
    """Register the bridge on ``emitter`` (default: the process-wide
    default emitter). Idempotent: one bridge per process."""
    global _INSTALLED
    if _INSTALLED is None:
        _INSTALLED = EventSpanBridge()
        (emitter or ev_mod.default_emitter).register(_INSTALLED)
    return _INSTALLED


def uninstall_bridge(emitter: Optional[ev_mod.EventEmitter] = None) -> None:
    global _INSTALLED
    if _INSTALLED is not None:
        _INSTALLED.close_all()
        try:
            (emitter or ev_mod.default_emitter).unregister(_INSTALLED)
        except ValueError:
            pass  # already detached (e.g. a listener failure)
        _INSTALLED = None


def installed_bridge() -> Optional[EventSpanBridge]:
    return _INSTALLED
