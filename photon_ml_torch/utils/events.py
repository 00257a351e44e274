"""Training lifecycle events: emitter and listener registry.

Port of ``photon_ml_tpu/utils/events.py``. Reference parity: photon-lib
``event/`` (the PhotonMLEvent hierarchy and the EventEmitter trait that
training programs consume for audit logging and progress reporting): plain
dataclass events dispatched synchronously, so a listener is just a
callable. Listeners must be cheap and non-failing; a raising listener is
logged and detached rather than killing training.

The events here are the ones the ported paths emit (coordinate descent,
checkpoint recovery, the projected random effect's staging pipeline, the
streamed fixed effect's chunk staging, the convergence watchdogs, and
scoring: offline by ``game_score`` and online by the serving service),
with the reference's field names; the others come with the slices that
emit them. ``obs/bridge.py`` turns each
``*Start``/``*Finish`` pair into a span and the point events into
timeline instants and counters.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

logger = logging.getLogger("photon_ml_torch.events")


@dataclasses.dataclass(frozen=True)
class Event:
    """Base class for all training events (PhotonMLEvent parity)."""


@dataclasses.dataclass(frozen=True)
class TrainingStart(Event):
    task: str
    update_sequence: tuple
    iterations: int


@dataclasses.dataclass(frozen=True)
class CoordinateUpdate(Event):
    """One (iteration, coordinate) block update finished
    (PhotonOptimizationLogEvent parity)."""

    iteration: int
    coordinate: str
    train_seconds: float
    validation: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class TrainingFinish(Event):
    task: str
    total_updates: int


@dataclasses.dataclass(frozen=True)
class CheckpointRecovered(Event):
    """A corrupted checkpoint artifact failed its CRC and the manager
    fell back to the previous committed generation (game/checkpoint.py).
    ``done_steps`` is the step count of the RECOVERED state."""

    directory: str
    done_steps: int
    reason: str


@dataclasses.dataclass(frozen=True)
class StagingStart(Event):
    """One random-effect staging pipeline starting: ``num_shards`` staged
    bucket groups over ``workers`` pool workers (``mode`` "thread" or
    "process"); ``cached_shards`` of them will come from the staging cache
    without restaging."""

    label: str  # "<re_type>:<shard_id>"
    num_shards: int
    workers: int
    mode: str
    cached_shards: int


@dataclasses.dataclass(frozen=True)
class StagingShard(Event):
    """One staged bucket group became available to the fit stream.
    ``source`` is "staged" (projected now) or "cache" (memory-mapped from
    the staging cache); ``seconds`` is the projection+gather time for
    staged shards (0.0 for cache hits)."""

    label: str
    index: int
    bucket: int
    entities: int
    seconds: float
    source: str


@dataclasses.dataclass(frozen=True)
class StagingRetry(Event):
    """One staged shard's task failed and is being retried (bounded,
    jittered backoff — docs/ROBUSTNESS.md). ``attempt`` is 1-based."""

    label: str
    index: int
    attempt: int
    error: str


@dataclasses.dataclass(frozen=True)
class StagingStraggler(Event):
    """One staged shard exceeded the straggler deadline and was
    re-staged serially; the late pool result is discarded (content is
    scheduling-independent, so either producer's bytes are THE bytes)."""

    label: str
    index: int
    waited_seconds: float


@dataclasses.dataclass(frozen=True)
class StreamStageStart(Event):
    """One streamed fixed-effect chunk-staging pass starting: the
    coordinate's SparseShard canonicalizes into ``num_chunks``
    hot-dense/cold-ELL chunks over ``workers`` staging threads
    (docs/STREAMING.md)."""

    shard_id: str
    num_rows: int
    chunk_rows: int
    num_chunks: int
    workers: int


@dataclasses.dataclass(frozen=True)
class StreamStageFinish(Event):
    """The chunk-staging pass ended (finally-guarded pair with
    StreamStageStart). ``num_chunks`` is 0 when staging raised before
    the layout was built."""

    shard_id: str
    num_chunks: int
    seconds: float


@dataclasses.dataclass(frozen=True)
class WatchdogAlert(Event):
    """A convergence watchdog fired (obs/watchdog.py): ``kind`` names
    the detector (nan/stall/divergence/slow_iter/gap), ``action`` what
    happened (warn/stop/raise). The obs bridge turns these into timeline
    instants + ``photon_watchdog_alerts_total{kind=...}``."""

    kind: str
    action: str
    detail: str
    coordinate: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class StagingFinish(Event):
    """Every shard of one staging pipeline is produced (NOT necessarily
    consumed — consumption is the fit stream's side of the handoff)."""

    label: str
    num_shards: int
    cached_shards: int
    wall_seconds: float


@dataclasses.dataclass(frozen=True)
class ScoringStart(Event):
    """A scoring lifecycle begins — one offline driver run (``source=
    "game_score"``) or one online service coming up (``source="serving"``,
    ``num_rows`` None: the stream is unbounded)."""

    source: str
    num_rows: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ScoringBatch(Event):
    """One device scoring batch finished: ``rows`` real rows scored inside
    a ``padded_rows``-shaped program (shape-bucketing pads; padded_rows ==
    rows on the unbatched offline path)."""

    source: str
    rows: int
    padded_rows: int
    seconds: float


@dataclasses.dataclass(frozen=True)
class ScoringFinish(Event):
    source: str
    num_rows: int
    wall_seconds: float


class EventEmitter:
    """Synchronous listener registry (EventEmitter trait parity)."""

    def __init__(self):
        self._listeners: list[Callable[[Event], None]] = []

    def register(self, listener: Callable[[Event], None]) -> None:
        self._listeners.append(listener)

    def unregister(self, listener: Callable[[Event], None]) -> None:
        self._listeners.remove(listener)

    def emit(self, event: Event) -> None:
        for listener in list(self._listeners):
            try:
                listener(event)
            except Exception:
                logger.exception(
                    "event listener %r failed on %r — detaching it",
                    listener, event)
                if listener in self._listeners:  # may have self-unregistered
                    self._listeners.remove(listener)


# Process-wide default emitter: programs and libraries emit here unless
# handed an explicit one.
default_emitter = EventEmitter()
