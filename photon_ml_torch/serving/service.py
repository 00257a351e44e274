"""ScoringService: the online-inference front door.

Port of ``photon_ml_tpu/serving/service.py``. One service owns the whole
serving pipeline:

    requests → micro-batcher → power-of-two padded batch
             → RE cache resolve (host store → LRU device cache)
             → score on the device → scores

Scoring per flush: each fixed effect is ``mats[sid] @ w`` through
``torch.matmul``; each random effect is the ``serving_score`` kernel
(``ops/kernels/serving_score.py``) over that coordinate's device cache;
then the task's inverse link when ``as_mean``. All device work runs on
the batcher's worker thread under the service lock, on the current CUDA
stream; HTTP handler threads only submit.

Scoring semantics match the offline ``GameModel.score``: scores are
offsets + Σ coordinate contributions, unseen entities contribute zero,
``as_mean`` applies the task's inverse link.

The service emits the reference's scoring lifecycle on ``emitter``:
``ScoringStart(source="serving")`` when it comes up, one
``ScoringBatch`` a flush (which the obs bridge counts into
``photon_scoring_rows_total``) and ``ScoringFinish`` at close.

With a tracer active each request becomes a ``serving.request`` span
parented into the ``serving.flush`` span that scored it, with one child
span per stage (queue wait, assemble, device score, respond) that sum to
it; ``/metrics`` appends the active metrics registry to the service's
own scoreboard.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_torch import obs
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game.models import GameModel
from photon_ml_torch.ops import losses as losses_mod
from photon_ml_torch.ops.kernels import serving_score
from photon_ml_torch.serving.batcher import (BatcherQueueFull,
                                             DeadlineExceeded, MicroBatcher,
                                             bucket_batch)
from photon_ml_torch.serving.metrics import ServingMetrics
from photon_ml_torch.serving.model_store import ResidentModelStore
from photon_ml_torch.utils.events import (ScoringBatch, ScoringFinish,
                                          ScoringStart, default_emitter)

logger = logging.getLogger("photon_ml_torch.serving")


@dataclasses.dataclass
class ScoringRequest:
    """One example to score.

    ``features``: shard id → dense (d,) vector, or a sparse mapping
    ``{"indices": ..., "values": ...}`` (out-of-range indices are padding
    and are dropped). Omitted shards contribute zero.
    ``entity_ids``: RE type → entity id — an int vocabulary row, or a raw
    key resolved through the serving vocabularies. Unknown or missing ids
    fall back to fixed-effect-only scoring.
    """

    features: dict[str, object]
    entity_ids: dict[str, object] = dataclasses.field(default_factory=dict)
    offset: float = 0.0
    uid: object = None


def requests_from_dataset(data: GameDataset) -> list[ScoringRequest]:
    """A GameDataset's rows as ScoringRequests (tests, benches, replays)."""
    out = []
    for i in range(data.num_rows):
        feats: dict[str, object] = {}
        for sid, shard in data.feature_shards.items():
            if isinstance(shard, SparseShard):
                feats[sid] = {"indices": shard.indices[i],
                              "values": shard.values[i]}
            else:
                feats[sid] = np.asarray(shard[i])
        out.append(ScoringRequest(
            features=feats,
            entity_ids={rt: int(ids[i])
                        for rt, ids in data.entity_ids.items()},
            offset=float(data.offsets[i]),
            uid=i,
        ))
    return out


class ScoringService:
    """Low-latency scoring over a resident GameModel on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; see device.py)."""

    def __init__(
        self,
        model: GameModel,
        device: Optional[DeviceLike] = None,
        as_mean: bool = False,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        cache_entities: int = 4096,
        store_shards: int = 8,
        entity_vocabs: Optional[dict[str, dict]] = None,
        cache_dtype: str = "float32",
        max_queue: Optional[int] = None,
        request_deadline_s: Optional[float] = 30.0,
        slo_window_s: float = 60.0,
        slo_availability: float = 0.999,
        slo_latency_ms: Optional[float] = None,
        emitter=default_emitter,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Build and load the kernel library now: a build failure
            # stops the service at start-up, not at its first request.
            serving_score.load()
        # A flush's unique entities must fit the cache simultaneously
        # (the store pins them during resolve), so the effective budget
        # is at least max_batch.
        self.store = ResidentModelStore(
            model, self.device,
            cache_entities=max(int(cache_entities), int(max_batch)),
            store_shards=store_shards, entity_vocabs=entity_vocabs,
            cache_dtype=cache_dtype)
        self.as_mean = bool(as_mean)
        self.max_batch = int(max_batch)
        self._mean_fn = (losses_mod.loss_for_task(self.store.task).mean
                         if self.as_mean else None)
        self.metrics = ServingMetrics(slo_window_s=slo_window_s,
                                      slo_availability=slo_availability,
                                      slo_latency_ms=slo_latency_ms)
        self._lock = threading.Lock()  # serialises resolve+score per flush
        self._bucket_shapes: set[int] = set()
        # Admission control default: a queue much deeper than 16 full
        # batches only buys latency nobody asked for — shed instead.
        self.max_queue = (16 * self.max_batch if max_queue is None
                          else int(max_queue))
        self.batcher = MicroBatcher(
            self._flush, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=self.max_queue,
            default_deadline_s=request_deadline_s,
            on_worker_death=self._on_worker_death,
            on_deadline=self.metrics.record_deadline_exceeded,
            depth_gauge=self.metrics.queue_depth)
        self._closed = False
        self.emitter = emitter
        emitter.emit(ScoringStart(source="serving", num_rows=None))

    def _on_worker_death(self, exc: BaseException) -> None:
        self.metrics.record_recovery()
        logger.error("scoring worker died (%s: %s) — pending requests "
                     "failed fast, worker restarted", type(exc).__name__,
                     exc)

    # -- device scorer -----------------------------------------------------

    def _score_device(self, mats: dict[str, torch.Tensor],
                      offsets: torch.Tensor,
                      slots: dict[str, torch.Tensor]) -> torch.Tensor:
        total = offsets
        for _cid, sid, w in self.store.fixed:
            total = total + torch.matmul(mats[sid], w)
        for st in self.store.random:
            total = total + serving_score.score_rows(
                mats[st.shard_id], slots[st.cid], st.cache, st.cache_scale)
        return self._mean_fn(total) if self._mean_fn is not None else total

    # -- batch assembly ----------------------------------------------------

    def _assemble(self, requests: Sequence[ScoringRequest], padded: int):
        store = self.store
        mats = {sid: np.zeros((padded, dim), np.float32)
                for sid, dim in store.shard_dims.items()}
        offsets = np.zeros(padded, np.float32)
        ids = {st.cid: np.full(len(requests), -1, np.int64)
               for st in store.random}
        for i, req in enumerate(requests):
            offsets[i] = req.offset
            for sid, feats in (req.features or {}).items():
                mat = mats.get(sid)
                if mat is None:
                    raise ValueError(
                        f"request {req.uid!r} carries unknown feature "
                        f"shard {sid!r} (model reads "
                        f"{sorted(store.shard_dims)})")
                d = mat.shape[1]
                if isinstance(feats, dict):
                    fi = np.asarray(feats["indices"], np.int64).reshape(-1)
                    fv = np.asarray(feats["values"], np.float32).reshape(-1)
                elif isinstance(feats, tuple):
                    fi = np.asarray(feats[0], np.int64).reshape(-1)
                    fv = np.asarray(feats[1], np.float32).reshape(-1)
                else:
                    v = np.asarray(feats, np.float32).reshape(-1)
                    if v.shape[0] != d:
                        raise ValueError(
                            f"request {req.uid!r} shard {sid!r}: expected "
                            f"{d} features, got {v.shape[0]}")
                    mat[i] = v
                    continue
                valid = (fi >= 0) & (fi < d)
                np.add.at(mat[i], fi[valid], fv[valid])
            ent = req.entity_ids or {}
            for st in store.random:
                ids[st.cid][i] = store.entity_row_id(
                    st.re_type, ent.get(st.re_type))
        return mats, offsets, ids

    # -- scoring paths -----------------------------------------------------

    def _score_chunk(self, requests: Sequence[ScoringRequest]):
        """Score one ≤max_batch chunk; returns ``(scores, stage_marks)``
        where the marks are the monotonic stage boundaries
        ``(assemble_start, device_start, device_end)``. The device stage
        covers the uploads, the scoring launches and the copy of the
        scores back to the host, which waits for the device."""
        n = len(requests)
        with self._lock:
            t_a0 = time.monotonic()  # assemble: batch build + RE resolve
            padded = bucket_batch(n, self.max_batch)
            mats, offsets, ids = self._assemble(requests, padded)
            slots = self.store.resolve_slots(ids, metrics=self.metrics)
            slots_full = {
                st.cid: np.concatenate([
                    slots[st.cid],
                    np.full(padded - n, st.fallback_slot, np.int32)])
                for st in self.store.random}
            if padded not in self._bucket_shapes:
                self._bucket_shapes.add(padded)
                self.metrics.record_compile()
            t_d0 = time.monotonic()  # device: upload, score, copy back
            dev = self.device
            out = self._score_device(
                {sid: torch.from_numpy(m).to(dev) for sid, m in mats.items()},
                torch.from_numpy(offsets).to(dev),
                {cid: torch.from_numpy(s).to(dev)
                 for cid, s in slots_full.items()})
            out = out.cpu().numpy()
            t_d1 = time.monotonic()
        dt = t_d1 - t_d0
        self.metrics.record_batch(n, padded, dt)
        self.emitter.emit(ScoringBatch(source="serving", rows=n,
                                       padded_rows=padded, seconds=dt))
        return out[:n], (t_a0, t_d0, t_d1)

    def score(self, requests: Sequence[ScoringRequest]) -> np.ndarray:
        """Programmatic batch API: score now, bypassing the queue (the
        device path — bucketing, cache, metrics — is identical)."""
        scores = np.empty(len(requests), np.float32)
        for lo in range(0, len(requests), self.max_batch):
            chunk = requests[lo: lo + self.max_batch]
            scores[lo: lo + len(chunk)] = self._score_chunk(chunk)[0]
        return scores

    def submit(self, request: ScoringRequest,
               deadline_s: Optional[float] = None):
        """Queue one request through the micro-batcher; returns a Future
        resolving to its score. Raises ``BatcherQueueFull`` when
        admission control sheds the request (counted in ``shed_total``);
        the returned future always resolves."""
        try:
            return self.batcher.submit(request, deadline_s=deadline_s)
        except BatcherQueueFull:
            self.metrics.record_shed()
            raise

    def _flush(self, entries):
        try:
            scores, marks = self._score_chunk([e.request for e in entries])
        except Exception:
            self.metrics.record_flush_error()
            raise
        self._attribute(entries, marks)
        return scores

    def _attribute(self, entries, marks) -> None:
        """Per-request latency attribution for one flush: every request
        in the flush experienced the flush's assemble/device/respond
        walls plus its own queue wait, which lasts until the flush's
        assembly starts (the wait for the scoring lock included), so its
        stages sum to its total.

        With tracing on, each request also becomes a ``serving.request``
        span (recorded after the fact: it crosses the submit→worker
        thread boundary) parented into this flush's span, with one child
        span per stage laid end to end, so the children sum to it."""
        t_a0, t_d0, t_d1 = marks  # same clock as _Entry.enqueued_at
        t_done = time.monotonic()
        assemble_s = t_d0 - t_a0
        device_s = t_d1 - t_d0
        respond_s = t_done - t_d1
        tr = obs.tracer()
        traced = []  # (t0_epoch_ns, request_id, queue wait, total)
        for e in entries:
            queue_wait_s = max(t_a0 - e.enqueued_at, 0.0)
            total_s = t_done - e.enqueued_at
            attr = {
                "request_id": e.request_id,
                "queue_wait_ms": round(queue_wait_s * 1e3, 4),
                "assemble_ms": round(assemble_s * 1e3, 4),
                "device_score_ms": round(device_s * 1e3, 4),
                "respond_ms": round(respond_s * 1e3, 4),
                "total_ms": round(total_s * 1e3, 4),
            }
            e.attribution = attr
            # Visible to whoever holds the future, race-free: set_result
            # happens after _flush returns.
            e.future.attribution = attr
            self.metrics.record_request_latency(total_s)
            self.metrics.record_stages(queue_wait_s, assemble_s,
                                       device_s, respond_s)
            if tr is not None and e.t0_epoch_ns is not None:
                traced.append((e.t0_epoch_ns, e.request_id, queue_wait_s,
                               total_s))
        if traced:
            # The spans are built at export: this thread scores the next
            # flush meanwhile.
            tr.defer(_request_spans, tr, tr.current(),
                     threading.get_ident(), traced,
                     (assemble_s, device_s, respond_s))

    # -- lifecycle ---------------------------------------------------------

    @property
    def model_version(self) -> int:
        return self.store.version

    def metrics_text(self) -> str:
        """The ``/metrics`` body: serving's own scoreboard plus, when
        process-wide observability is on, the metrics registry, so one
        endpoint exposes the whole process."""
        text = self.metrics.render_text()
        registry = obs.metrics()
        if registry is not None:
            text += registry.render_text()
        return text

    def slo_snapshot(self) -> dict:
        """The ``/slo`` body: sliding-window percentiles + error-budget
        burn, with the lifetime totals alongside."""
        out = self.metrics.slo.snapshot()
        out["lifetime"] = {
            "rows_total": self.metrics.rows_total,
            "shed_total": self.metrics.shed_total,
            "deadline_exceeded_total":
                self.metrics.deadline_exceeded_total,
            "flush_errors_total": self.metrics.flush_errors_total,
            "queue_depth_peak": self.metrics.queue_depth.peak,
        }
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.batcher.close()
        self.emitter.emit(ScoringFinish(
            source="serving", num_rows=self.metrics.rows_total,
            wall_seconds=self.metrics.uptime_seconds()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _request_spans(tr, flush_span, tid, traced, stages) -> None:
    """One flush's requests as ``serving.request`` spans, parented into
    the flush's span, each with its four stage spans laid end to end
    (they sum to it). Each entry's own (epoch, monotonic) pair anchors
    its stage boundaries on the cross-thread trace axis."""
    assemble_s, device_s, respond_s = stages
    for t0_epoch_ns, request_id, wait_s, total_s in traced:
        sid = tr.record_complete(
            "serving.request", cat="serving", t0_epoch_ns=t0_epoch_ns,
            dur_s=total_s, parent=flush_span, tid=tid, crosses_queue=True,
            request_id=request_id)
        offset_s = 0.0
        for name, dur in (("serving.queue_wait", wait_s),
                          ("serving.assemble", assemble_s),
                          ("serving.device_score", device_s),
                          ("serving.respond", respond_s)):
            tr.record_complete(name, cat="serving",
                               t0_epoch_ns=t0_epoch_ns
                               + int(offset_s * 1e9),
                               dur_s=dur, parent=sid, tid=tid)
            offset_s += dur


# -- JSON-over-HTTP front end ----------------------------------------------

def _parse_request(obj: dict) -> ScoringRequest:
    return ScoringRequest(
        features=obj.get("features") or {},
        entity_ids=obj.get("entity_ids") or {},
        offset=float(obj.get("offset", 0.0)),
        uid=obj.get("uid"),
    )


class _ServingHandler(BaseHTTPRequestHandler):
    """Minimal stdlib handler: POST /score, GET /metrics, GET /slo,
    GET /healthz.

    Each POSTed request is submitted through the micro-batcher, so
    concurrent HTTP callers coalesce into shared device batches. A
    ``"trace": true`` key in the /score body returns each request's
    latency attribution with the scores.
    """

    service: ScoringService = None  # set by make_http_server
    result_timeout = 60.0

    def _respond(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload: dict) -> None:
        self._respond(code, json.dumps(payload).encode(),
                      "application/json")

    def do_GET(self):
        if self.path == "/metrics":
            self._respond(200, self.service.metrics_text().encode(),
                          "text/plain; version=0.0.4")
        elif self.path == "/slo":
            self._json(200, self.service.slo_snapshot())
        elif self.path == "/healthz":
            self._json(200, {"status": "ok",
                             "model_version": self.service.model_version,
                             "generation": None})
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _error(self, code: int, message: str, **extra) -> None:
        """One JSON error body + one metrics increment: every failure
        leaves through here, never as an exception on the handler
        thread."""
        self.service.metrics.record_http_error(code)
        body = {"error": message}
        body.update({k: v for k, v in extra.items() if v is not None})
        self._json(code, body)

    def do_POST(self):
        if self.path != "/score":
            self._error(404, f"unknown path {self.path}")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("request body must be a JSON object")
            reqs = [_parse_request(o) for o in payload.get("requests", [])]
            want_trace = bool(payload.get("trace", False))
        except (ValueError, TypeError, AttributeError, KeyError) as exc:
            # Malformed JSON / wrong shapes: the caller's fault — 400.
            logger.warning("malformed scoring request: %s", exc)
            self._error(400, f"malformed request: {exc}")
            return
        if not reqs:
            self._error(400, "no requests")
            return
        try:
            futures = [self.service.submit(r) for r in reqs]
        except BatcherQueueFull as exc:
            self._error(503, str(exc), queue_depth=exc.depth,
                        max_queue=exc.max_queue)
            return
        try:
            scores = [float(f.result(timeout=self.result_timeout))
                      for f in futures]
        except (DeadlineExceeded, TimeoutError, _FutureTimeout) as exc:
            self._error(504, f"scoring deadline exceeded: {exc}")
            return
        except Exception as exc:  # scoring/batcher error → 500 + count
            logger.exception("scoring request failed")
            self._error(500, f"scoring failed: {exc}")
            return
        body = {"scores": scores, "uids": [r.uid for r in reqs]}
        if want_trace:
            body["attribution"] = [getattr(f, "attribution", None)
                                   for f in futures]
        self._json(200, body)

    def log_message(self, fmt, *args):  # route access logs off stderr
        logger.debug("http: " + fmt, *args)


def make_http_server(service: ScoringService, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Bind (not yet serving — call ``serve_forever``). ``port=0`` picks a
    free port; the bound port is ``server.server_address[1]``."""
    handler = type("BoundServingHandler", (_ServingHandler,),
                   {"service": service})
    return ThreadingHTTPServer((host, port), handler)
