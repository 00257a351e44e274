"""Online scoring service command line.

Port of ``photon_ml_tpu/cli/serve.py``. Loads a GameModel directory (the
npz layout) once, keeps it resident (photon_ml_torch/serving/), and
answers JSON-over-HTTP scoring requests with micro-batching and a metrics
endpoint. Runs on the CUDA card unless ``--device cpu`` is given.

    python -m photon_ml_torch.cli.serve --model-dir out/best --port 8080
    curl -s localhost:8080/score -d '{"requests": [{"features": \
        {"global": [0.1, ...]}, "entity_ids": {"userId": 7}}]}'
    curl -s localhost:8080/metrics

``--trace-out t.json`` records the session's spans (boot, flushes,
requests and their stages) and writes them at shutdown;
``--metrics-dump m.prom`` writes the whole ``/metrics`` text then. Both
are written from a ``finally``, so a crashed server keeps them. Render
the trace with ``python -m photon_ml_torch.cli.obs summarize --serving
t.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

from photon_ml_torch import obs
from photon_ml_torch.models import io as model_io
from photon_ml_torch.serving.service import ScoringService, make_http_server

logger = logging.getLogger("photon_ml_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", required=True,
                   help="GameModel directory (npz layout)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model's device tier and scoring run; "
                        "cuda raises when no card is available")
    p.add_argument("--entity-vocabs",
                   help="entity-vocabs.json mapping raw entity keys to "
                        "vocabulary rows; lets requests carry raw string "
                        "ids")
    p.add_argument("--as-mean", action="store_true",
                   help="serve probabilities/rates (inverse link) instead "
                        "of raw linear scores")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="micro-batch flush size (also the largest padded "
                        "batch shape)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="max time a queued request waits for batch-mates")
    p.add_argument("--cache-entities", type=int, default=4096,
                   help="per-coordinate LRU device cache capacity "
                        "(random-effect rows)")
    p.add_argument("--cache-dtype", default="float32",
                   choices=["float32", "int8"],
                   help="device-LRU storage dtype: int8 (symmetric "
                        "per-row quantisation, dequantised in the "
                        "scoring kernel) caches ~4x the entities per "
                        "device byte")
    p.add_argument("--store-shards", type=int, default=8,
                   help="hash shards of the host-resident random-effect "
                        "store")
    p.add_argument("--max-queue", type=int, default=None,
                   help="admission-control bound on queued requests "
                        "(default 16×max-batch); overflow sheds with "
                        "HTTP 503")
    p.add_argument("--request-deadline-s", type=float, default=30.0,
                   help="per-request deadline: a request still queued "
                        "past this fails fast with 504 (0 disables)")
    p.add_argument("--slo-window-s", type=float, default=60.0,
                   help="sliding window of the /slo tracker")
    p.add_argument("--slo-availability", type=float, default=0.999,
                   help="availability objective: shed/deadline/5xx "
                        "burn the 1-objective error budget")
    p.add_argument("--slo-latency-ms", type=float, default=None,
                   help="optional latency objective: answered requests "
                        "slower than this also burn error budget")
    p.add_argument("--trace-out",
                   help="write a Chrome trace-event JSON of the serving "
                        "session at shutdown (request spans with queue/"
                        "assemble/device/respond attribution children "
                        "parented into their flush spans) — written "
                        "from a finally, so a crashed server keeps its "
                        "timeline; render with `python -m "
                        "photon_ml_torch.cli.obs summarize --serving`")
    p.add_argument("--metrics-dump",
                   help="write the full /metrics exposition (serving "
                        "scoreboard + metrics registry) to this file at "
                        "shutdown, also from a finally")
    return p


def load_model(args):
    """Load (model, entity_vocabs). Tables load on the host: the store
    keeps random effects there and moves only its caches and the fixed
    effects to the device."""
    vocabs = None
    if args.entity_vocabs:
        with open(args.entity_vocabs) as f:
            vocabs = json.load(f)
    return model_io.load_game_model(args.model_dir, device="cpu"), vocabs


def _boot_phase_gauges(phases: dict[str, float]) -> None:
    """``photon_boot_seconds{phase=...}``: the boot as numbers, not a log
    line (one None check when metrics are off)."""
    mx = obs.metrics()
    if mx is None:
        return
    for phase, seconds in phases.items():
        mx.gauge("photon_boot_seconds", phase=phase).set(seconds)


def create_server(args):
    """Build the resident service + bound HTTP server (not yet serving).

    Split from ``main`` so tests and embedding callers can drive the
    server loop themselves; returns (server, service).

    With tracing on, construction is a ``serving.boot`` span with
    ``boot.map`` (model load) and ``boot.compile`` (service
    construction: the store, the device tiers, the kernels' first build
    where one is needed) children, recorded after the fact."""
    t_boot, e_boot = time.perf_counter(), time.time_ns()
    model, vocabs = load_model(args)
    t_load = time.perf_counter() - t_boot
    t0, e0 = time.perf_counter(), time.time_ns()
    service = ScoringService(
        model, device=args.device, as_mean=args.as_mean,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        cache_entities=args.cache_entities, cache_dtype=args.cache_dtype,
        store_shards=args.store_shards, entity_vocabs=vocabs,
        max_queue=args.max_queue,
        request_deadline_s=(args.request_deadline_s or None),
        slo_window_s=args.slo_window_s,
        slo_availability=args.slo_availability,
        slo_latency_ms=args.slo_latency_ms)
    t_service = time.perf_counter() - t0
    total = time.perf_counter() - t_boot
    tr = obs.tracer()
    if tr is not None:
        bid = tr.record_complete("serving.boot", cat="serving",
                                 t0_epoch_ns=e_boot, dur_s=total)
        tr.record_complete("boot.map", cat="serving", t0_epoch_ns=e_boot,
                           dur_s=t_load, parent=bid)
        tr.record_complete("boot.compile", cat="serving", t0_epoch_ns=e0,
                           dur_s=t_service, parent=bid)
    _boot_phase_gauges({"map": t_load, "compile": t_service,
                        "total": total})
    logger.info("boot: load %.3fs, service %.3fs on %s", t_load,
                t_service, service.device)
    return make_http_server(service, host=args.host, port=args.port), service


def _dump_observability(service, trace_out, metrics_dump) -> None:
    """Shutdown/crash dump path (runs in a ``finally``): a served session
    keeps its timeline and scoreboard even when the server dies."""
    if trace_out:
        obs.dump_trace(trace_out)
        logger.info("wrote trace %s (render with `python -m "
                    "photon_ml_torch.cli.obs summarize --serving`)",
                    trace_out)
    if metrics_dump:
        tmp = metrics_dump + ".tmp"
        with open(tmp, "w") as f:
            f.write(service.metrics_text())
        os.replace(tmp, metrics_dump)
        logger.info("wrote metrics %s", metrics_dump)


def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    trace_out, metrics_dump = args.trace_out, args.metrics_dump
    if trace_out or metrics_dump:
        # Metrics ride along with tracing (the request spans need the
        # tracer; the /metrics registry append needs the registry).
        obs.enable(trace=bool(trace_out), metrics=True)
    server, service = create_server(args)
    host, port = server.server_address[:2]
    logger.info("serving %s on http://%s:%d (POST /score, GET /metrics, "
                "GET /slo, GET /healthz)", args.model_dir, host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.server_close()
        service.close()
        if trace_out or metrics_dump:
            try:
                _dump_observability(service, trace_out, metrics_dump)
            finally:
                obs.disable()


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
