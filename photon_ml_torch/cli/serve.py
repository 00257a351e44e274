"""Online scoring service command line.

Port of ``photon_ml_tpu/cli/serve.py``. Loads a GameModel directory (the
npz layout) once, keeps it resident (photon_ml_torch/serving/), and
answers JSON-over-HTTP scoring requests with micro-batching and a metrics
endpoint. Runs on the CUDA card unless ``--device cpu`` is given.

    python -m photon_ml_torch.cli.serve --model-dir out/best --port 8080
    curl -s localhost:8080/score -d '{"requests": [{"features": \
        {"global": [0.1, ...]}, "entity_ids": {"userId": 7}}]}'
    curl -s localhost:8080/metrics
"""

from __future__ import annotations

import argparse
import json
import logging
import time

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


def create_server(args):
    """Build the resident service + bound HTTP server (not yet serving).

    Split from ``main`` so tests and embedding callers can drive the
    server loop themselves; returns (server, service)."""
    t0 = time.perf_counter()
    model, vocabs = load_model(args)
    t_load = time.perf_counter() - t0
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
    logger.info("boot: load %.3fs, service %.3fs on %s", t_load,
                time.perf_counter() - t0 - t_load, service.device)
    return make_http_server(service, host=args.host, port=args.port), service


def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
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


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
