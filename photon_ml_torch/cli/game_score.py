"""GAME scoring driver.

Port of ``photon_ml_tpu/cli/game_score.py``. Reference parity:
photon-client ``cli/game/scoring/GameScoringDriver.scala`` — load a
GameModel, score a dataset, write scoring results (uid, score +
label/offset/weight passthrough), optionally evaluate. Scores on the CUDA
card unless ``--device cpu`` is given; ``--batch-rows`` streams the rows
through the host→device prefetch pipeline (``data/prefetch.py``).

Usage:
    python -m photon_ml_torch.cli.game_score \\
        --data DATASET_DIR --model-dir TRAIN_OUT/best \\
        --output-dir SCORES [--evaluators AUC] [--batch-rows 262144]

The Avro input, model and output options are not ported: they raise at
argument time, naming the slice of the port that brings them.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np

from photon_ml_torch import not_ported
from photon_ml_torch.api.transformer import GameTransformer
from photon_ml_torch.data.io import load_game_dataset
from photon_ml_torch.device import resolve_device
from photon_ml_torch.models import io as model_io
from photon_ml_torch.utils.events import (ScoringFinish, ScoringStart,
                                          default_emitter)
from photon_ml_torch.utils.logging import setup_logging

logger = logging.getLogger("photon_ml_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="GameDataset directory")
    p.add_argument("--model-dir", required=True, help="GameModel directory")
    p.add_argument("--avro-feature-shard", action="append", default=[],
                   help="Avro-input shard spec: not ported (slice 9)")
    p.add_argument("--avro-re-types", default="",
                   help="random-effect id keys of Avro input: not ported "
                        "(slice 9)")
    p.add_argument("--feature-index-dir",
                   help="the training run's index maps for Avro input: "
                        "not ported (slice 9)")
    p.add_argument("--ingest",
                   help="parallel Avro ingestion knobs: not ported "
                        "(slice 9)")
    p.add_argument("--model-format", default="NPZ",
                   choices=["NPZ", "AVRO"],
                   help="AVRO (the BayesianLinearModelAvro layout): not "
                        "ported (slice 10)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--evaluators", default="",
                   help="optional comma-separated evaluators")
    p.add_argument("--batch-rows", type=int, default=None,
                   help="score in bounded device batches of this many rows "
                        "through the host->device prefetch pipeline "
                        "(inputs larger than device memory; the same "
                        "scores)")
    p.add_argument("--as-mean", action="store_true",
                   help="apply the inverse link (probabilities/rates)")
    p.add_argument("--output-format", default="NPZ",
                   choices=["NPZ", "AVRO", "BOTH"],
                   help="AVRO and BOTH (the ScoringResultAvro container): "
                        "not ported (slice 9)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model and the scoring live; cuda raises "
                        "when no card is available")
    return p


def check_ported(args) -> None:
    """Raise for an option the port does not have, before any data is
    read."""
    for flag, value in (
            ("--avro-feature-shard", args.avro_feature_shard),
            ("--avro-re-types", args.avro_re_types),
            ("--feature-index-dir", args.feature_index_dir),
            ("--ingest", args.ingest)):
        if value:
            raise not_ported(f"{flag} (Avro scoring input)", 9)
    if args.model_format == "AVRO":
        raise not_ported("--model-format AVRO (avro/model_io.py)", 10)
    if args.output_format != "NPZ":
        raise not_ported(
            f"--output-format {args.output_format} (the Avro scoring "
            f"output)", 9)


def run(args) -> dict:
    setup_logging()
    check_ported(args)
    device = resolve_device(args.device)
    t0 = time.perf_counter()  # duration base — wall time only for stamps
    data = load_game_dataset(args.data)
    model = model_io.load_game_model(args.model_dir, device=device)
    evaluators = [e for e in args.evaluators.split(",") if e]
    transformer = GameTransformer(model, evaluators)
    logger.info("scoring %d rows on %s%s", data.num_rows, device,
                f" in batches of {args.batch_rows}" if args.batch_rows
                else "")

    os.makedirs(args.output_dir, exist_ok=True)
    default_emitter.emit(ScoringStart(source="game_score",
                                      num_rows=data.num_rows))
    summary = {"num_rows": data.num_rows}
    try:
        if evaluators:
            result, evaluation = transformer.transform_and_evaluate(
                data, as_mean=args.as_mean, batch_rows=args.batch_rows)
            summary["metrics"] = evaluation.metrics
        else:
            result = (transformer.transform_batched(
                          data, args.batch_rows, as_mean=args.as_mean)
                      if args.batch_rows
                      else transformer.transform(data, as_mean=args.as_mean))
        np.savez_compressed(
            os.path.join(args.output_dir, "scores.npz"),
            uid=result.uids, score=result.scores, label=result.labels,
            offset=result.offsets, weight=result.weights)
    finally:
        # Balanced lifecycle: listeners tracking open scoring scopes must
        # see the Finish even when the run raises mid-write.
        summary["wall_seconds"] = time.perf_counter() - t0
        default_emitter.emit(ScoringFinish(
            source="game_score", num_rows=data.num_rows,
            wall_seconds=summary["wall_seconds"]))
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("wrote %s", args.output_dir)
    return summary


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
