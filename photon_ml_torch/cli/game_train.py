"""GAME training driver.

Port of ``photon_ml_tpu/cli/game_train.py`` on one device. Reference
parity: photon-client ``cli/game/training/GameTrainingDriver.scala`` +
``cli/game/GameDriver.scala`` — parse params, read train/validation
data, run GameEstimator.fit over the regularization grid, select the best
model by the primary validation evaluator, write model + summary. Supports
warm start (``--model-input-dir``) and partial retraining
(``--locked-coordinates``). Runs on the CUDA card unless ``--device cpu``
is given (the reference builds a device mesh here; the port has one
device until slice 9).

Coordinate specs use the same mini-DSL style as the reference's config
strings, e.g.:

    --coordinate "name=fixed,type=fixed,shard=global"
    --coordinate "name=per-user,type=random,shard=re_userId,re=userId,min_samples=2"
    --opt-config "fixed:optimizer=LBFGS,reg=L2,reg_weight=1.0"

Options of the reference that the port does not have yet raise
``NotImplementedError`` at argument time, before any data is read,
naming the slice of the port that brings them: hyperparameter tuning,
``--distributed``, ``--fabric``, Avro input, ``--date-range`` and the
ingest options (slice 9); ``--model-output-format AVRO|BOTH`` and
``--fault-plan`` (slice 10); ``--sweep``, ``type=factored`` and
``projector=RANDOM`` (slice 8). The projected and subspace random effect
(``projector=INDEX_MAP``, ``subspace=``, ``features_to_samples_ratio=``)
and its staging pipeline (``--staging``, ``--staging-cache-dir``) are
ported. The reference's persistent XLA compilation cache has no
counterpart in torch and is left out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import time

from photon_ml_torch import not_ported, obs
from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                         FixedEffectDataConfiguration,
                                         RandomEffectDataConfiguration,
                                         parse_kv, parse_optimizer_config,
                                         parse_staging_config,
                                         parse_streaming_config)
from photon_ml_torch.api.estimator import GameEstimator
from photon_ml_torch.data.io import load_game_dataset
from photon_ml_torch.data.validators import (DataValidationLevel,
                                             validate_game_dataset)
from photon_ml_torch.device import resolve_device
from photon_ml_torch.models import io as model_io
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils.logging import profile_trace, setup_logging

logger = logging.getLogger("photon_ml_torch.cli")


def parse_coordinate(spec: str) -> tuple[str, dict]:
    kv = parse_kv(spec)
    if "name" not in kv or "type" not in kv or "shard" not in kv:
        raise ValueError(f"coordinate spec needs name/type/shard: {spec!r}")
    return kv.pop("name"), kv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", required=True,
                   help="training data: a GameDataset directory "
                        "(data/io.py format) or a LIBSVM text FILE "
                        "(loaded as one sparse 'global' shard — the "
                        "Criteo-style fixed-effect-only configuration)")
    p.add_argument("--validation")
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.value for t in TaskType])
    p.add_argument("--coordinate", action="append", required=True,
                   help="coordinate spec (repeatable): name=,type=fixed|"
                        "random,shard=[,re=,min_samples=,max_samples=,"
                        "projector=NONE|INDEX_MAP,"
                        "features_to_samples_ratio=,"
                        "subspace=auto|true|false (keep the trained "
                        "random-effect model in per-entity subspace form),"
                        "hybrid=auto|true|false,dtype=float32|bfloat16]")
    p.add_argument("--opt-config", action="append", default=[],
                   help="'<coordinate>:<optimizer mini-DSL>' (repeatable)")
    p.add_argument("--update-sequence", required=True,
                   help="comma-separated coordinate order")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--evaluators", default="",
                   help="comma-separated, first is primary "
                        "(e.g. AUC,AUC@userId)")
    p.add_argument("--reg-weight-grid", default=[],
                   help="'<coordinate>:w1,w2,...' (repeatable)",
                   action="append")
    p.add_argument("--model-input-dir", help="warm-start GameModel directory")
    p.add_argument("--locked-coordinates", default="",
                   help="comma-separated coordinates to keep fixed")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--output-mode", default="BEST", choices=["BEST", "ALL"])
    p.add_argument("--checkpoint", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="checkpoint descent progress under "
                        "<output-dir>/checkpoints after every coordinate "
                        "update (--no-checkpoint disables)")
    p.add_argument("--resume", action="store_true",
                   help="resume from an existing checkpoint directory "
                        "instead of starting fresh")
    p.add_argument("--tuning", default="NONE",
                   choices=["NONE", "RANDOM", "BAYESIAN"],
                   help="hyperparameter tuning: RANDOM and BAYESIAN are "
                        "not ported (slice 9)")
    p.add_argument("--tuning-iters", type=int, default=10,
                   help="number of tuning trials")
    p.add_argument("--tuning-range", default="1e-4:1e4",
                   help="lo:hi regularization-weight search range "
                        "(log scale)")
    p.add_argument("--profile-dir",
                   help="capture a torch.profiler trace of the fit into "
                        "this directory (Perfetto viewable)")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.value for v in DataValidationLevel],
                   help="input sanity checks (reference DataValidators: "
                        "task-valid labels, finite features/offsets, "
                        "non-negative weights)")
    p.add_argument("--avro-feature-shard", action="append", default=[],
                   help="Avro-input shard spec: not ported (slice 9)")
    p.add_argument("--avro-re-types", default="",
                   help="random-effect id keys of Avro input: not ported "
                        "(slice 9)")
    p.add_argument("--feature-index-dir",
                   help="saved index maps for Avro input: not ported "
                        "(slice 9)")
    p.add_argument("--date-range",
                   help="daily partitions of an Avro input: not ported "
                        "(slice 9)")
    p.add_argument("--model-output-format", default="NPZ",
                   choices=["NPZ", "AVRO", "BOTH"],
                   help="AVRO and BOTH (the BayesianLinearModelAvro "
                        "layout): not ported (slice 10)")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-host world: not ported (slice 9)")
    p.add_argument("--fabric", action="store_true",
                   help="the host-level fabric for streamed fits: not "
                        "ported (slice 9)")
    p.add_argument("--staging-cache-dir",
                   help="persist projected random-effect staging artifacts "
                        "here, keyed by dataset content digest — a re-run "
                        "on the same data memory-maps the staged blocks "
                        "(shard-granular: a killed run resumes with "
                        "partial credit) instead of re-paying the "
                        "projection pass")
    p.add_argument("--staging",
                   help="parallel staging pipeline knobs, "
                        "'workers=8,mode=thread|process,depth=10,"
                        "shard_entities=65536,retries=2,backoff=0.05,"
                        "straggler=30'; default: one worker per host "
                        "core, thread mode, depth=workers+2")
    p.add_argument("--ingest",
                   help="parallel Avro ingestion knobs: not ported "
                        "(slice 9)")
    p.add_argument("--streaming", nargs="?", const="",
                   help="route sparse fixed-effect coordinates onto the "
                        "row-streamed path (docs/STREAMING.md): the shard "
                        "stages into host-resident chunks, and every "
                        "L-BFGS value/gradient streams them through the "
                        "device — n bounded by host RAM, not device "
                        "memory; the fit checkpoints mid-optimization. "
                        "Optional mini-DSL 'chunk_rows=262144,num_hot=512,"
                        "dtype=float32|bfloat16|int8,depth=2,pin=0,"
                        "workers=8,solver=lbfgs' (bare --streaming takes "
                        "every default; dtype=int8 quarters the streamed "
                        "bytes)")
    p.add_argument("--sweep", nargs="?", const="",
                   help="dirty-gated incremental sweeps: not ported "
                        "(slice 8)")
    p.add_argument("--ingest-cache-dir",
                   help="the columnar Avro ingest cache: not ported "
                        "(slice 9)")
    p.add_argument("--fault-plan",
                   help="TESTING ONLY: a fault-injection plan: not ported "
                        "(slice 10)")
    p.add_argument("--trace-out",
                   help="write a Chrome trace-event JSON of this run "
                        "(photon-obs span tracing: lifecycle scopes, "
                        "streamed passes, chunk transfers, checkpoint "
                        "writes) — load in chrome://tracing or "
                        "ui.perfetto.dev, or render with `python -m "
                        "photon_ml_torch.cli.obs summarize`. Off by "
                        "default: the instrumentation then costs one "
                        "None check per site")
    p.add_argument("--metrics-dump",
                   help="write the cross-stack metrics registry "
                        "(transfer bytes/seconds, peak in-flight chunks, "
                        "retry/recovery counters) as Prometheus text at "
                        "exit")
    p.add_argument("--ledger-dir", default=None,
                   help="run-ledger directory: manifest + append-as-"
                        "produced per-iteration convergence telemetry. "
                        "Default: <output-dir>/ledger; pass '' to "
                        "disable. A fresh run replaces a stale ledger; "
                        "--resume validates run identity and APPENDS. "
                        "Inspect with `python -m photon_ml_torch.cli.obs "
                        "tail/diff/verify`")
    p.add_argument("--watchdog", nargs="?", const="",
                   help="arm the convergence watchdogs "
                        "(obs/watchdog.py): 'nan=raise|warn|stop|off,"
                        "stall=K[:action],divergence=F[:action],"
                        "slow_iter=F[:action]'. Bare --watchdog arms "
                        "the NaN detector (raise). Off by default")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the data and the solves live; cuda raises "
                        "when no card is available")
    return p


def check_ported(args) -> None:
    """Raise for an option the port does not have, before any data is
    read (a fit may follow an hours-long load)."""
    if args.tuning != "NONE":
        raise not_ported(f"--tuning {args.tuning} (hyperparameter/)", 9)
    for flag, value, what, slice_no in (
            ("--distributed", args.distributed, "multi-host training", 9),
            ("--fabric", args.fabric, "the multi-host fabric", 9),
            ("--avro-feature-shard", args.avro_feature_shard,
             "Avro input", 9),
            ("--avro-re-types", args.avro_re_types, "Avro input", 9),
            ("--feature-index-dir", args.feature_index_dir,
             "Avro input", 9),
            ("--date-range", args.date_range, "Avro daily partitions", 9),
            ("--ingest", args.ingest, "parallel Avro ingestion", 9),
            ("--ingest-cache-dir", args.ingest_cache_dir,
             "the Avro ingest cache", 9),
            ("--fault-plan", args.fault_plan, "fault injection", 10),
            ("--sweep", args.sweep is not None,
             "dirty-gated incremental sweeps", 8)):
        if value:
            raise not_ported(f"{flag} ({what})", slice_no)
    if args.model_output_format != "NPZ":
        raise not_ported(
            f"--model-output-format {args.model_output_format} "
            f"(avro/model_io.py)", 10)
    for spec in args.coordinate:
        name, kv = parse_coordinate(spec)
        if kv["type"] == "factored":
            raise not_ported(f"coordinate {name!r}: type=factored", 8)
        if kv.get("projector", "NONE").upper() == "RANDOM":
            raise not_ported(f"coordinate {name!r}: projector=RANDOM", 8)
        if kv.get("feature_sharded", "false").lower() == "true":
            raise not_ported(f"coordinate {name!r}: feature_sharded=true",
                             9)


def _arm_observability(args, stack, est) -> None:
    """Install the run ledger + convergence watchdogs for the span of
    the fit (docs/OBSERVABILITY.md "The run ledger").

    The ledger defaults ON (``<output-dir>/ledger``; ``--ledger-dir ''``
    disables): every ``game_train`` run leaves its convergence curve on
    disk. A fresh run replaces a stale ledger (exactly the checkpoint
    cleanup discipline); ``--resume`` appends after descent validates
    run identity against the checkpoint fingerprint. close() runs via the
    stack so a crashed fit keeps its curve prefix.
    """
    spec = args.watchdog
    if spec is not None:
        prev_wd = obs.set_watchdog(obs.parse_watchdog_config(spec))
        stack.callback(obs.set_watchdog, prev_wd)
    ledger_dir = args.ledger_dir
    if ledger_dir is None:
        ledger_dir = os.path.join(args.output_dir, "ledger")
    if not ledger_dir:
        return
    if not args.resume and os.path.exists(ledger_dir):
        logger.info("fresh run: removing stale run ledger at %s",
                    ledger_dir)
        shutil.rmtree(ledger_dir)
    led = obs.RunLedger.resume(ledger_dir, manifest=est.ledger_manifest())
    prev_led = obs.set_ledger(led)

    def _close(exc_type, exc, tb):
        led.close(status="ok" if exc_type is None else "error")
        obs.set_ledger(prev_led)
        return False

    stack.push(_close)


def _load_dataset(path: str, num_features=None):
    """GameDataset directory, or a LIBSVM file → sparse 'global' shard."""
    if os.path.isdir(path):
        return load_game_dataset(path)
    from photon_ml_torch.data.game_data import from_sparse_batch
    from photon_ml_torch.data.libsvm import read_libsvm
    from photon_ml_torch.data.sparse import from_libsvm

    data = read_libsvm(path, dense=False, num_features=num_features)
    return from_sparse_batch(from_libsvm(data))


def run(args) -> dict:
    """Driver entry: observability bracket around the real run (the
    trace/metrics dumps happen in a ``finally`` so a crashed fit still
    leaves its timeline on disk — the crash is exactly when you want
    it)."""
    trace_out = args.trace_out
    metrics_dump = args.metrics_dump
    if not (trace_out or metrics_dump):
        return _run(args)
    obs.enable(trace=bool(trace_out), metrics=True,
               spill=(trace_out + ".spill") if trace_out else None)
    try:
        with obs.span("game_train", cat="driver"):
            return _run(args)
    finally:
        if trace_out:
            obs.dump_trace(trace_out)
            logger.info("wrote trace %s (chrome://tracing, "
                        "ui.perfetto.dev, or `python -m "
                        "photon_ml_torch.cli.obs summarize`)", trace_out)
        if metrics_dump:
            obs.dump_metrics(metrics_dump)
            logger.info("wrote metrics %s", metrics_dump)
        obs.disable()


def _coordinate_data(kv: dict):
    if kv["type"] == "fixed":
        hybrid_kv = kv.get("hybrid", "auto").lower()
        if hybrid_kv not in ("auto", "true", "false"):
            raise ValueError(f"hybrid= must be auto, true, or false "
                             f"(got {hybrid_kv!r})")
        return FixedEffectDataConfiguration(
            kv["shard"],
            feature_dtype=kv.get("dtype", "float32"),
            hybrid=None if hybrid_kv == "auto" else hybrid_kv == "true")
    if kv["type"] == "random":
        sub_kv = kv.get("subspace", "auto").lower()
        if sub_kv not in ("auto", "true", "false"):
            raise ValueError(f"subspace= must be auto, true, or false "
                             f"(got {sub_kv!r})")
        return RandomEffectDataConfiguration(
            random_effect_type=kv["re"],
            feature_shard_id=kv["shard"],
            active_data_lower_bound=int(kv.get("min_samples", 1)),
            active_data_upper_bound=(int(kv["max_samples"])
                                     if "max_samples" in kv else None),
            projector=kv.get("projector", "NONE").upper(),
            projected_dimension=(int(kv["projected_dim"])
                                 if "projected_dim" in kv else None),
            features_to_samples_ratio=(
                float(kv["features_to_samples_ratio"])
                if "features_to_samples_ratio" in kv else None),
            subspace_model=None if sub_kv == "auto" else sub_kv == "true",
            feature_dtype=kv.get("dtype", "float32"))
    raise ValueError(f"unknown coordinate type {kv['type']!r}")


def _run(args) -> dict:
    setup_logging()
    check_ported(args)
    device = resolve_device(args.device)
    t0 = time.perf_counter()  # duration base
    task = TaskType(args.task)
    train = _load_dataset(args.train)
    validation = None
    if args.validation:
        nf = None
        if not os.path.isdir(args.validation):
            # LIBSVM validation must share the training feature space —
            # whatever form training was loaded from.
            if "global" not in train.feature_shards:
                raise ValueError(
                    "LIBSVM validation requires a 'global' feature "
                    "shard in the training data")
            nf = train.shard_dim("global")
        validation = _load_dataset(args.validation, num_features=nf)
    vlevel = DataValidationLevel(args.data_validation)
    validate_game_dataset(task, train, level=vlevel)
    if validation is not None:
        validate_game_dataset(task, validation, level=vlevel)

    opt_by_coord: dict[str, GLMOptimizationConfiguration] = {}
    for spec in args.opt_config:
        cid, _, dsl = spec.partition(":")
        opt_by_coord[cid.strip()] = parse_optimizer_config(dsl)

    grid_by_coord: dict[str, tuple[float, ...]] = {}
    for spec in args.reg_weight_grid:
        if not spec:
            continue
        cid, _, ws = spec.partition(":")
        grid_by_coord[cid.strip()] = tuple(
            float(w) for w in ws.split(",") if w)

    locked = {c for c in args.locked_coordinates.split(",") if c}
    coordinates: dict[str, CoordinateConfiguration] = {}
    for spec in args.coordinate:
        name, kv = parse_coordinate(spec)
        data = _coordinate_data(kv)
        opt = opt_by_coord.get(name, GLMOptimizationConfiguration())
        grid = grid_by_coord.get(name, ())
        if grid and opt.regularization.reg_type.value == "NONE":
            # A reg-weight grid over a NONE-regularized coordinate
            # silently fits the identical model at every point.
            raise ValueError(
                f"coordinate {name!r} has regularization NONE; "
                f"--reg-weight-grid/--tuning need an --opt-config with "
                f"reg=L1|L2|ELASTIC_NET for it")
        coordinates[name] = CoordinateConfiguration(
            data=data, optimization=opt, reg_weight_grid=grid)

    evaluators = [e for e in args.evaluators.split(",") if e]
    est = GameEstimator(
        task=task,
        coordinates=coordinates,
        update_sequence=[c for c in args.update_sequence.split(",") if c],
        device=device,
        descent_iterations=args.iterations,
        validation_evaluators=evaluators,
        staging_cache_dir=args.staging_cache_dir,
        staging=(parse_staging_config(args.staging)
                 if args.staging else None),
        streaming=(parse_streaming_config(args.streaming)
                   if args.streaming is not None else None))

    initial_models = None
    if args.model_input_dir:
        initial_models = dict(model_io.load_game_model(
            args.model_input_dir, device=device).models)

    if args.resume and not args.checkpoint:
        raise ValueError("--resume requires checkpointing; "
                         "drop --no-checkpoint")
    checkpoint_dir = None
    if args.checkpoint:
        checkpoint_dir = os.path.join(args.output_dir, "checkpoints")
        if not args.resume and os.path.exists(checkpoint_dir):
            # Fresh run: stale checkpoints must not silently short-circuit
            # training (resume is an explicit opt-in).
            logger.info("fresh run: removing stale checkpoints at %s",
                        checkpoint_dir)
            shutil.rmtree(checkpoint_dir)

    with contextlib.ExitStack() as obs_stack:
        _arm_observability(args, obs_stack, est)
        led = obs.ledger()
        ledger_info = (None if led is None else
                       {"dir": led.directory,
                        "run_id": led.manifest.get("run_id")})
        with profile_trace(args.profile_dir):
            results = est.fit(train, validation,
                              initial_models=initial_models,
                              locked_coordinates=locked or None,
                              checkpoint_dir=checkpoint_dir)

    best = est.select_best_model(results)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.output_mode == "ALL":
        for i, r in enumerate(results):
            model_io.save_game_model(
                r.model, os.path.join(args.output_dir, f"model-{i}"))
    model_io.save_game_model(best.model,
                             os.path.join(args.output_dir, "best"))
    summary = {
        "task": task.value,
        # Byte-level fingerprint of the selected model: two runs trained
        # the SAME model iff these agree.
        "model_digest": model_io.game_model_digest(best.model),
        "candidates": [
            {"configs": {
                c: {"reg_type": o.regularization.reg_type.value,
                    "reg_weight": o.regularization.reg_weight}
                for c, o in r.configs.items()},
             "metrics": r.evaluation.metrics if r.evaluation else None}
            for r in results],
        "best_metrics": (best.evaluation.metrics if best.evaluation else None),
        "tuning": None,
        # Provenance pointer: summary and convergence curve are the
        # same run (cli/obs tail/diff on this directory).
        "ledger": ledger_info,
        "wall_seconds": time.perf_counter() - t0,
    }
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("wrote %s", args.output_dir)
    return summary


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
