"""Block coordinate descent: the GAME training loop.

Port of ``photon_ml_tpu/game/descent.py``. Reference parity: photon-api
``algorithm/CoordinateDescent.scala``: for each iteration, for each
coordinate in the update sequence, subtract the coordinate's current
scores from the residual, train it against the remaining offsets, add its
new scores back; validate after each update; locked (pretrained)
coordinates are scored but never retrained.

Coordinates train sequentially (each depends on the others' residual);
the parallelism is inside each coordinate. Score bookkeeping is
elementwise adds on stable-order (n,) tensors, written as the reference
writes it: ``offsets = base + total − scores[cid]`` and ``total = total +
new − old``.

With a ``checkpoint_manager`` (``game/checkpoint.py``) the loop saves
models, progress and the (n,) residual total after every update and
resumes from a checkpoint it finds: the reference's restart, in its
on-disk format. With a run ledger active (``obs.ledger()``) the run's
identity is bound from the same fingerprint, every row an update's
optimizer records carries its coordinate, outer iteration and step, and
each update adds a ``coordinate_update`` row; with a tracer active each
update is a ``descent.update`` span. Not ported yet: gated sweeps
(slice 8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import hashlib
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_torch import not_ported, obs
from photon_ml_torch.game.models import CoordinateModel, GameModel
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils import events as ev_mod

logger = logging.getLogger("photon_ml_torch.game")


@dataclasses.dataclass
class CoordinateDescentConfig:
    """Update sequence and outer iterations (reference: GameTrainingDriver
    params ``coordinateUpdateSequence`` / ``coordinateDescentIterations``)."""

    update_sequence: list[str]
    iterations: int = 1


@dataclasses.dataclass
class CoordinateDescentHistory:
    """Per-(iteration, coordinate) timing and validation records."""

    records: list[dict] = dataclasses.field(default_factory=list)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(task: TaskType, coordinates: dict[str, object],
        config: CoordinateDescentConfig, *,
        initial_models: Optional[dict[str, CoordinateModel]] = None,
        locked_coordinates: Optional[set[str]] = None,
        validation_fn: Optional[Callable[[GameModel], dict]] = None,
        checkpoint_manager=None,
        sweep=None,
        ) -> tuple[GameModel, CoordinateDescentHistory]:
    """Run block coordinate descent (reference: CoordinateDescent.run).

    ``coordinates`` maps coordinate id → Fixed/RandomEffectCoordinate, all
    over one GameDataset's example order and on one device.
    ``initial_models`` are warm starts; ``locked_coordinates`` are scored
    but never retrained (reference partial retraining) and need one.
    ``validation_fn`` is called after each coordinate update with the
    current GameModel. Each record's ``train_seconds`` ends with the
    device synchronized, so it times the update's work, not its launch.
    A coordinate that describes its latest solve (``last_solve``, as the
    sparse fixed effect does) has it recorded under ``"solver"``.

    ``checkpoint_manager`` (game/checkpoint.py) persists models and
    progress after every coordinate update and, when a checkpoint written
    under the same fingerprint is found under its directory, resumes from
    it: completed (iteration, coordinate) updates are skipped, the
    checkpointed models replace the warm starts, and each coordinate's
    down-sampling generator is fast-forwarded past its completed updates.
    The saved (n,) residual total replaces the re-summed one when the two
    agree within accumulation noise, which makes a resumed run bit-exact
    with an uninterrupted one (a kill between the model and residual
    writes leaves a step-sized gap instead, and the re-sum, always
    consistent with the model files, is kept). A streamed coordinate
    also checkpoints inside its update (``bind_step_checkpoint``).

    ``sweep`` (dirty-gated sweeps) is slice 8 of the port and raises.
    """
    if sweep is not None:
        raise not_ported("sweep (dirty-gated incremental sweeps)", 8)
    seq = list(config.update_sequence)
    unknown = [c for c in seq if c not in coordinates]
    if unknown:
        raise ValueError(f"update sequence references unknown coordinates "
                         f"{unknown}")
    locked = set(locked_coordinates or ())
    for c in locked:
        if initial_models is None or c not in initial_models:
            raise ValueError(f"locked coordinate {c!r} needs an initial model")
    some = coordinates[seq[0]]
    device = some.device
    n = some.dataset.num_rows

    led = obs.ledger()
    fingerprint = None
    resume = None
    if checkpoint_manager is not None or led is not None:
        fingerprint = _fingerprint(task, coordinates, seq, config, locked, n)
    if led is not None:
        # Stamp (or validate, on a resumed append) the run ledger's
        # identity from the SAME fingerprint the checkpoint trusts: a
        # ledger never silently continues a different run's curve.
        led.bind_fingerprint(fingerprint)
    if checkpoint_manager is not None:
        resume = checkpoint_manager.load(expected_fingerprint=fingerprint,
                                         device=device)
    history = CoordinateDescentHistory()
    done_steps = 0
    if resume is not None:
        initial_models = {**(initial_models or {}), **resume.models}
        done_steps = resume.done_steps
        history.records = list(resume.records)
        logger.info("resuming coordinate descent from checkpoint: "
                    "%d updates already done", done_steps)
        if resume.complete:
            return (GameModel(task=task, models=dict(resume.models)),
                    history)
        # Fast-forward each coordinate's down-sampling generator past its
        # completed train calls, so the remaining steps draw the SAME
        # subsets an uninterrupted run would.
        completed: dict[str, int] = {}
        for rec in resume.records:
            completed[rec["coordinate"]] = \
                completed.get(rec["coordinate"], 0) + 1
        for cid, k in completed.items():
            advance = getattr(coordinates.get(cid), "advance_down_sampling",
                              None)
            if advance is not None:
                advance(k)

    models: dict[str, CoordinateModel] = {}
    scores: dict[str, torch.Tensor] = {}
    base = torch.as_tensor(some.dataset.offsets, dtype=torch.float32,
                           device=device)
    total = torch.zeros((n,), dtype=torch.float32, device=device)
    for cid in seq:
        coord = coordinates[cid]
        if initial_models and cid in initial_models:
            # A warm start of another random-effect layout (dense ↔
            # subspace) converts here, so scoring and training see the
            # coordinate's own model type.
            adapt = getattr(coord, "adapt_initial", None)
            models[cid] = (adapt(initial_models[cid]) if adapt
                           else initial_models[cid])
        else:
            models[cid] = coord.initial_model()
        s = coord.score(models[cid])
        scores[cid] = s
        total = total + s

    if resume is not None and resume.residual_total is not None:
        restored = np.asarray(resume.residual_total)
        # A benign mismatch against the fresh sum is float32
        # accumulation-order noise (~1e-6); a kill between the model and
        # residual writes leaves a step-sized gap instead.
        if restored.shape == tuple(total.shape) and np.allclose(
                total.cpu().numpy(), restored, rtol=1e-5, atol=1e-5):
            total = torch.from_numpy(restored).to(device)
        else:
            logger.warning(
                "checkpoint residuals disagree with re-summed scores; "
                "using the re-summed total (resume stays correct but is "
                "no longer bit-exact)")

    emitter = ev_mod.default_emitter
    emitter.emit(ev_mod.TrainingStart(
        task=TaskType(task).value, update_sequence=tuple(seq),
        iterations=config.iterations))
    step = 0
    try:
        for it in range(config.iterations):
            for cid in seq:
                if cid in locked:
                    continue
                step += 1
                if step <= done_steps:
                    continue  # already covered by the checkpoint
                coord = coordinates[cid]
                t0 = time.monotonic()
                # Ledger context: every row the update's optimizer
                # records (live opt_iter rows, post-fit spills, RE waves)
                # carries the coordinate and step it belongs to.
                bound = (led.bound(coordinate=cid, outer_iteration=it,
                                   step=step)
                         if led is not None else contextlib.nullcontext())
                # One span per coordinate update: the coordinate's own
                # spans (passes, fit waves) nest under it.
                with bound, obs.span("descent.update", cat="train",
                                     iteration=it, coordinate=cid,
                                     step=step):
                    if checkpoint_manager is not None:
                        # A streamed coordinate checkpoints inside its
                        # update too: a kill mid-L-BFGS resumes
                        # mid-optimization.
                        bind = getattr(coord, "bind_step_checkpoint",
                                       None)
                        if bind is not None:
                            bind(checkpoint_manager.stream_dir(step), step)
                    # Residual offsets: everything except this coordinate.
                    offsets = base + total - scores[cid]
                    model = coord.train_model(offsets, initial=models[cid])
                    new_scores = coord.score(model)
                    total = total + new_scores - scores[cid]
                    scores[cid] = new_scores
                    models[cid] = model
                    _synchronize(device)
                elapsed = time.monotonic() - t0
                rec = {"iteration": it, "coordinate": cid,
                       "train_seconds": elapsed}
                solve = getattr(coord, "last_solve", None)
                if solve is not None:
                    rec["solver"] = solve
                if validation_fn is not None:
                    rec["validation"] = validation_fn(
                        GameModel(task=task, models=dict(models)))
                logger.info("CD iter %d coordinate %s: %.2fs %s", it, cid,
                            elapsed, rec.get("validation", ""))
                history.records.append(rec)
                emitter.emit(ev_mod.CoordinateUpdate(
                    iteration=it, coordinate=cid, train_seconds=elapsed,
                    validation=rec.get("validation")))
                if led is not None:
                    led.record("coordinate_update", coordinate=cid,
                               outer_iteration=it, step=step,
                               seconds=round(elapsed, 6),
                               validation=rec.get("validation"))
                if checkpoint_manager is not None:
                    checkpoint_manager.save(
                        task, models, done_steps=step,
                        records=history.records, fingerprint=fingerprint,
                        updated=[cid], residual_total=total.cpu().numpy())
                    # The step committed: its mid-step stream state is
                    # stale (a later resume starts AFTER this step).
                    clear = getattr(coord, "clear_step_checkpoint", None)
                    if clear is not None:
                        clear()
    finally:
        # Balanced lifecycle: a raise mid-descent still closes the
        # training scope for listeners tracking it.
        emitter.emit(ev_mod.TrainingFinish(task=TaskType(task).value,
                                           total_updates=step))
    if checkpoint_manager is not None:
        checkpoint_manager.save(task, models, done_steps=step,
                                records=history.records, complete=True,
                                fingerprint=fingerprint,
                                residual_total=total.cpu().numpy())
    return GameModel(task=task, models=models), history


def _dataset_digest(ds) -> str:
    """Content digest of a GameDataset (responses, offsets, weights,
    feature shards, entity assignments): anything that changes the
    training objectives, byte for byte the reference's. Memoized on the
    dataset object, which is treated as immutable once fitted (a
    regularization grid would otherwise repeat a full pass over the
    data per grid point)."""
    cached = getattr(ds, "_content_digest", None)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    for arr in (ds.response, ds.offsets, ds.weights):
        _feed_array(h, arr)
    for sid in sorted(ds.feature_shards):
        shard = ds.feature_shards[sid]
        if hasattr(shard, "indices"):  # SparseShard
            _feed_array(h, shard.indices)
            _feed_array(h, shard.values)
        else:
            _feed_array(h, shard)
    for re_type in sorted(ds.entity_ids):
        _feed_array(h, ds.entity_ids[re_type])
    digest = h.hexdigest()
    try:
        ds._content_digest = digest
    except (AttributeError, TypeError):
        pass  # frozen/slotted datasets: just recompute next time
    return digest


def _feed_array(h, arr) -> None:
    """The one array-content hashing convention (None gets a marker so
    (None, x) never collides with (x, None)), shared by the dataset
    digest, the checkpoint fingerprint and normalization_digest. A
    tensor hashes as its host bytes; a contiguous array is hashed in
    place, with no copy."""
    if arr is None:
        h.update(b"\x00none")
        return
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))


def normalization_digest(ctx) -> str:
    """Content digest of a NormalizationContext: pairs with
    ``_dataset_digest`` as the estimator's coordinate-cache key."""
    h = hashlib.sha1()
    _feed_array(h, ctx.factors)
    _feed_array(h, ctx.shifts)
    h.update(repr(ctx.intercept_index).encode())
    return h.hexdigest()


def _jsonable(obj):
    """Dataclass/enum tree → plain JSON-comparable values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def _fingerprint(task, coordinates, seq, config, locked, n) -> dict:
    """What a checkpoint must agree on to be resumable: anything that
    changes the sequence of training steps or their objectives (the full
    per-coordinate optimization config, the loop shape, and a digest of
    the training data and normalization). The reference's dict, key for
    key, so a checkpoint of either package resumes in the other."""
    per_coord = {}
    for cid in seq:
        c = getattr(coordinates[cid], "config", None)
        per_coord[cid] = {
            "config": _jsonable(c) if c is not None else None,
            "down_sampling_seed": getattr(
                coordinates[cid], "_down_sampling_seed", None),
        }
    ds = coordinates[seq[0]].dataset
    h = hashlib.sha1()
    h.update(_dataset_digest(ds).encode())
    for cid in seq:
        norm = getattr(coordinates[cid], "norm", None)
        if norm is not None:
            _feed_array(h, getattr(norm, "factors", None))
            _feed_array(h, getattr(norm, "shifts", None))
    return {
        "task": TaskType(task).value,
        "sequence": list(seq),
        "iterations": int(config.iterations),
        "locked": sorted(locked),
        "num_rows": int(n),
        "data_digest": h.hexdigest(),
        "coordinates": per_coord,
    }
