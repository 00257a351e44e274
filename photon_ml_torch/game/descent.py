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

Not ported yet: checkpoints and resume, gated sweeps, the run ledger and
the event emitters.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from photon_ml_torch.game.models import CoordinateModel, GameModel
from photon_ml_torch.types import TaskType

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
    """
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

    models: dict[str, CoordinateModel] = {}
    scores: dict[str, torch.Tensor] = {}
    base = torch.as_tensor(some.dataset.offsets, dtype=torch.float32,
                           device=device)
    total = torch.zeros((n,), dtype=torch.float32, device=device)
    for cid in seq:
        coord = coordinates[cid]
        if initial_models and cid in initial_models:
            models[cid] = initial_models[cid]
        else:
            models[cid] = coord.initial_model()
        s = coord.score(models[cid])
        scores[cid] = s
        total = total + s

    history = CoordinateDescentHistory()
    for it in range(config.iterations):
        for cid in seq:
            if cid in locked:
                continue
            coord = coordinates[cid]
            t0 = time.monotonic()
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
    return GameModel(task=task, models=models), history
