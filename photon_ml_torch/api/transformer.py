"""GameTransformer: the scoring front door.

Port of ``photon_ml_tpu/api/transformer.py``. Reference parity:
photon-api ``transformers/GameTransformer.scala`` — GameModel + data →
scores, with optional evaluation (``transform(data) → scores``).

Scoring runs on the device the model's tensors live on (``cuda`` unless
the model was loaded onto the CPU). ``transform`` copies the dataset
there at once; ``transform_batched`` streams it in bounded row chunks
through ``data/prefetch.py``'s copy stream. Each scored batch emits a
``ScoringBatch`` (``source="game_score"``), which the obs bridge counts
into ``photon_scoring_rows_total``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset
from photon_ml_torch.evaluation import evaluators as ev
from photon_ml_torch.game.models import GameModel
from photon_ml_torch.ops import losses as losses_mod
from photon_ml_torch.utils.events import ScoringBatch, default_emitter


@dataclasses.dataclass
class ScoringResult:
    """Scores (+ passthrough fields) for output writing.

    Reference parity: ScoringResultAvro (uid, score, label/offset/weight
    passthrough).
    """

    scores: np.ndarray
    uids: np.ndarray
    labels: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None


def model_device(model: GameModel) -> torch.device:
    """The device a GameModel's coefficient tensors live on."""
    for m in model.models.values():
        means = getattr(m, "coefficients", m).means
        return means.device
    return torch.device("cpu")


class GameTransformer:
    """Score datasets with a trained GameModel."""

    def __init__(self, model: GameModel,
                 evaluators: Optional[list[str]] = None):
        self.model = model
        self.evaluators = evaluators or []
        self.device = model_device(model)

    def _result(self, scores: torch.Tensor, data: GameDataset,
                as_mean: bool) -> ScoringResult:
        if as_mean:
            scores = losses_mod.loss_for_task(self.model.task).mean(scores)
        return ScoringResult(
            scores=scores.cpu().numpy(),
            uids=np.arange(data.num_rows, dtype=np.int64),
            labels=data.response,
            offsets=data.offsets,
            weights=data.weights,
        )

    def _score(self, data: GameDataset) -> torch.Tensor:
        t0 = time.perf_counter()
        scores = self.model.score(data)
        # seconds is dispatch time, not device time: scoring is
        # asynchronous on a card.
        default_emitter.emit(ScoringBatch(
            source="game_score", rows=data.num_rows,
            padded_rows=data.num_rows, seconds=time.perf_counter() - t0))
        return scores

    def _score_batched(self, data: GameDataset, batch_rows: int,
                       prefetch_depth: int) -> torch.Tensor:
        from photon_ml_torch.data.prefetch import (device_prefetch,
                                                   iter_row_chunks)

        parts = [self._score(staged) for staged in device_prefetch(
            iter_row_chunks(data, batch_rows), depth=prefetch_depth,
            device=self.device)]
        return (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.float32, device=self.device))

    def transform(self, data: GameDataset,
                  as_mean: bool = False) -> ScoringResult:
        return self._result(self._score(data), data, as_mean)

    def transform_batched(self, data: GameDataset, batch_rows: int,
                          as_mean: bool = False,
                          prefetch_depth: int = 2) -> ScoringResult:
        """Score in bounded device batches with host→device prefetch.

        Only ``prefetch_depth`` row chunks are in flight beside the one
        being scored, and the next chunks' copies overlap the current
        chunk's scoring: large inputs score with flat device memory.
        Results are ``transform``'s (same scores, order, passthrough
        fields).
        """
        return self._result(
            self._score_batched(data, batch_rows, prefetch_depth), data,
            as_mean)

    def transform_and_evaluate(self, data: GameDataset, as_mean: bool = False,
                               batch_rows: Optional[int] = None
                               ) -> tuple[ScoringResult, ev.EvaluationResults]:
        """Score + evaluate. Metrics are always computed on raw linear
        scores (AUC is link-invariant; the loss evaluators expect margins);
        the returned ScoringResult honors ``as_mean``. ``batch_rows``
        scores through the bounded-memory prefetch pipeline."""
        if not self.evaluators:
            raise ValueError("no evaluators configured")
        scores = (self._score_batched(data, batch_rows, 2) if batch_rows
                  else self._score(data))
        evaluation = ev.evaluation_suite(
            self.evaluators, scores, data.response, data.weights,
            group_ids_by_column=dict(data.entity_ids),
            num_groups_by_column=dict(data.num_entities))
        return self._result(scores, data, as_mean), evaluation
