"""GameEstimator: the training front door.

Port of ``photon_ml_tpu/api/estimator.py`` on one device. Reference
parity: photon-api ``estimators/GameEstimator.scala`` — builds
per-coordinate datasets/coordinates from the input data, runs
``CoordinateDescent`` once per GameOptimizationConfiguration (the
regularization-weight grid), evaluates each candidate on validation data,
and exposes best-model selection (``fit(data, validationData, configs) →
Seq[(GameModel, EvaluationResults, config)]``).

It builds dense and sparse (ELL) fixed-effect coordinates and unprojected
random-effect coordinates on ``device`` (``cuda`` unless the caller
passes ``"cpu"``), where the reference takes a mesh. Not ported yet, each
raising and naming the slice that ports it: streamed fixed effects
(slice 5), checkpoints, span traces, the run ledger, convergence
watchdogs and the projected staging pipeline (slice 6), factored random
effects, ``projector=RANDOM`` and gated sweeps (slice 8), and Avro
ingestion (slice 9).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
from typing import Optional

import numpy as np
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                         FactoredRandomEffectDataConfiguration,
                                         FixedEffectDataConfiguration,
                                         RandomEffectDataConfiguration)
from photon_ml_torch.data.batch import check_feature_dtype
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.evaluation import evaluators as ev
from photon_ml_torch.game import descent
from photon_ml_torch.game.coordinates import (FixedEffectCoordinate,
                                              RandomEffectCoordinate,
                                              SparseFixedEffectCoordinate)
from photon_ml_torch.game.models import GameModel
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops import losses as losses_mod
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.types import TaskType

logger = logging.getLogger("photon_ml_torch.api")


@dataclasses.dataclass
class GameResult:
    """One grid point's fit. ``history`` is the coordinate descent's
    per-update record (timings, validation metrics, and each sparse
    fixed effect's solve under ``"solver"``)."""

    model: GameModel
    evaluation: Optional[ev.EvaluationResults]
    configs: dict[str, GLMOptimizationConfiguration]
    history: Optional[descent.CoordinateDescentHistory] = None


def _feed_array(h, arr) -> None:
    """Hash an array's bytes in place (no copy of a contiguous array);
    None gets a marker so (None, x) never collides with (x, None)."""
    if arr is None:
        h.update(b"\x00none")
        return
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))


def dataset_digest(ds: GameDataset) -> str:
    """Content digest of a GameDataset (responses, offsets, weights,
    feature shards, entity assignments): anything that changes the
    training objectives. Memoized on the dataset object, which is treated
    as immutable once fitted (the coordinate cache's contract)."""
    cached = getattr(ds, "_content_digest", None)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    for arr in (ds.response, ds.offsets, ds.weights):
        _feed_array(h, arr)
    for sid in sorted(ds.feature_shards):
        shard = ds.feature_shards[sid]
        if isinstance(shard, SparseShard):
            _feed_array(h, shard.indices)
            _feed_array(h, shard.values)
            h.update(str(shard.num_features).encode())
        else:
            _feed_array(h, shard)
    for re_type in sorted(ds.entity_ids):
        _feed_array(h, ds.entity_ids[re_type])
    digest = h.hexdigest()
    ds._content_digest = digest
    return digest


def normalization_digest(ctx: NormalizationContext) -> str:
    h = hashlib.sha1()
    _feed_array(h, ctx.factors)
    _feed_array(h, ctx.shifts)
    h.update(repr(ctx.intercept_index).encode())
    return h.hexdigest()


class GameEstimator:
    """Train GAME models on one device (reference: GameEstimator)."""

    def __init__(
        self,
        task: TaskType,
        coordinates: dict[str, CoordinateConfiguration],
        update_sequence: list[str],
        device: Optional[DeviceLike] = None,
        descent_iterations: int = 1,
        validation_evaluators: Optional[list[str]] = None,
        normalization: Optional[dict[str, NormalizationContext]] = None,
        compute_variances_at_end: bool = True,
        staging_cache_dir: Optional[str] = None,
        staging=None,
        ingest=None,
        streaming=None,
        sweep=None,
        trace=None,
        ledger_dir: Optional[str] = None,
        watchdog=None,
    ):
        for value, what, slice_no in (
                (streaming, "streaming (the row-streamed fixed effect)", 5),
                (staging, "staging (the projected staging pipeline)", 6),
                (staging_cache_dir, "staging_cache_dir (the staging cache)",
                 6),
                (trace, "trace (span tracing)", 6),
                (ledger_dir, "ledger_dir (the run ledger)", 6),
                (watchdog, "watchdog (convergence watchdogs)", 6),
                (sweep, "sweep (dirty-gated incremental sweeps)", 8),
                (ingest, "ingest (parallel Avro ingestion)", 9)):
            if value is not None:
                raise not_ported(what, slice_no)
        self.task = TaskType(task)
        self.coordinate_configs = coordinates
        self.update_sequence = update_sequence
        self.device = resolve_device(device)
        self.descent_iterations = descent_iterations
        self.validation_evaluators = validation_evaluators or []
        self.normalization = normalization or {}
        self.compute_variances_at_end = compute_variances_at_end
        self.loss = losses_mod.loss_for_task(self.task)
        # (cache key, coords) of the last fit: repeated fits on the SAME
        # dataset (tuning trials) swap optimization configs instead of
        # re-staging. A shared mutable holder, so shallow copies of the
        # estimator feed the same cache.
        self._coord_cache: dict[str, tuple[tuple, dict]] = {}

    @property
    def coordinates(self) -> Optional[dict[str, object]]:
        """The coordinates the last fit built (staged data, layouts), or
        None before the first fit."""
        cached = self._coord_cache.get("last")
        return None if cached is None else cached[1]

    # -- coordinate construction ------------------------------------------

    def _build_coordinates(
        self,
        dataset: GameDataset,
        opt_configs: dict[str, GLMOptimizationConfiguration],
    ) -> dict[str, object]:
        coords: dict[str, object] = {}
        for cid, cc in self.coordinate_configs.items():
            opt = opt_configs[cid]
            data = cc.data
            if isinstance(data, FixedEffectDataConfiguration):
                shard = dataset.feature_shards[data.feature_shard_id]
                if isinstance(shard, SparseShard):
                    if data.feature_shard_id in self.normalization:
                        raise ValueError(
                            f"normalization is not supported on sparse "
                            f"shard {data.feature_shard_id!r}")
                    coords[cid] = SparseFixedEffectCoordinate(
                        dataset, data.feature_shard_id, self.loss, opt,
                        feature_sharded=data.feature_sharded,
                        hybrid=data.hybrid,
                        feature_dtype=data.feature_dtype,
                        device=self.device)
                    continue
                check_feature_dtype(data.feature_dtype)
                coords[cid] = FixedEffectCoordinate(
                    dataset, data.feature_shard_id, self.loss, opt,
                    norm=self.normalization.get(data.feature_shard_id,
                                                NormalizationContext()),
                    device=self.device)
            elif isinstance(data, RandomEffectDataConfiguration):
                if data.projector.upper() == "RANDOM":
                    raise not_ported(
                        "projector=RANDOM (a factored random effect with a "
                        "frozen projection)", 8)
                coords[cid] = RandomEffectCoordinate(
                    dataset, data.random_effect_type, data.feature_shard_id,
                    self.loss, opt,
                    lower_bound=data.active_data_lower_bound,
                    upper_bound=data.active_data_upper_bound,
                    norm=self.normalization.get(data.feature_shard_id,
                                                NormalizationContext()),
                    projection=data.projector.upper() == "INDEX_MAP",
                    features_to_samples_ratio=data.features_to_samples_ratio,
                    subspace_model=data.subspace_model,
                    feature_dtype=data.feature_dtype,
                    device=self.device)
            elif isinstance(data, FactoredRandomEffectDataConfiguration):
                raise not_ported("the factored random effect", 8)
            else:
                raise TypeError(f"unknown coordinate data configuration "
                                f"{type(data).__name__}")
        return coords

    # -- evaluation --------------------------------------------------------

    def _evaluate(self, model: GameModel, dataset: GameDataset
                  ) -> Optional[ev.EvaluationResults]:
        if not self.validation_evaluators:
            return None
        return ev.evaluation_suite(
            self.validation_evaluators, model.score(dataset),
            dataset.response, dataset.weights,
            group_ids_by_column=dict(dataset.entity_ids),
            num_groups_by_column=dict(dataset.num_entities))

    @staticmethod
    def _check_vocabularies(data: GameDataset,
                            validation_data: GameDataset) -> None:
        """Validation must use the training entity vocabularies (or an
        extension of them): a smaller table means ids that misalign."""
        for t, n_train in data.num_entities.items():
            n_val = validation_data.num_entities.get(t)
            if n_val is None:
                continue
            if n_val < n_train:
                raise ValueError(
                    f"validation entity vocabulary for {t!r} has size "
                    f"{n_val} < training {n_train}; read validation with "
                    f"the training vocabularies")
            if n_val > n_train:
                logger.warning(
                    "validation %s vocabulary (%d) extends training (%d): "
                    "assuming shared ids for the first %d entities — "
                    "unseen ones score with zero random-effect "
                    "contribution.", t, n_val, n_train, n_train)

    # -- fit ---------------------------------------------------------------

    def fit(self, data: GameDataset,
            validation_data: Optional[GameDataset] = None,
            initial_models: Optional[dict] = None,
            locked_coordinates: Optional[set[str]] = None,
            checkpoint_dir: Optional[str] = None) -> list[GameResult]:
        """Train one GAME model per point of the regularization grid.

        Returns one GameResult per grid combination (cartesian product of
        each coordinate's ``reg_weight_grid``), mirroring the reference's
        Seq[GameOptimizationConfiguration] loop. Coordinates (staging,
        bucketing, layouts) are built once; later grid points, and later
        fits on the same dataset content, swap only the optimization
        config.
        """
        if checkpoint_dir is not None:
            raise not_ported("checkpoint_dir (checkpoints and resume)", 6)
        if validation_data is not None:
            self._check_vocabularies(data, validation_data)
        cids = list(self.coordinate_configs)
        grids = [self.coordinate_configs[c].expand_grid() for c in cids]
        results: list[GameResult] = []
        base_coords: Optional[dict[str, object]] = None
        for combo in itertools.product(*grids):
            opt_configs = dict(zip(cids, combo))
            if base_coords is None:
                cache_key = (
                    dataset_digest(data),
                    tuple(sorted(data.num_entities.items())),
                    tuple(sorted(data.intercept_index.items())),
                    self.task, str(self.device),
                    tuple(sorted((s, normalization_digest(ctx))
                                 for s, ctx in self.normalization.items())),
                    tuple((cid, self.coordinate_configs[cid].data)
                          for cid in cids))
                cached = self._coord_cache.get("last")
                if cached is not None and cached[0] == cache_key:
                    base_coords = {
                        cid: cached[1][cid].with_optimization_config(
                            opt_configs[cid]) for cid in cids}
                else:
                    base_coords = self._build_coordinates(data, opt_configs)
                self._coord_cache["last"] = (cache_key, base_coords)
                coords = base_coords
            else:
                coords = {cid: base_coords[cid].with_optimization_config(
                    opt_configs[cid]) for cid in cids}
            val_fn = None
            if validation_data is not None and self.validation_evaluators:
                def val_fn(m, _vd=validation_data):
                    return self._evaluate(m, _vd).metrics
            model, history = descent.run(
                self.task, coords,
                descent.CoordinateDescentConfig(self.update_sequence,
                                                self.descent_iterations),
                initial_models=initial_models,
                locked_coordinates=locked_coordinates,
                validation_fn=val_fn)
            model = self._finalize_variances(model, coords, data)
            evaluation = (self._evaluate(model, validation_data)
                          if validation_data is not None else None)
            logger.info("GAME fit done for %s: %s",
                        {c: o.regularization.reg_weight
                         for c, o in opt_configs.items()},
                        evaluation.metrics if evaluation else "")
            results.append(GameResult(model=model, evaluation=evaluation,
                                      configs=opt_configs, history=history))
        return results

    def _finalize_variances(self, model: GameModel, coords,
                            data: GameDataset) -> GameModel:
        """Per-coordinate coefficient variances at the optimum (reference:
        variance computation happens once after training)."""
        if not self.compute_variances_at_end:
            return model
        if all(VarianceComputationType(c.optimization.variance_computation)
               == VarianceComputationType.NONE
               for c in self.coordinate_configs.values()):
            return model
        scores = {cid: coords[cid].score(m)
                  for cid, m in model.models.items()}
        total = torch.as_tensor(data.offsets, dtype=torch.float32,
                                device=self.device) + sum(scores.values())
        models = dict(model.models)
        for cid, m in model.models.items():
            models[cid] = coords[cid].compute_model_variances(
                m, total - scores[cid])
        return dataclasses.replace(model, models=models)

    def select_best_model(self, results: list[GameResult]) -> GameResult:
        """Pick by the primary validation evaluator (reference:
        GameEstimator's best-model selection)."""
        best = None
        for r in results:
            if best is None:
                best = r
            elif (r.evaluation is not None
                  and r.evaluation.better_than(best.evaluation)):
                best = r
        if best is None:
            raise ValueError("no results to select from")
        return best
