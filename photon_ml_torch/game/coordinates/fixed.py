"""Dense fixed-effect coordinate: one shared GLM over the whole dataset.

Port of ``photon_ml_tpu/game/coordinates/fixed.py`` on one device: the
solve is ``optim/problem.run`` where the reference runs its mesh-parallel
twin (``parallel/problem.run``). Down-sampling is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_torch import not_ported
from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.data.game_data import GameDataset
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game.models import FixedEffectModel
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops import aggregators as agg
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.optim import problem
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)

Tensor = torch.Tensor


class FixedEffectCoordinate:
    """One shared GLM (reference: FixedEffectCoordinate +
    DistributedOptimizationProblem).

    Model-space contract: the optimizer runs in the normalization-
    transformed space, but the FixedEffectModel handed out always holds
    ORIGINAL-space coefficients, so every scorer is a plain X @ w.

    The dataset stays host numpy; ``__init__`` stages its features,
    labels and weights on ``device`` once (``cuda`` unless the caller
    passes ``"cpu"``).
    """

    def __init__(self, dataset: GameDataset, shard_id: str,
                 loss: PointwiseLoss, config: GLMOptimizationConfiguration,
                 norm: NormalizationContext = NormalizationContext(),
                 device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        self._check_config(config)
        self.dataset = dataset
        self.shard_id = shard_id
        self.loss = loss
        self.config = config
        self.norm = norm.to(self.device)
        self.intercept_index = dataset.intercept_index.get(shard_id)
        self._staged = LabeledBatch.build(
            dataset.feature_shards[shard_id], dataset.response,
            dataset.weights, device=self.device)

    @staticmethod
    def _check_config(config: GLMOptimizationConfiguration) -> None:
        if config.down_sampling_rate < 1.0:
            raise not_ported("down-sampling", 6)

    @property
    def dim(self) -> int:
        return self.dataset.shard_dim(self.shard_id)

    def with_optimization_config(
            self, config: GLMOptimizationConfiguration
    ) -> "FixedEffectCoordinate":
        """Cheap copy with a new optimization config, sharing the staged
        tensors."""
        import copy

        self._check_config(config)
        c = copy.copy(self)
        c.config = config
        return c

    def _batch(self, offsets) -> LabeledBatch:
        return dataclasses.replace(self._staged, offsets=torch.as_tensor(
            offsets, dtype=torch.float32, device=self.device))

    def train_model(self, offsets,
                    initial: Optional[FixedEffectModel] = None
                    ) -> FixedEffectModel:
        w0 = (self.norm.model_to_transformed_space(
                  initial.coefficients.means.to(self.device))
              if initial is not None else
              torch.zeros((self.dim,), dtype=torch.float32,
                          device=self.device))
        cfg = dataclasses.replace(
            self.config, variance_computation=VarianceComputationType.NONE)
        coef, _ = problem.run(self.loss, self._batch(offsets), cfg,
                              initial=Coefficients(w0), norm=self.norm,
                              intercept_index=self.intercept_index)
        raw = Coefficients(self.norm.model_to_original_space(coef.means))
        return FixedEffectModel(shard_id=self.shard_id, coefficients=raw)

    def compute_model_variances(self, model: FixedEffectModel,
                                offsets) -> FixedEffectModel:
        """Coefficient variances at the optimum, computed in the
        transformed space and mapped back (factor² scaling plus the
        intercept's shift-mass term)."""
        kind = VarianceComputationType(self.config.variance_computation)
        if kind == VarianceComputationType.NONE:
            return model
        w_t = self.norm.model_to_transformed_space(
            model.coefficients.means.to(self.device))
        var_t = problem.compute_variances(
            self.loss, w_t, self._batch(offsets), self.norm, kind,
            self.config.regularization, self.intercept_index)
        var = self.norm.variances_to_original_space(var_t)
        return dataclasses.replace(
            model, coefficients=Coefficients(model.coefficients.means, var))

    def score(self, model: FixedEffectModel) -> Tensor:
        """Raw-space scores (identical to the training margins by
        algebra)."""
        return agg.scores(self._staged.features,
                          model.coefficients.means.to(self.device))

    def initial_model(self) -> FixedEffectModel:
        return FixedEffectModel(
            shard_id=self.shard_id,
            coefficients=Coefficients.zeros(self.dim, device=self.device))
