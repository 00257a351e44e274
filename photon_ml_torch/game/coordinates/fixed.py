"""Dense fixed-effect coordinate: one shared GLM over the whole dataset.

Port of ``photon_ml_tpu/game/coordinates/fixed.py`` on one device: the
solve is ``optim/problem.run`` where the reference runs its mesh-parallel
twin (``parallel/problem.run``). Down-sampling draws its subsets on the
host with the reference's generator (``game/sampling.py``) and gathers the
sampled rows on the device, in their stored dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_torch import obs
from photon_ml_torch.data.batch import LabeledBatch, check_feature_dtype
from photon_ml_torch.data.game_data import GameDataset
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game.coordinates._down_sampling import (
    _advance_down_sampling, draw_down_sample)
from photon_ml_torch.game.models import FixedEffectModel
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.obs.ledger import spill_history
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
    passes ``"cpu"``), the features in ``feature_dtype`` (float32 or
    bfloat16; see ``ops/aggregators.py`` for the float32-accumulation
    contract).

    ``config.down_sampling_rate < 1`` fits each ``train_model`` on a
    subset drawn from a generator seeded with ``down_sampling_seed``
    (reference: DownSampler), one draw per call.
    """

    def __init__(self, dataset: GameDataset, shard_id: str,
                 loss: PointwiseLoss, config: GLMOptimizationConfiguration,
                 norm: NormalizationContext = NormalizationContext(),
                 down_sampling_seed: int = 0,
                 feature_dtype: str = "float32",
                 device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        check_feature_dtype(feature_dtype)
        self.dataset = dataset
        self.shard_id = shard_id
        self.loss = loss
        self.config = config
        self.norm = norm.to(self.device)
        self.intercept_index = dataset.intercept_index.get(shard_id)
        self._down_sampling_seed = down_sampling_seed
        self._rng = np.random.default_rng(down_sampling_seed)
        self.feature_dtype = feature_dtype
        # Scoring reuses the staged features: no second copy of X.
        self._staged = LabeledBatch.build(
            dataset.feature_shards[shard_id], dataset.response,
            dataset.weights, feature_dtype=feature_dtype,
            device=self.device)

    @property
    def dim(self) -> int:
        return self.dataset.shard_dim(self.shard_id)

    def with_optimization_config(
            self, config: GLMOptimizationConfiguration
    ) -> "FixedEffectCoordinate":
        """Cheap copy with a new optimization config, sharing the staged
        tensors. Its generator is fresh and identically seeded, so every
        grid point trains on the SAME down-sampled subsets."""
        import copy

        c = copy.copy(self)
        c.config = config
        c._rng = np.random.default_rng(self._down_sampling_seed)
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
        batch = self._batch(offsets)
        rate = self.config.down_sampling_rate
        if rate < 1.0:
            # Reference: DownSampler subsamples the coordinate's data each
            # training pass, rescaling weights by 1/rate. The draw is on
            # the host; the rows are gathered on the device.
            idx, mult = draw_down_sample(self, rate)
            idx = torch.from_numpy(idx).to(self.device)
            mult = torch.from_numpy(mult).to(self.device)
            batch = LabeledBatch(features=batch.features[idx],
                                 labels=batch.labels[idx],
                                 weights=batch.weights[idx] * mult,
                                 offsets=batch.offsets[idx])
        coef, res = problem.run(self.loss, batch, cfg,
                                initial=Coefficients(w0), norm=self.norm,
                                intercept_index=self.intercept_index)
        led = obs.ledger()
        if led is not None:
            # Post-fit spill of the solver's NaN-padded histories: one
            # host read of two (max_iterations + 1,) vectors an update.
            spill_history(
                led, res.value_history[0].cpu().numpy(),
                res.grad_norm_history[0].cpu().numpy(),
                opt=self.config.optimizer.optimizer_type.value.lower())
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

    def advance_down_sampling(self, steps: int) -> None:
        """Fast-forward the down-sampling generator past ``steps``
        completed train_model calls (checkpoint resume must subsample the
        remaining steps exactly as the uninterrupted run would have)."""
        _advance_down_sampling(self, steps)
