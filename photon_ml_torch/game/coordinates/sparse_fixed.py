"""Sparse fixed-effect coordinate on the ELL layout (the Criteo path).

Port of ``photon_ml_tpu/game/coordinates/sparse_fixed.py`` on one device
and the ELL layout (``hybrid=False``): the solve is
``optim/sparse_problem.run`` where the reference runs its mesh twin
(``parallel/sparse_problem.run``), and every gradient, H·v and Hessian
diagonal goes through the ``ell_scatter`` kernel on a CUDA device.

Not ported yet, each raising if asked for: the hot/cold hybrid layout
(``hybrid=True``, and ``hybrid=None``, which the reference resolves to it
on one device) is slice 4; ``feature_sharded=True`` is slice 9;
down-sampling and bf16 feature storage are slice 6.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.data.batch import check_feature_dtype
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.data.sparse import SparseBatch
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game.models import FixedEffectModel
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops import sparse_aggregators as sagg
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.optim import sparse_problem
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType,
                                           resolve_optimizer_config,
                                           variances_from_diagonal)
from photon_ml_torch.optim.regularization import intercept_mask

Tensor = torch.Tensor


class SparseFixedEffectCoordinate:
    """Fixed-effect GLM over an ELL sparse shard (the Criteo path).

    Reference parity: the FixedEffectCoordinate contract, with the sparse
    gather/scatter objective (``ops/sparse_aggregators.py``) in place of
    dense matrix products — the analogue of the reference training on
    sparse Breeze vectors with PalDB index maps.

    Residency: ``__init__`` stages the shard, labels and weights on
    ``device`` once (``cuda`` unless the caller passes ``"cpu"``), and on
    a card builds the column layout the ``ell_scatter`` kernel reads. Per
    coordinate-descent step only the (n,) offsets and the warm start
    move. ``last_solve`` describes the latest ``train_model`` solve.

    Normalization is not supported here (the reference normalizes dense
    shards only).
    """

    def __init__(self, dataset: GameDataset, shard_id: str,
                 loss: PointwiseLoss, config: GLMOptimizationConfiguration,
                 feature_sharded: bool = False,
                 hybrid: Optional[bool] = None,
                 feature_dtype: str = "float32",
                 device: Optional[DeviceLike] = None):
        shard = dataset.feature_shards[shard_id]
        if not isinstance(shard, SparseShard):
            raise TypeError(f"shard {shard_id!r} is not sparse")
        if hybrid is None or hybrid:
            raise not_ported(
                "the hot/cold hybrid sparse layout (hybrid=True, and "
                "hybrid=None, which resolves to it on one device; pass "
                "hybrid=False for the ELL layout)", 4)
        if feature_sharded:
            raise not_ported("feature_sharded=True", 9)
        check_feature_dtype(feature_dtype)
        self._check_config(config)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.shard_id = shard_id
        self.loss = loss
        self.config = config
        self.intercept_index = dataset.intercept_index.get(shard_id)
        self._dim = int(shard.num_features)
        self.last_solve: Optional[dict] = None
        t0 = time.perf_counter()
        self._staged = SparseBatch(
            indices=torch.from_numpy(np.asarray(shard.indices, np.int32)),
            values=torch.from_numpy(np.asarray(shard.values, np.float32)),
            labels=torch.from_numpy(np.asarray(dataset.response,
                                               np.float32)),
            weights=torch.from_numpy(np.asarray(dataset.weights,
                                                np.float32)),
            offsets=torch.zeros(dataset.num_rows, dtype=torch.float32),
            num_features=self._dim).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # Copying the shard to the device and, on a card, sorting its
        # column layout: paid once per coordinate.
        self.staging_seconds = time.perf_counter() - t0

    @staticmethod
    def _check_config(config: GLMOptimizationConfiguration) -> None:
        if config.down_sampling_rate < 1.0:
            raise not_ported("down-sampling", 6)

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def staged(self) -> SparseBatch:
        """The staged batch: device tensors (offsets zero) and, on a card,
        the column layout."""
        return self._staged

    def with_optimization_config(
            self, config: GLMOptimizationConfiguration
    ) -> "SparseFixedEffectCoordinate":
        """Cheap copy with a new optimization config, sharing the staged
        batch and its layout."""
        import copy

        self._check_config(config)
        c = copy.copy(self)
        c.config = config
        c.last_solve = None
        return c

    def _batch(self, offsets) -> SparseBatch:
        return dataclasses.replace(self._staged, offsets=torch.as_tensor(
            offsets, dtype=torch.float32, device=self.device))

    def train_model(self, offsets,
                    initial: Optional[FixedEffectModel] = None
                    ) -> FixedEffectModel:
        w0 = (initial.coefficients.means if initial is not None
              else torch.zeros(self.dim, dtype=torch.float32,
                               device=self.device))
        cfg = dataclasses.replace(
            self.config, variance_computation=VarianceComputationType.NONE)
        stats = sparse_problem.SolveStats()
        coef, res = sparse_problem.run(
            self.loss, self._batch(offsets), cfg,
            initial=Coefficients(w0), intercept_index=self.intercept_index,
            stats=stats)
        self.last_solve = {
            "optimizer": resolve_optimizer_config(
                cfg.optimizer, cfg.regularization.l1_weight() > 0.0
            ).optimizer_type.value,
            "iterations": int(res.iterations[0]),
            "converged": bool(res.converged[0]),
            "gradient_evaluations": stats.gradient_evaluations,
            "hessian_vector_products": stats.hessian_vector_products}
        return FixedEffectModel(shard_id=self.shard_id,
                                coefficients=Coefficients(coef.means))

    def compute_model_variances(self, model: FixedEffectModel,
                                offsets) -> FixedEffectModel:
        """SIMPLE variances 1/(diag(H) + λ·mask) at the model's
        coefficients; FULL needs the dense d×d Hessian and raises."""
        kind = VarianceComputationType(self.config.variance_computation)
        if kind == VarianceComputationType.NONE:
            return model
        if kind == VarianceComputationType.FULL:
            raise NotImplementedError(
                "FULL variance needs the dense d×d Hessian — use SIMPLE at "
                "sparse scale (as the reference does)")
        means = model.coefficients.means.to(self.device)
        diag = sparse_problem.make_hessian_diagonal(
            self.loss, self._batch(offsets))(means)
        mask = torch.as_tensor(intercept_mask(self.dim, self.intercept_index),
                               device=self.device)
        var = variances_from_diagonal(
            diag, self.config.regularization.l2_weight(), mask)
        return dataclasses.replace(
            model, coefficients=Coefficients(model.coefficients.means, var))

    def score(self, model: FixedEffectModel) -> Tensor:
        """(n,) X @ w over the staged shard (its offsets are zeros)."""
        return sagg.margins(self._staged,
                            model.coefficients.means.to(self.device))

    def initial_model(self) -> FixedEffectModel:
        return FixedEffectModel(
            shard_id=self.shard_id,
            coefficients=Coefficients.zeros(self.dim, device=self.device))
