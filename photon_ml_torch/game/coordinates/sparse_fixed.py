"""Sparse fixed-effect coordinate: ELL / hybrid layouts (the Criteo path).

Port of ``photon_ml_tpu/game/coordinates/sparse_fixed.py`` on one device.
Two layouts, as in the reference:

- ``hybrid`` (the default, ``hybrid=None``, as the reference resolves it
  on one device; or ``hybrid=True``): the hot-dense / cold-class layout
  of ``ops/hybrid_sparse.py``, solved in its permuted feature space by
  ``optim/sparse_problem.run_hybrid``. On a CUDA device the hot block
  goes through the ``hot_margins`` / ``hot_rmatvec`` kernels, the cold
  margins through ``ell_scatter`` and every cold gradient, H·v and
  Hessian diagonal through ``cold_grad``;
- ELL (``hybrid=False``): ``optim/sparse_problem.run`` where the
  reference runs its mesh twin (``parallel/sparse_problem.run``), every
  gradient, H·v and Hessian diagonal through the ``ell_scatter``
  kernel's fused route ``ell_rmatvec`` on a CUDA device.

``feature_dtype="bfloat16"`` stores the hybrid hot block in bfloat16
(``ops/hybrid_sparse.py``); the ELL layout ignores it, as the
reference's does.

``config.down_sampling_rate < 1`` draws one subset a ``train_model``
on the host with the reference's generator (``game/sampling.py``). ELL
gathers the sampled rows on the device and builds their column layout
there for the ``ell_rmatvec`` kernel, once a draw; the hybrid layout
masks the weights instead (dropped rows weigh 0, kept rows carry the
rate's multiplier), so its hot block and cold classes stay as staged.

Not ported yet, raising if asked for: ``feature_sharded=True`` and the
data-sharded hybrid layout are slice 9.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_torch import not_ported, obs
from photon_ml_torch.data.batch import check_feature_dtype
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.data.sparse import SparseBatch
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game.coordinates._down_sampling import (
    _advance_down_sampling, draw_down_sample)
from photon_ml_torch.game.models import FixedEffectModel
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.obs.ledger import spill_history
from photon_ml_torch.ops import hybrid_sparse
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
    """Fixed-effect GLM over a sparse shard (the Criteo path).

    Reference parity: the FixedEffectCoordinate contract, with the sparse
    objective (``ops/hybrid_sparse.py`` or ``ops/sparse_aggregators.py``)
    in place of dense matrix products — the analogue of the reference
    training on sparse Breeze vectors with PalDB index maps.

    Residency: ``__init__`` stages the shard, labels and weights on
    ``device`` once (``cuda`` unless the caller passes ``"cpu"``): the
    hybrid layout (``hybrid=None`` or ``True``), or the ELL batch
    (``hybrid=False``), and on a card the column layout the
    ``ell_scatter`` kernels read. Per coordinate-descent step only the
    (n,) offsets and the warm start move. ``last_solve`` describes the
    latest ``train_model`` solve (and, down-sampled, the sampled rows and
    the seconds the sampled batch took to build); ``staging_seconds``
    what staging took.

    Normalization is not supported here (the reference normalizes dense
    shards only).
    """

    def __init__(self, dataset: GameDataset, shard_id: str,
                 loss: PointwiseLoss, config: GLMOptimizationConfiguration,
                 feature_sharded: bool = False,
                 down_sampling_seed: int = 0,
                 hybrid: Optional[bool] = None,
                 feature_dtype: str = "float32",
                 device: Optional[DeviceLike] = None):
        shard = dataset.feature_shards[shard_id]
        if not isinstance(shard, SparseShard):
            raise TypeError(f"shard {shard_id!r} is not sparse")
        if hybrid is None:
            self.hybrid = not feature_sharded
        else:
            self.hybrid = bool(hybrid)
            if self.hybrid and feature_sharded:
                raise ValueError(
                    "hybrid=True is incompatible with feature_sharded "
                    "(the hybrid layout needs the permuted coefficient "
                    "space replicated on every shard)")
        if feature_sharded:
            raise not_ported("feature_sharded=True", 9)
        block_dtype = check_feature_dtype(feature_dtype)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.shard_id = shard_id
        self.loss = loss
        self.config = config
        self.intercept_index = dataset.intercept_index.get(shard_id)
        self._down_sampling_seed = down_sampling_seed
        self._rng = np.random.default_rng(down_sampling_seed)
        self._dim = int(shard.num_features)
        self.last_solve: Optional[dict] = None
        t0 = time.perf_counter()
        batch = SparseBatch(
            indices=torch.from_numpy(np.asarray(shard.indices, np.int32)),
            values=torch.from_numpy(np.asarray(shard.values, np.float32)),
            labels=torch.from_numpy(np.asarray(dataset.response,
                                               np.float32)),
            weights=torch.from_numpy(np.asarray(dataset.weights,
                                                np.float32)),
            offsets=torch.zeros(dataset.num_rows, dtype=torch.float32),
            num_features=self._dim)
        self._ii_perm: Optional[int] = None
        if self.hybrid:
            self._staged = hybrid_sparse.build_hybrid(
                batch, feature_dtype=block_dtype or torch.float32,
                device=self.device)
            if self.intercept_index is not None:
                self._ii_perm = int(
                    self._staged.inv_perm[self.intercept_index])
        else:
            self._staged = batch.to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # Building the layout on the device (and, on a card, the column
        # layout of its scatter): paid once per coordinate.
        self.staging_seconds = time.perf_counter() - t0

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def staged(self):
        """The staged batch (offsets zero): a HybridSparseBatch or an ELL
        SparseBatch of device tensors and, on a card, its scatter's column
        layout."""
        return self._staged

    def with_optimization_config(
            self, config: GLMOptimizationConfiguration
    ) -> "SparseFixedEffectCoordinate":
        """Cheap copy with a new optimization config, sharing the staged
        batch and its layout. Its generator is fresh and identically
        seeded, so every grid point draws the same subsets."""
        import copy

        c = copy.copy(self)
        c.config = config
        c._rng = np.random.default_rng(self._down_sampling_seed)
        c.last_solve = None
        return c

    def _batch(self, offsets):
        return dataclasses.replace(self._staged, offsets=torch.as_tensor(
            offsets, dtype=torch.float32, device=self.device))

    def _sampled_batch(self, batch, rate: float):
        """One down-sampling draw applied to ``batch`` (offsets set), and
        the rows drawn: ELL gathers the sampled rows (and, on a card,
        builds their column layout); hybrid masks the weights, as the
        reference does."""
        idx, mult = draw_down_sample(self, rate)
        idx = torch.from_numpy(idx).to(self.device)
        mult = torch.from_numpy(mult).to(self.device)
        if self.hybrid:
            w = torch.zeros_like(batch.weights)
            w[idx] = batch.weights[idx] * mult
            return dataclasses.replace(batch, weights=w), len(idx)
        return SparseBatch(
            indices=batch.indices[idx], values=batch.values[idx],
            labels=batch.labels[idx], weights=batch.weights[idx] * mult,
            offsets=batch.offsets[idx],
            num_features=batch.num_features).to(self.device), len(idx)

    def train_model(self, offsets,
                    initial: Optional[FixedEffectModel] = None
                    ) -> FixedEffectModel:
        w0 = (initial.coefficients.means if initial is not None
              else torch.zeros(self.dim, dtype=torch.float32,
                               device=self.device))
        cfg = dataclasses.replace(
            self.config, variance_computation=VarianceComputationType.NONE)
        stats = sparse_problem.SolveStats()
        batch = self._batch(offsets)
        sampled = {}
        rate = self.config.down_sampling_rate
        if rate < 1.0:
            t0 = time.perf_counter()
            batch, rows = self._sampled_batch(batch, rate)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            sampled = {"sample_seconds": time.perf_counter() - t0,
                       "sampled_rows": rows}
        if self.hybrid:
            coef, res = sparse_problem.run_hybrid(
                self.loss, batch, cfg, initial=Coefficients(w0),
                intercept_index_permuted=self._ii_perm, stats=stats)
        else:
            coef, res = sparse_problem.run(
                self.loss, batch, cfg, initial=Coefficients(w0),
                intercept_index=self.intercept_index, stats=stats)
        self.last_solve = {
            "optimizer": resolve_optimizer_config(
                cfg.optimizer, cfg.regularization.l1_weight() > 0.0
            ).optimizer_type.value,
            "iterations": int(res.iterations[0]),
            "converged": bool(res.converged[0]),
            "gradient_evaluations": stats.gradient_evaluations,
            "hessian_vector_products": stats.hessian_vector_products,
            **sampled}
        led = obs.ledger()
        if led is not None:
            # Post-fit spill of the solver's histories (one host read an
            # update).
            spill_history(
                led, res.value_history[0].cpu().numpy(),
                res.grad_norm_history[0].cpu().numpy(),
                opt=self.config.optimizer.optimizer_type.value.lower())
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
        batch = self._batch(offsets)
        if self.hybrid:
            diag = hybrid_sparse.to_original_space(
                batch, hybrid_sparse.hessian_diagonal(
                    self.loss, hybrid_sparse.to_permuted_space(batch, means),
                    batch))
        else:
            diag = sparse_problem.make_hessian_diagonal(
                self.loss, batch)(means)
        mask = torch.as_tensor(intercept_mask(self.dim, self.intercept_index),
                               device=self.device)
        var = variances_from_diagonal(
            diag, self.config.regularization.l2_weight(), mask)
        return dataclasses.replace(
            model, coefficients=Coefficients(model.coefficients.means, var))

    def score(self, model: FixedEffectModel) -> Tensor:
        """(n,) X @ w over the staged shard (its offsets are zeros)."""
        means = model.coefficients.means.to(self.device)
        if self.hybrid:
            return hybrid_sparse.margins(
                self._staged,
                hybrid_sparse.to_permuted_space(self._staged, means))
        return sagg.margins(self._staged, means)

    def initial_model(self) -> FixedEffectModel:
        return FixedEffectModel(
            shard_id=self.shard_id,
            coefficients=Coefficients.zeros(self.dim, device=self.device))

    def advance_down_sampling(self, steps: int) -> None:
        """See FixedEffectCoordinate.advance_down_sampling."""
        _advance_down_sampling(self, steps)
