"""Random-effect coordinate: per-entity solves over padded entity buckets.

Port of the unprojected path of
``photon_ml_tpu/game/coordinates/random_effect.py``. Entities are grouped
into power-of-two capacity buckets (``game/buckets.py``); each bucket is
cut into waves of at most ``LANE_CHUNK`` entity lanes, and each wave runs

    w0    = gather_rows(W, rows)          # warm starts (kernel)
    w_fit = lane-batched L-BFGS / OWL-QN  # one lane per entity
    scatter_rows_(W, rows, w_fit)         # fitted rows, in place (kernel)

over the (E, d) coefficient table, where the reference runs ``vmap`` of
its solver between the same two row moves. Padding lanes (row −1) solve
on all-zero weights, and the scatter drops their results.

Under ``feature_dtype="bfloat16"`` the waves' feature blocks are stored
in bfloat16, cast after staging, as the reference casts its bucket
blocks; the shard kept for scoring stays float32, as the reference's
does. The solves accumulate in float32 (``ops/aggregators.py``).

Each wave is a ``re.fit_wave`` span when tracing is on, adds its live
lanes to ``photon_re_entities_refit_total{re_type=}`` and records a
``re_fit_wave`` ledger row; the lane counts come from the host's copy of
the bucketing, never from the card.

Not ported yet, each raising if asked for: the projected and subspace
paths, sparse shards, the staging cache, gated sweeps (and with them
the segment rescore), Gram fits and factored warm starts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_torch import not_ported, obs
from photon_ml_torch.data.batch import LabeledBatch, check_feature_dtype
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game import buckets as bkt
from photon_ml_torch.game.models import RandomEffectModel
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops.kernels import re_rows
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.optim import optimize
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType,
                                           compute_variances, make_objective,
                                           resolve_optimizer_config)

Tensor = torch.Tensor

# Max entity lanes per wave: the solver's state and line-search
# temporaries scale with lanes. The reference's game/staging.LANE_CHUNK.
LANE_CHUNK = 65536
# Every bucket's entity count is padded to a multiple of this: the
# reference's max(8, devices) on one device.
ENTITY_PAD_MULTIPLE = 8


@dataclasses.dataclass(frozen=True)
class _Wave:
    """One wave's staged tensors: lanes (B,) of one bucket, cap rows each."""

    X: Tensor  # (B, cap, d) features, float32 or bfloat16
    y: Tensor  # (B, cap) labels
    w: Tensor  # (B, cap) weights, 0 on padding slots
    ex: Tensor  # (B, cap) int64 example rows, padding slots read row 0
    rows: Tensor  # (B,) int32 entity rows, −1 on padding lanes


class RandomEffectCoordinate:
    """Per-entity GLMs trained as lane-batched bucket solves.

    Reference parity: RandomEffectCoordinate + SingleNodeOptimizationProblem
    (a local L-BFGS per entity); here all entities of a wave solve at once,
    each lane stopping on its own.

    Model-space contract: solves run in the shard's normalization-
    transformed space; the RandomEffectModel rows are ORIGINAL-space, so
    scoring is the plain gather and rowwise dot.

    The dataset stays host numpy. ``__init__`` buckets the entities with
    ``rng`` (the capping draw of ``upper_bound``) and stages the features,
    ids and every wave's blocks on ``device`` once (``cuda`` unless the
    caller passes ``"cpu"``).
    """

    def __init__(self, dataset: GameDataset, re_type: str, shard_id: str,
                 loss: PointwiseLoss, config: GLMOptimizationConfiguration,
                 lower_bound: int = 1, upper_bound: Optional[int] = None,
                 norm: NormalizationContext = NormalizationContext(),
                 rng: Optional[np.random.Generator] = None,
                 projection: bool = False,
                 features_to_samples_ratio: Optional[float] = None,
                 subspace_model: Optional[bool] = None,
                 staging_cache_dir: Optional[str] = None,
                 feature_dtype: str = "float32",
                 device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        block_dtype = check_feature_dtype(feature_dtype) or torch.float32
        shard = dataset.feature_shards[shard_id]
        if isinstance(shard, SparseShard):
            raise not_ported("a sparse random-effect shard", 6)
        if projection or features_to_samples_ratio is not None \
                or subspace_model:
            raise not_ported("the projected (subspace) random effect", 6)
        if staging_cache_dir:
            raise not_ported("the staging cache", 6)
        self.dataset = dataset
        self.re_type = re_type
        self.shard_id = shard_id
        self.loss = loss
        self.config = config
        self.norm = norm.to(self.device)
        self.num_entities = dataset.num_entities[re_type]
        self.intercept_index = dataset.intercept_index.get(shard_id)
        ids = np.asarray(dataset.entity_ids[re_type])
        self.bucketing = bkt.build_bucketing(
            ids, self.num_entities, lower_bound=lower_bound,
            upper_bound=upper_bound,
            entity_pad_multiple=ENTITY_PAD_MULTIPLE,
            rng=np.random.default_rng(0) if rng is None else rng)

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        self._X = put(shard, torch.float32)
        self._ids = put(ids, torch.int64)
        self._waves: list[_Wave] = []
        # Live (non-padding) lanes of each wave, counted on the host.
        self._lanes: list[int] = []
        y = put(dataset.response, torch.float32)
        wts = put(dataset.weights, torch.float32)
        for b in self.bucketing.buckets:
            for lo in range(0, b.num_entities, LANE_CHUNK):
                hi = lo + LANE_CHUNK
                ex_host = b.example_idx[lo:hi]
                ex = put(np.maximum(ex_host, 0), torch.int64)
                wb = wts[ex]
                wb[put(ex_host < 0, torch.bool)] = 0.0
                self._waves.append(_Wave(
                    X=self._X[ex].to(block_dtype), y=y[ex], w=wb, ex=ex,
                    rows=put(b.entity_rows[lo:hi], torch.int32)))
                self._lanes.append(int((b.entity_rows[lo:hi] >= 0).sum()))

    @property
    def dim(self) -> int:
        return self.dataset.shard_dim(self.shard_id)

    @property
    def num_waves(self) -> int:
        """Bucket waves per ``train_model``: each launches one gather and
        one scatter."""
        return len(self._waves)

    @property
    def wave_rows(self) -> list[Tensor]:
        """Each wave's (B,) int32 entity rows on the device (−1 lanes are
        padding): the row ids the row movers are given."""
        return [wave.rows for wave in self._waves]

    def with_optimization_config(
            self, config: GLMOptimizationConfiguration
    ) -> "RandomEffectCoordinate":
        """Cheap copy with a new optimization config, reusing the
        bucketing and the staged waves."""
        import copy

        c = copy.copy(self)
        c.config = config
        return c

    def _batch(self, wave: _Wave, offsets: Tensor) -> LabeledBatch:
        return LabeledBatch(wave.X, wave.y, wave.w, offsets[wave.ex])

    def _solve(self, wave: _Wave, offsets: Tensor, w0: Tensor) -> Tensor:
        """Every lane's GLM solve in transformed space: (B, d) fits."""
        vg, hvp, l1w = make_objective(
            self.loss, self._batch(wave, offsets), self.norm,
            self.config.regularization, self.intercept_index, self.dim)
        opt_cfg = resolve_optimizer_config(self.config.optimizer,
                                           l1w is not None)
        return optimize(vg, w0, opt_cfg, hvp=hvp, l1_weights=l1w).w

    def _variances(self, wave: _Wave, offsets: Tensor,
                   w_opt: Tensor) -> Tensor:
        """Variances at the trained optimum (no re-solve; reference
        computeVariances evaluates the Hessian at the model
        coefficients)."""
        return compute_variances(
            self.loss, w_opt, self._batch(wave, offsets), self.norm,
            self.config.variance_computation, self.config.regularization,
            self.intercept_index)

    def _offsets(self, offsets) -> Tensor:
        return torch.as_tensor(offsets, dtype=torch.float32,
                               device=self.device)

    def _table(self, model: RandomEffectModel) -> Tensor:
        """A model's original-space (E, d) table as a fresh contiguous
        transformed-space copy on the device."""
        if type(model) is not RandomEffectModel:
            raise not_ported(f"a {type(model).__name__} warm start", 6)
        if tuple(model.means.shape) != (self.num_entities, self.dim):
            raise ValueError(f"warm start is {tuple(model.means.shape)}, "
                             f"the coordinate expects "
                             f"({self.num_entities}, {self.dim})")
        W = model.means.to(self.device, torch.float32, copy=True)
        return self.norm.model_to_transformed_space(W).contiguous()

    def _prepare_table(self, initial: Optional[RandomEffectModel]) -> Tensor:
        """The table the waves fit into. A warm start is always copied:
        the scatter writes in place, and the caller still holds (and has
        scored) ``initial``."""
        if initial is None:
            return torch.zeros((self.num_entities, self.dim),
                               dtype=torch.float32, device=self.device)
        return self._table(initial)

    def _finish_model(self, W: Tensor) -> RandomEffectModel:
        return RandomEffectModel(
            re_type=self.re_type, shard_id=self.shard_id,
            means=self.norm.model_to_original_space(W))

    def train_model(self, offsets,
                    initial: Optional[RandomEffectModel] = None
                    ) -> RandomEffectModel:
        W = self._prepare_table(initial)
        offsets = self._offsets(offsets)
        led = obs.ledger()
        mx = obs.metrics()
        for i, wave in enumerate(self._waves):
            t_wave = time.perf_counter()
            # One span per wave; it times the host's side (the solver's
            # own host reads included), not the card's work after them.
            with obs.span("re.fit_wave", cat="train", wave=i,
                          re_type=self.re_type):
                w0 = re_rows.gather_rows(W, wave.rows)
                re_rows.scatter_rows_(W, wave.rows,
                                      self._solve(wave, offsets, w0))
            lanes = self._lanes[i]
            if mx is not None:
                mx.counter("photon_re_entities_refit_total",
                           re_type=self.re_type).inc(lanes)
            if led is not None:
                led.record("re_fit_wave", re_type=self.re_type, wave=i,
                           seconds=round(time.perf_counter() - t_wave, 6),
                           entities_fit=lanes, entities_skipped=0)
        return self._finish_model(W)

    def compute_model_variances(self, model: RandomEffectModel,
                                offsets) -> RandomEffectModel:
        """Per-entity coefficient variances at the trained optimum,
        scattered into a fresh (E, d) table."""
        if VarianceComputationType(self.config.variance_computation) == \
                VarianceComputationType.NONE:
            return model
        W = self._table(model)
        V = torch.zeros_like(W)
        offsets = self._offsets(offsets)
        for wave in self._waves:
            w_opt = re_rows.gather_rows(W, wave.rows)
            re_rows.scatter_rows_(V, wave.rows,
                                  self._variances(wave, offsets, w_opt))
        if not self.norm.is_identity:
            V = self.norm.variances_to_original_space(V)
        return dataclasses.replace(model, variances=V)

    def score(self, model: RandomEffectModel) -> Tensor:
        """(n,) Σ_d X[i, d] · W[e_i, d] over the staged shard."""
        means = model.means.to(self.device)
        return torch.sum(self._X * means[self._ids], dim=-1)

    def initial_model(self) -> RandomEffectModel:
        return RandomEffectModel(
            re_type=self.re_type, shard_id=self.shard_id,
            means=torch.zeros((self.num_entities, self.dim),
                              dtype=torch.float32, device=self.device))
