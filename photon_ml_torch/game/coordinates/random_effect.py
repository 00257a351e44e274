"""Random-effect coordinate: per-entity solves over padded entity buckets,
dense or subspace-projected, with optional sparse-shard input.

Port of ``photon_ml_tpu/game/coordinates/random_effect.py``. Entities are
grouped into power-of-two capacity buckets (``game/buckets.py``); each
bucket is cut into waves of at most ``LANE_CHUNK`` entity lanes, and each
wave runs one lane-batched L-BFGS / OWL-QN / TRON solve (one lane per
entity) between two row moves over the coefficient table. Padding lanes
(row −1) solve on all-zero weights, and the row moves drop their results.

Three layouts of that table, chosen in ``__init__``:

- **Unprojected** (E, d), solved at the full shard width in the shard's
  normalization-transformed space:

      w0 = gather_rows(W, rows)                    # kernel
      scatter_rows_(W, rows, solve(w0))            # kernel, in place

- **Projected** (``projection=True``, implied by a sparse shard or a
  ``features_to_samples_ratio``): each bucket is staged at d_active ≪ d,
  the union of the columns its entities use (``game/projector.py``), by
  the parallel staging pipeline (``game/staging.py``), whose shards the
  fit stream puts on the device as they arrive. The solve runs at
  d_active with a PER-LANE normalization context (factors and shifts of
  shape (B, d_active), the intercept at slot 0); the (E, d) table stays
  in ORIGINAL space. Warm starts are gathered through each entity's
  column map, and each trained entity's full row is zeroed and written
  back through it (projectBackward), both as torch index ops: the
  reference leaves these two moves to XLA too.
- **Subspace** (``subspace_model``; automatic above E·d > 2²⁸): the
  table is (E, A), each entity's row in its own active-column order,
  A the widest bucket's d_active, so (E, d) never exists. An entity's
  table row IS its bucket row, so the two moves are the unprojected
  path's kernels at d = A:

      w0 = gather_rows(W, rows)[:, :d_active]                # kernel
      scatter_rows_(W, rows, [solve(w0), 0 … 0])             # kernel

  The public ``SubspaceRandomEffectModel`` sorts each row by column id
  (``sort_subspace_rows``); ``perm``/``inv_perm`` carry the table between
  that layout and the bucket layout (``torch.gather``). A sparse shard's
  scores come from a staged join of its nonzeros into flat (E, A)
  positions (``_subspace_positions``).

Under ``feature_dtype="bfloat16"`` the waves' feature blocks are stored
in bfloat16, cast after staging (the staging cache stays float32), as
the reference casts its bucket blocks; the solves accumulate in float32
(``ops/aggregators.py``).

Each wave is a ``re.fit_wave`` span when tracing is on, adds its live
lanes to ``photon_re_entities_refit_total{re_type=}`` and records a
``re_fit_wave`` ledger row; the lane counts come from the host's copy of
the bucketing, never from the card. The staging pipeline emits the
``Staging*`` events (the ``staging`` span and
``photon_staging_{shards,retries,stragglers}_total``).

Not ported yet, each raising if asked for: factored warm starts (slice
8), gated sweeps with their segment rescore and Gram fits (slice 8), and
the staging pipeline's fault-injection sites (slice 10).
"""

from __future__ import annotations

import copy
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
from photon_ml_torch.game import staging as stg
from photon_ml_torch.game import staging_cache
from photon_ml_torch.game.models import (RandomEffectModel,
                                         SubspaceRandomEffectModel,
                                         _subspace_positions,
                                         sort_subspace_rows)
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
# temporaries scale with lanes. Shared with the staging pipeline, so a
# staged shard is one wave.
LANE_CHUNK = stg.LANE_CHUNK
# Every bucket's entity count is padded to a multiple of this: the
# reference's max(8, devices) on one device.
ENTITY_PAD_MULTIPLE = 8
# Above this many (E, d) entries a projected coordinate keeps its table
# in subspace form (≈ 1 GiB of float32), as the reference does.
SUBSPACE_AUTO_ENTRIES = 1 << 28

# The capping generator's seed: the reference coordinate's default, which
# its staging-cache key carries.
_SEED = 0
# Sentinel telling "use the coordinate's intercept" from an explicit None.
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class _Wave:
    """One wave's staged tensors: lanes (B,) of one bucket, cap rows each.
    A projected wave also carries its column map and, under
    normalization, its lanes' projected factors and shifts."""

    X: Tensor  # (B, cap, d or d_active) features, float32 or bfloat16
    y: Tensor  # (B, cap) labels
    w: Tensor  # (B, cap) weights, 0 on padding slots
    ex: Tensor  # (B, cap) int64 example rows, padding slots read row 0
    rows: Tensor  # (B,) int32 entity rows, −1 on padding lanes
    cols: Optional[Tensor] = None  # (B, d_active) int64 columns, −1 pad
    f: Optional[Tensor] = None  # (B, d_active) projected factors
    s: Optional[Tensor] = None  # (B, d_active) projected shifts


class RandomEffectCoordinate:
    """Per-entity GLMs trained as lane-batched bucket solves.

    Reference parity: RandomEffectCoordinate + SingleNodeOptimizationProblem
    (a local L-BFGS per entity); here all entities of a wave solve at once,
    each lane stopping on its own. ``projection=True`` enables the
    per-entity feature-subspace projector (reference:
    LinearSubspaceProjector + IndexMapProjectorRDD).

    Model-space contract: a RandomEffectModel's rows are ORIGINAL-space,
    so scoring is the plain gather and rowwise dot; the unprojected solves
    run in the shard's normalization-transformed space, the projected ones
    in each entity's own projected transform.

    The dataset stays host numpy. ``__init__`` buckets the entities
    (``rng`` draws the capping of ``upper_bound``; by default the
    reference's generator, seed 0, the one a staging cache keys on) and
    stages on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``): eagerly on
    the unprojected path, through the staging pipeline otherwise, which
    keeps projecting while the first waves fit. ``wait_staged()`` drains
    it (and every staging-cache write) without fitting.
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
                 staging: Optional[stg.StagingConfig] = None,
                 device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        # Before staging: at flagship scale the projection pass costs
        # tens of seconds, and a typo'd dtype must not pay it first.
        self._block_dtype = check_feature_dtype(feature_dtype) \
            or torch.float32
        shard = dataset.feature_shards[shard_id]
        self.is_sparse = isinstance(shard, SparseShard)
        if self.is_sparse:
            # Large-d per-entity sparse features are exactly the projected
            # regime: the dense (n, d) shard never exists, buckets stage
            # at d_active ≪ d straight from the ELL triplets.
            projection = True
            if not norm.is_identity:
                raise ValueError(
                    f"normalization is not supported on sparse random-"
                    f"effect shard {shard_id!r} (scaling sparse values "
                    f"would densify shift terms)")
        if rng is not None and staging_cache_dir:
            raise ValueError("the staging cache keys on the default "
                             "capping generator (seed 0): pass no rng")
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
            rng=np.random.default_rng(_SEED) if rng is None else rng)
        # A ratio (Pearson feature filtering) selects per-entity columns,
        # which is what the projection stages, so it implies projection.
        self.features_to_samples_ratio = features_to_samples_ratio
        self.projection = bool(projection) or \
            features_to_samples_ratio is not None
        if subspace_model is None:
            subspace_model = (self.projection and self.num_entities
                              * self.dim > SUBSPACE_AUTO_ENTRIES)
        if subspace_model and not self.projection:
            raise ValueError(
                "subspace_model=True requires projection=True (the "
                "subspace IS the per-entity projection)")
        self.subspace = bool(subspace_model)
        self.staging = staging or stg.StagingConfig()
        # Projected intercept slot: the projector pins it to 0.
        self._ii_proj = 0 if self.intercept_index is not None else None

        self._ids = self._put(ids, torch.int64)
        if self.is_sparse:
            self._sp_indices = self._put(shard.indices, torch.int32)
            self._sp_values = self._put(shard.values, torch.float32)
            self._X = None
        else:
            self._X = self._put(shard, torch.float32)
        self._waves: list[_Wave] = []
        # Live (non-padding) lanes of each wave, counted on the host.
        self._lanes: list[int] = []
        self._pending = None
        self._stager: Optional[stg.ProjectionStager] = None
        self._has_f = self._has_s = False
        if self.projection:
            sub = self._start_staging(dataset, shard, norm, lower_bound,
                                      upper_bound, staging_cache_dir)
        else:
            self._stage_unprojected(dataset)
        if self.subspace:
            self._adopt_subspace(sub)

    # -- staging ------------------------------------------------------------

    def _put(self, a, dtype) -> Tensor:
        """A host array on the device. A read-only array (a staging-cache
        map) is copied first: the transfer reads the copy, and nothing
        ever writes through the map."""
        a = np.asarray(a)
        if not a.flags.writeable:
            a = np.array(a)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _stage_unprojected(self, dataset: GameDataset) -> None:
        y = self._put(dataset.response, torch.float32)
        wts = self._put(dataset.weights, torch.float32)
        for b in self.bucketing.buckets:
            for lo in range(0, b.num_entities, LANE_CHUNK):
                hi = lo + LANE_CHUNK
                ex_host = b.example_idx[lo:hi]
                ex = self._put(np.maximum(ex_host, 0), torch.int64)
                wb = wts[ex]
                wb[self._put(ex_host < 0, torch.bool)] = 0.0
                self._waves.append(_Wave(
                    X=self._X[ex].to(self._block_dtype), y=y[ex], w=wb,
                    ex=ex, rows=self._put(b.entity_rows[lo:hi],
                                          torch.int32)))
                self._lanes.append(int((b.entity_rows[lo:hi] >= 0).sum()))

    def _start_staging(self, dataset, shard, norm, lower_bound,
                       upper_bound, staging_cache_dir) -> dict:
        """Start the staging pipeline; on the subspace path also build
        (or load from the cache) the (E, A) column table, which waits on
        phase A of every shard only."""
        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        # Shifts without factors cannot come from build_normalization;
        # give the manual case factors of 1 so the solve has one layout.
        f_full, s_full = host(norm.factors), host(norm.shifts)
        if s_full is not None and f_full is None:
            f_full = np.ones_like(s_full)
        self._has_f, self._has_s = f_full is not None, s_full is not None
        key = None
        if staging_cache_dir:
            key = staging_cache.staging_key(
                dataset, norm, re_type=self.re_type, shard_id=self.shard_id,
                lower_bound=lower_bound, upper_bound=upper_bound,
                seed=_SEED, pad=ENTITY_PAD_MULTIPLE,
                ratio=self.features_to_samples_ratio,
                intercept=self.intercept_index, subspace=self.subspace,
                num_entities=self.num_entities, dim=self.dim,
                shard_entities=stg.resolved_shard_entities(
                    self.staging, ENTITY_PAD_MULTIPLE))
        self._stager = stg.ProjectionStager(
            bucketing=self.bucketing, X=shard,
            response=np.asarray(dataset.response),
            weights=np.asarray(dataset.weights),
            intercept_index=self.intercept_index,
            features_to_samples_ratio=self.features_to_samples_ratio,
            factors=f_full, shifts=s_full, config=self.staging,
            cache_dir=staging_cache_dir, cache_key=key,
            expect_subspace=self.subspace,
            label=f"{self.re_type}:{self.shard_id}")
        self._pending = self._stager.shards()
        if not self.subspace:
            return {}
        sub = self._stager.cached_subspace()
        if sub is not None and self.is_sparse and "flat" not in sub:
            sub = None  # an incomplete record: recompute
        if sub is None:
            # Each entity lives in exactly one bucket, so its table row is
            # its bucket row padded to the widest bucket's d_active.
            shard_cols = self._stager.cols_list()
            A = max((c.shape[1] for c in shard_cols), default=1)
            cols_tab = np.full((self.num_entities, A), -1, np.int32)
            for (bi, lo, hi), c in zip(self._stager.plan, shard_cols):
                rows_s = self.bucketing.buckets[bi].entity_rows[lo:hi]
                live = rows_s >= 0
                cols_tab[rows_s[live], :c.shape[1]] = c[live]
            cols_sorted, perm = sort_subspace_rows(cols_tab)
            sub = {"cols": cols_sorted, "perm": perm}
            if self.is_sparse:
                # The score-side join, once: data nonzeros → flat slots of
                # the (E, A) table (E·A = a miss → 0). Stored as the
                # reference stores it, so either package reads the entry.
                flat = _subspace_positions(
                    cols_sorted, self.dim,
                    np.asarray(dataset.entity_ids[self.re_type]),
                    np.asarray(shard.indices))
                sub["flat"] = flat.astype(
                    np.int32 if cols_sorted.size < 2**31 - 1 else np.int64)
        self._stager.set_subspace(sub)
        return sub

    def _adopt_subspace(self, sub: dict) -> None:
        cols_sorted = np.asarray(sub["cols"])
        perm = np.asarray(sub["perm"])
        self.subspace_cols = cols_sorted
        self._cols_dev = self._put(cols_sorted, torch.int32)
        self._perm_dev = self._put(perm, torch.int64)
        self._inv_perm_dev = self._put(
            np.argsort(perm, axis=1, kind="stable"), torch.int64)
        if self.is_sparse:
            # Torch indexes in int64 whatever the table's size, so the flat
            # positions go to the device as int64: the reference's refusal
            # of positions past 2³¹ (its device arrays are int32) has no
            # cause here.
            self._sp_flatpos = self._put(sub["flat"], torch.int64)
            # The raw column ids only serve the full-table score.
            self._sp_indices = None

    def _stage_host_tuple(self, arrays) -> None:
        """One staged shard (Xb, yb, wb, ex, rows, cols[, f][, s]) onto
        the device as waves of at most LANE_CHUNK lanes (a default shard
        is exactly one)."""
        Xb, yb, wb, ex, rows, cols = arrays[:6]
        extra = list(arrays[6:])
        f = extra.pop(0) if self._has_f else None
        s = extra.pop(0) if self._has_s else None
        pad = ENTITY_PAD_MULTIPLE
        chunk = ((LANE_CHUNK + pad - 1) // pad) * pad
        for lo in range(0, rows.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            rows_h = np.asarray(rows[sl])

            def opt(a):
                return None if a is None else self._put(a[sl],
                                                        torch.float32)

            self._waves.append(_Wave(
                X=self._put(Xb[sl], torch.float32).to(self._block_dtype),
                y=self._put(yb[sl], torch.float32),
                w=self._put(wb[sl], torch.float32),
                ex=self._put(np.maximum(ex[sl], 0), torch.int64),
                rows=self._put(rows_h, torch.int32),
                cols=self._put(cols[sl], torch.int64), f=opt(f), s=opt(s)))
            self._lanes.append(int((rows_h >= 0).sum()))

    def _iter_waves(self):
        """The fit stream: waves already on the device first, then — on
        the first full pass — the remaining pipeline shards in plan order,
        put on the device as each arrives. While the card fits shard i the
        workers still project shards > i. One consumer at a time
        (coordinate descent trains coordinates in turn)."""
        i = 0
        while True:
            if i < len(self._waves):
                yield i, self._waves[i]
                i += 1
                continue
            if self._pending is None:
                return
            try:
                host = next(self._pending)
            except StopIteration:
                self._pending = None
                return
            self._stage_host_tuple(host)

    def wait_staged(self) -> "RandomEffectCoordinate":
        """Barrier: drain the staging pipeline onto the device without
        fitting anything, and wait for every staging-cache write."""
        for _ in self._iter_waves():
            pass
        if self._stager is not None:
            self._stager.join()
        return self

    @property
    def dim(self) -> int:
        return self.dataset.shard_dim(self.shard_id)

    @property
    def num_waves(self) -> int:
        """Bucket waves per ``train_model``: on the unprojected and the
        subspace path each launches one gather and one scatter."""
        if self._stager is None:
            return len(self._waves)
        pad = ENTITY_PAD_MULTIPLE
        chunk = ((LANE_CHUNK + pad - 1) // pad) * pad
        return sum(-(-(hi - lo) // chunk) for _, lo, hi in self._stager.plan)

    @property
    def wave_rows(self) -> list[Tensor]:
        """Each wave's (B,) int32 entity rows on the device (−1 lanes are
        padding): the row ids the row movers are given."""
        return [wave.rows for _, wave in self._iter_waves()]

    def with_optimization_config(
            self, config: GLMOptimizationConfiguration
    ) -> "RandomEffectCoordinate":
        """Cheap copy with a new optimization config, reusing the
        bucketing and the staged waves."""
        c = copy.copy(self)
        c.config = config
        return c

    # -- solves --------------------------------------------------------------

    def _batch(self, wave: _Wave, offsets: Tensor) -> LabeledBatch:
        return LabeledBatch(wave.X, wave.y, wave.w, offsets[wave.ex])

    def _lane_norm(self, wave: _Wave) -> NormalizationContext:
        """A projected wave's per-lane context: (B, d_active) factors and
        shifts, the intercept at slot 0."""
        if wave.f is None:
            return NormalizationContext()
        return NormalizationContext(factors=wave.f, shifts=wave.s,
                                    intercept_index=self._ii_proj)

    def _solve(self, wave: _Wave, offsets: Tensor, w0: Tensor,
               norm=None, intercept_index=_UNSET) -> Tensor:
        """Every lane's GLM solve in transformed space: (B, width) fits."""
        norm = self.norm if norm is None else norm
        ii = self.intercept_index if intercept_index is _UNSET \
            else intercept_index
        vg, hvp, l1w = make_objective(
            self.loss, self._batch(wave, offsets), norm,
            self.config.regularization, ii, wave.X.shape[-1])
        opt_cfg = resolve_optimizer_config(self.config.optimizer,
                                           l1w is not None)
        return optimize(vg, w0, opt_cfg, hvp=hvp, l1_weights=l1w).w

    def _solve_projected(self, wave: _Wave, offsets: Tensor,
                         w0_orig: Tensor) -> Tensor:
        """A projected wave's solves; original space in and out."""
        ctx = self._lane_norm(wave)
        w_t = self._solve(wave, offsets,
                          ctx.model_to_transformed_space(w0_orig), ctx,
                          self._ii_proj)
        return ctx.model_to_original_space(w_t)

    def _variances(self, wave: _Wave, offsets: Tensor, w_opt: Tensor,
                   norm=None, intercept_index=_UNSET) -> Tensor:
        """Variances at the trained optimum (no re-solve; reference
        computeVariances evaluates the Hessian at the model
        coefficients)."""
        norm = self.norm if norm is None else norm
        ii = self.intercept_index if intercept_index is _UNSET \
            else intercept_index
        return compute_variances(
            self.loss, w_opt, self._batch(wave, offsets), norm,
            self.config.variance_computation, self.config.regularization,
            ii)

    def _variances_projected(self, wave: _Wave, offsets: Tensor,
                             w_orig: Tensor) -> Tensor:
        ctx = self._lane_norm(wave)
        var_t = self._variances(wave, offsets,
                                ctx.model_to_transformed_space(w_orig), ctx,
                                self._ii_proj)
        return ctx.variances_to_original_space(var_t)

    # -- the projected path's moves through the column maps -------------------

    @staticmethod
    def _through_cols(W: Tensor, wave: _Wave) -> Tensor:
        """(B, d_active) entries of W at each lane's columns; 0 at padding
        columns (padding lanes read row 0)."""
        cols = wave.cols
        w = W[wave.rows.clamp(min=0).long()[:, None], cols.clamp(min=0)]
        return torch.where(cols >= 0, w, 0.0)

    @staticmethod
    def _set_through_cols(W: Tensor, wave: _Wave, vals: Tensor,
                          zero_rows: bool) -> None:
        """projectBackward in place: live lanes' entries at their columns;
        with ``zero_rows`` a trained entity's FULL row is zeroed first, so
        inactive-column mass from an unprojected warm start cannot
        survive."""
        live = wave.rows >= 0
        rows = wave.rows.long()
        if zero_rows:
            W.index_fill_(0, rows[live], 0.0)
        sel = (wave.cols >= 0) & live[:, None]
        W.index_put_((rows[:, None].expand_as(wave.cols)[sel],
                      wave.cols[sel]), vals[sel])

    @staticmethod
    def _padded(vals: Tensor, width: int) -> Tensor:
        """(B, d_active) → (B, width): the whole-row set leaves the tail
        past d_active at zero."""
        return torch.nn.functional.pad(vals, (0, width - vals.shape[1]))

    def _fit_wave(self, W: Tensor, wave: _Wave, offsets: Tensor) -> None:
        if wave.cols is None:
            w0 = re_rows.gather_rows(W, wave.rows)
            re_rows.scatter_rows_(W, wave.rows,
                                  self._solve(wave, offsets, w0))
        elif self.subspace:
            da = wave.cols.shape[1]
            w0 = re_rows.gather_rows(W, wave.rows)[:, :da]
            w_fit = self._solve_projected(wave, offsets, w0)
            re_rows.scatter_rows_(W, wave.rows,
                                  self._padded(w_fit, W.shape[1]))
        else:
            w_fit = self._solve_projected(wave, offsets,
                                          self._through_cols(W, wave))
            self._set_through_cols(W, wave, w_fit, zero_rows=True)

    # -- tables and models ----------------------------------------------------

    def adapt_initial(self, initial):
        """A warm start in this coordinate's layout. In subspace mode a
        dense table is gathered into the (E, A) active columns, and a
        subspace model over other active sets is remapped per entity by
        a batched ``searchsorted`` (coefficients of columns no longer
        active are dropped, never misattributed — projectBackward)."""
        if not isinstance(initial, (RandomEffectModel,
                                    SubspaceRandomEffectModel)):
            raise not_ported(f"a {type(initial).__name__} warm start", 8)
        if not self.subspace:
            if isinstance(initial, SubspaceRandomEffectModel):
                return initial.to_random_effect_model()
            return initial
        E = self.subspace_cols.shape[0]
        if isinstance(initial, SubspaceRandomEffectModel):
            if initial.cols.shape[0] != E:
                raise ValueError(
                    f"subspace warm start has {initial.cols.shape[0]} "
                    f"entities, coordinate expects {E}")
            if initial.num_features != self.dim:
                raise ValueError(
                    f"subspace warm start has {initial.num_features} "
                    f"features, coordinate expects {self.dim} (the "
                    f"searchsorted sentinels would collide with real "
                    f"column ids)")
            if np.array_equal(initial.cols.cpu().numpy(),
                              self.subspace_cols):
                return initial
            src_c = initial.cols.to(self.device, torch.int64)
            src_s = torch.where(src_c < 0, self.dim + 1, src_c).contiguous()
            tgt = self._cols_dev.long()
            tgt_q = torch.where(tgt < 0, self.dim + 2, tgt).contiguous()
            pos = torch.searchsorted(src_s, tgt_q)
            posc = pos.clamp(max=src_c.shape[1] - 1)
            hit = torch.gather(src_s, 1, posc) == tgt_q
            means = torch.where(hit, torch.gather(
                initial.means.to(self.device, torch.float32), 1, posc), 0.0)
            return SubspaceRandomEffectModel(
                re_type=self.re_type, shard_id=self.shard_id,
                num_features=self.dim, cols=self._cols_dev, means=means)
        if tuple(initial.means.shape) != (E, self.dim):
            raise ValueError(
                f"warm start is {tuple(initial.means.shape)}, the "
                f"coordinate expects ({E}, {self.dim}) (a clamped gather "
                f"would misattribute rows or columns)")
        cols = self._cols_dev.long()
        means = initial.means.to(self.device, torch.float32)
        ga = torch.where(cols >= 0,
                         torch.gather(means, 1, cols.clamp(min=0)), 0.0)
        return SubspaceRandomEffectModel(
            re_type=self.re_type, shard_id=self.shard_id,
            num_features=self.dim, cols=self._cols_dev, means=ga)

    def _check_dense(self, model: RandomEffectModel) -> None:
        if tuple(model.means.shape) != (self.num_entities, self.dim):
            raise ValueError(f"warm start is {tuple(model.means.shape)}, "
                             f"the coordinate expects "
                             f"({self.num_entities}, {self.dim})")

    def _prepare_table(self, initial) -> Tensor:
        """The table the waves fit into, always a fresh contiguous copy:
        the moves write in place, and the caller still holds (and has
        scored) ``initial``. Unprojected: transformed space. Projected:
        original space (the transforms are per entity, inside the wave).
        Subspace: (E, A) in bucket layout (intercept slot 0)."""
        if initial is None:
            shape = (self.subspace_cols.shape if self.subspace
                     else (self.num_entities, self.dim))
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)
        initial = self.adapt_initial(initial)
        if self.subspace:
            return torch.gather(
                initial.means.to(self.device, torch.float32), 1,
                self._inv_perm_dev)
        self._check_dense(initial)
        W = initial.means.to(self.device, torch.float32, copy=True)
        if self.projection:
            return W.contiguous()
        return self.norm.model_to_transformed_space(W).contiguous()

    def _finish_model(self, W: Tensor):
        """Trained table (bucket space) → the public model."""
        if self.subspace:
            return SubspaceRandomEffectModel(
                re_type=self.re_type, shard_id=self.shard_id,
                num_features=self.dim, cols=self._cols_dev,
                means=torch.gather(W, 1, self._perm_dev))
        return RandomEffectModel(
            re_type=self.re_type, shard_id=self.shard_id,
            means=W if self.projection
            else self.norm.model_to_original_space(W))

    def _offsets(self, offsets) -> Tensor:
        return torch.as_tensor(offsets, dtype=torch.float32,
                               device=self.device)

    def train_model(self, offsets, initial=None):
        W = self._prepare_table(initial)
        offsets = self._offsets(offsets)
        led = obs.ledger()
        mx = obs.metrics()
        for i, wave in self._iter_waves():
            t_wave = time.perf_counter()
            # One span per wave; it times the host's side (the solver's
            # own host reads included), not the card's work after them.
            with obs.span("re.fit_wave", cat="train", wave=i,
                          re_type=self.re_type):
                self._fit_wave(W, wave, offsets)
            lanes = self._lanes[i]
            if mx is not None:
                mx.counter("photon_re_entities_refit_total",
                           re_type=self.re_type).inc(lanes)
            if led is not None:
                led.record("re_fit_wave", re_type=self.re_type, wave=i,
                           seconds=round(time.perf_counter() - t_wave, 6),
                           entities_fit=lanes, entities_skipped=0)
        return self._finish_model(W)

    def compute_model_variances(self, model, offsets):
        """Per-entity coefficient variances at the trained optimum,
        written into a fresh table of the model's shape."""
        if VarianceComputationType(self.config.variance_computation) == \
                VarianceComputationType.NONE:
            return model
        means = model.means.to(self.device, torch.float32)
        if self.subspace:
            W = torch.gather(means, 1, self._inv_perm_dev)
        elif self.projection:
            self._check_dense(model)
            W = means
        else:
            self._check_dense(model)
            W = self.norm.model_to_transformed_space(means).contiguous()
        V = torch.zeros_like(W)
        offsets = self._offsets(offsets)
        for _, wave in self._iter_waves():
            if wave.cols is None:
                w_opt = re_rows.gather_rows(W, wave.rows)
                re_rows.scatter_rows_(
                    V, wave.rows, self._variances(wave, offsets, w_opt))
            elif self.subspace:
                da = wave.cols.shape[1]
                w_opt = re_rows.gather_rows(W, wave.rows)[:, :da]
                var = self._variances_projected(wave, offsets, w_opt)
                re_rows.scatter_rows_(V, wave.rows,
                                      self._padded(var, V.shape[1]))
            else:
                var = self._variances_projected(
                    wave, offsets, self._through_cols(W, wave))
                self._set_through_cols(V, wave, var, zero_rows=False)
        if not self.projection and not self.norm.is_identity:
            V = self.norm.variances_to_original_space(V)
        if self.subspace:
            V = torch.gather(V, 1, self._perm_dev)
        return dataclasses.replace(model, variances=V)

    def score(self, model) -> Tensor:
        """(n,) random-effect scores over the staged shard."""
        means = model.means.to(self.device, torch.float32)
        if self.subspace:
            if self.is_sparse:
                # The staged join: each nonzero's flat slot in the (E, A)
                # table, misses one past its end (a zero).
                flat = torch.cat([means.reshape(-1), means.new_zeros(1)])
                return torch.sum(self._sp_values * flat[self._sp_flatpos],
                                 dim=-1)
            cols = self._cols_dev.long()[self._ids]  # (n, A)
            xa = torch.where(cols >= 0,
                             torch.gather(self._X, 1, cols.clamp(min=0)), 0.0)
            return torch.sum(xa * means[self._ids], dim=-1)
        if self.is_sparse:
            # ELL padding slots carry value 0, so clamping their sentinel
            # index (== d) into range is exact.
            idx = self._sp_indices.long().clamp(max=means.shape[1] - 1)
            return torch.sum(self._sp_values * means[self._ids[:, None], idx],
                             dim=-1)
        return torch.sum(self._X * means[self._ids], dim=-1)

    def initial_model(self):
        if self.subspace:
            return SubspaceRandomEffectModel(
                re_type=self.re_type, shard_id=self.shard_id,
                num_features=self.dim, cols=self._cols_dev,
                means=torch.zeros(self.subspace_cols.shape,
                                  dtype=torch.float32, device=self.device))
        return RandomEffectModel(
            re_type=self.re_type, shard_id=self.shard_id,
            means=torch.zeros((self.num_entities, self.dim),
                              dtype=torch.float32, device=self.device))
