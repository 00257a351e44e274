"""Coordinate data/optimization configuration bundles.

Port of the coordinate configurations of ``photon_ml_tpu/api/configs.py``
for the coordinate types the port has: dense and sparse fixed effects and
the unprojected random effect. Reference parity: photon-api
``data/FixedEffectDataConfiguration.scala``,
``data/RandomEffectDataConfiguration.scala`` and the per-coordinate
optimization bundles of ``optimization/game/*Configuration.scala``.

``StreamingConfig`` routes sparse fixed effects onto the row-streamed
path. The factored random-effect configuration is here so that the
estimator can name the slice that ports it; the staging, ingest and
sweep configurations and the CLI mini-DSL parsers come with the slices
that port their paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from photon_ml_torch.optim.problem import GLMOptimizationConfiguration

__all__ = [
    "CoordinateConfiguration",
    "CoordinateDataConfiguration",
    "FactoredRandomEffectDataConfiguration",
    "FixedEffectDataConfiguration",
    "RandomEffectDataConfiguration",
    "StreamingConfig",
]


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Row-streamed fixed-effect fit configuration (reference:
    ``photon_ml_tpu/api/configs.StreamingConfig``).

    Passed to ``GameEstimator(streaming=...)``, it routes sparse
    fixed-effect coordinates onto the streamed path: the SparseShard
    stages into host-resident hot-dense/cold-ELL chunks, and every L-BFGS
    value/gradient streams them through the device, so the row count is
    bounded by host memory, not device memory.

    ``chunk_rows``: rows per chunk, the streamed transfer unit.
    ``num_hot``: hot-dense columns per chunk (the Zipf head).
    ``feature_dtype``: chunk storage dtype; None inherits the
    coordinate's ``FixedEffectDataConfiguration.feature_dtype``. "int8"
    (symmetric per-column codes, float32 accumulation) quarters the
    host→device stream and "bfloat16" (the values rounded once, float32
    accumulation) halves it.
    ``prefetch_depth``: device buffers of the stream (copies in flight
    beside the compute). ``pin_chunks``: leading chunks kept on the
    device. ``workers``: staging threads (None = host cores).
    ``solver``: "lbfgs"; "sdca" and "sgd" (the stochastic solvers) are
    not ported yet (slice 7).
    """

    chunk_rows: int = 262144
    num_hot: int = 512
    feature_dtype: Optional[str] = None
    prefetch_depth: int = 2
    pin_chunks: int = 0
    workers: Optional[int] = None
    solver: str = "lbfgs"

    def __post_init__(self):
        if self.chunk_rows < 1:
            raise ValueError(
                f"chunk_rows must be >= 1, got {self.chunk_rows}")
        if self.num_hot < 1:
            raise ValueError(f"num_hot must be >= 1, got {self.num_hot}")
        if self.feature_dtype not in (None, "float32", "bfloat16",
                                      "int8"):
            raise ValueError(
                f"unsupported feature_dtype {self.feature_dtype!r}; "
                "expected float32, bfloat16, or int8")
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.pin_chunks < 0:
            raise ValueError(
                f"pin_chunks must be >= 0, got {self.pin_chunks}")
        if self.workers is not None and self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.solver not in ("lbfgs", "sdca", "sgd"):
            raise ValueError(
                f"unsupported streaming solver {self.solver!r}; "
                "expected lbfgs, sdca, or sgd")


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfiguration:
    """Reference: FixedEffectDataConfiguration (featureShardId).

    ``feature_sharded`` (sparse shards only) shards the coefficient
    dimension over a model mesh axis: slice 9 of the port.
    ``feature_dtype``: on-device feature storage, "float32" or "bfloat16"
    (half the bytes; products accumulate in float32): a dense shard's
    staged batch, or the hybrid layout's hot block (the ELL layout
    ignores it, as the reference's does); the default chunk dtype of a
    streamed coordinate.
    ``hybrid`` (sparse shards only): the hot-dense / cold-class layout.
    ``None`` = automatic, which on one device is the hybrid layout, as in
    the reference (and the ELL layout under ``feature_sharded``, slice 9);
    ``True`` asks for the hybrid layout and ``False`` for the ELL
    layout."""

    feature_shard_id: str
    feature_sharded: bool = False
    feature_dtype: str = "float32"
    hybrid: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """Reference: RandomEffectDataConfiguration (randomEffectType,
    featureShardId, active-data bounds, projector).

    Only ``projector="NONE"`` (solve at the full shard dimension) is
    ported; the rest raises in the estimator. ``feature_dtype``
    "bfloat16" stores the bucket blocks in bfloat16."""

    random_effect_type: str
    feature_shard_id: str
    active_data_lower_bound: int = 1
    active_data_upper_bound: Optional[int] = None
    projector: str = "NONE"
    projected_dimension: Optional[int] = None  # RANDOM only
    features_to_samples_ratio: Optional[float] = None
    subspace_model: Optional[bool] = None
    feature_dtype: str = "float32"

    def __post_init__(self):
        if self.projector.upper() not in ("NONE", "INDEX_MAP", "RANDOM"):
            raise ValueError(
                f"unknown projector {self.projector!r}; "
                "expected NONE, INDEX_MAP, or RANDOM")
        if self.feature_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unsupported feature_dtype {self.feature_dtype!r}; "
                "expected float32 or bfloat16")
        if self.projector.upper() == "RANDOM":
            if self.projected_dimension is None \
                    or self.projected_dimension < 1:
                raise ValueError(
                    "projector=RANDOM needs projected_dimension >= 1")
            if self.features_to_samples_ratio is not None:
                raise ValueError(
                    "features_to_samples_ratio composes with INDEX_MAP "
                    "projection, not RANDOM (the random projection space "
                    "has no per-feature identity to filter)")
        elif self.projected_dimension is not None:
            raise ValueError(
                "projected_dimension only applies to projector=RANDOM")
        if (self.features_to_samples_ratio is not None
                and not self.features_to_samples_ratio > 0):
            raise ValueError(
                f"features_to_samples_ratio must be > 0, got "
                f"{self.features_to_samples_ratio}")


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectDataConfiguration:
    """Reference: FactoredRandomEffectDataConfiguration (per-entity models
    in a shared rank-``rank`` subspace). Not ported: slice 8."""

    random_effect_type: str
    feature_shard_id: str
    rank: int = 4
    alternations: int = 2
    active_data_lower_bound: int = 1
    active_data_upper_bound: Optional[int] = None

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.alternations < 1:
            raise ValueError(
                f"alternations must be >= 1, got {self.alternations}")


CoordinateDataConfiguration = Union[FixedEffectDataConfiguration,
                                    RandomEffectDataConfiguration,
                                    FactoredRandomEffectDataConfiguration]


@dataclasses.dataclass(frozen=True)
class CoordinateConfiguration:
    """One coordinate: its data slice + optimization settings + an optional
    regularization-weight grid (the reference's GameEstimator loops over a
    Seq[GameOptimizationConfiguration] built from per-coordinate grids)."""

    data: CoordinateDataConfiguration
    optimization: GLMOptimizationConfiguration
    reg_weight_grid: tuple[float, ...] = ()

    def expand_grid(self) -> list[GLMOptimizationConfiguration]:
        if not self.reg_weight_grid:
            return [self.optimization]
        out = []
        for w in self.reg_weight_grid:
            reg = dataclasses.replace(self.optimization.regularization,
                                      reg_weight=w)
            out.append(dataclasses.replace(self.optimization,
                                           regularization=reg))
        return out
