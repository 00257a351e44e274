"""Coordinate data/optimization configuration bundles.

Port of the coordinate configurations of ``photon_ml_tpu/api/configs.py``
for the coordinate types the port has: dense and sparse fixed effects and
the unprojected random effect. Reference parity: photon-api
``data/FixedEffectDataConfiguration.scala``,
``data/RandomEffectDataConfiguration.scala`` and the per-coordinate
optimization bundles of ``optimization/game/*Configuration.scala``.

The factored random-effect configuration is here so that the estimator
can name the slice that ports it; the streaming, staging, ingest and
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
]


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfiguration:
    """Reference: FixedEffectDataConfiguration (featureShardId).

    ``feature_sharded`` (sparse shards only) shards the coefficient
    dimension over a model mesh axis: slice 9 of the port.
    ``feature_dtype``: on-device feature storage; only float32 is ported.
    ``hybrid`` (sparse shards only): the hot-dense / cold-class layout.
    ``None`` = automatic, which on one device is the hybrid layout (slice
    4 of the port); ``False`` selects the ELL layout."""

    feature_shard_id: str
    feature_sharded: bool = False
    feature_dtype: str = "float32"
    hybrid: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """Reference: RandomEffectDataConfiguration (randomEffectType,
    featureShardId, active-data bounds, projector).

    Only ``projector="NONE"`` (solve at the full shard dimension) with
    float32 features is ported; the rest raises in the estimator."""

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
