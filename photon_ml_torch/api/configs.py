"""Coordinate data/optimization configuration bundles.

Port of the coordinate configurations of ``photon_ml_tpu/api/configs.py``
for the coordinate types the port has: dense and sparse fixed effects and
the random effect, unprojected, projected (``projector="INDEX_MAP"``) or
in its subspace form. Reference parity: photon-api
``data/FixedEffectDataConfiguration.scala``,
``data/RandomEffectDataConfiguration.scala`` and the per-coordinate
optimization bundles of ``optimization/game/*Configuration.scala``.

``StreamingConfig`` routes sparse fixed effects onto the row-streamed
path, and ``StagingConfig`` (``game/staging.py``) tunes the projected
random effect's staging pipeline. The factored random-effect
configuration is here so that the estimator can name the slice that
ports it. The CLI mini-DSL parsers (``parse_kv``,
``parse_staging_config``, ``parse_streaming_config``,
``parse_optimizer_config``) are the reference's; the ingest and sweep
configurations are not ported, so their parsers raise and name the slice
that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from photon_ml_torch import not_ported
from photon_ml_torch.game.staging import StagingConfig
from photon_ml_torch.optim.common import OptimizerConfig, OptimizerType
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)

__all__ = [
    "CoordinateConfiguration",
    "CoordinateDataConfiguration",
    "FactoredRandomEffectDataConfiguration",
    "FixedEffectDataConfiguration",
    "RandomEffectDataConfiguration",
    "StagingConfig",
    "StreamingConfig",
    "parse_ingest_config",
    "parse_kv",
    "parse_optimizer_config",
    "parse_staging_config",
    "parse_streaming_config",
    "parse_sweep_config",
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

    ``projector="NONE"`` solves at the full shard dimension,
    ``"INDEX_MAP"`` in each entity's active-column subspace (implied by a
    ``features_to_samples_ratio`` or a sparse shard); ``"RANDOM"`` raises
    in the estimator (slice 8). ``subspace_model`` keeps the trained table
    as (E, A) active-column rows (None: automatic above E·d > 2²⁸).
    ``feature_dtype`` "bfloat16" stores the bucket blocks in bfloat16."""

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


def parse_kv(spec: str) -> dict[str, str]:
    """Parse the ``key=value,...`` mini-DSL used by reference-style config
    strings (shared by optimizer configs and CLI coordinate specs)."""
    kv: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError(f"bad config token {part!r} in {spec!r}")
        kv[k.strip()] = v.strip()
    return kv


def parse_staging_config(spec: str) -> StagingConfig:
    """Parse ``key=value,...`` mini-DSL for the random-effect staging
    pipeline (game/staging.py).

    Keys: workers (pool size; default = host cores), mode
    (thread|process), depth (max staged-but-unconsumed shard blocks),
    shard_entities (entity lanes per staged shard), retries (bounded
    per-shard retry budget), backoff (base seconds of the jittered
    retry backoff), straggler (straggler deadline in seconds — exceeded
    shards re-stage serially).
    """
    kv = parse_kv(spec)
    known = {"workers", "mode", "depth", "shard_entities", "retries",
             "backoff", "straggler"}
    unknown = set(kv) - known
    if unknown:
        raise ValueError(f"unknown staging keys {sorted(unknown)}; "
                         f"expected {sorted(known)}")
    defaults = StagingConfig()
    return StagingConfig(
        workers=int(kv["workers"]) if "workers" in kv else None,
        mode=kv.get("mode", "thread").lower(),
        pipeline_depth=int(kv["depth"]) if "depth" in kv else None,
        shard_entities=(int(kv["shard_entities"])
                        if "shard_entities" in kv else None),
        max_retries=(int(kv["retries"]) if "retries" in kv
                     else defaults.max_retries),
        retry_backoff_s=(float(kv["backoff"]) if "backoff" in kv
                         else defaults.retry_backoff_s),
        straggler_timeout_s=(float(kv["straggler"])
                             if "straggler" in kv else None),
    )


def parse_ingest_config(spec: str):
    """The parallel Avro ingestion mini-DSL: not ported (slice 9)."""
    raise not_ported("parallel Avro ingestion (--ingest)", 9)


def parse_streaming_config(spec: str) -> StreamingConfig:
    """Parse ``key=value,...`` mini-DSL for the row-streamed fixed-effect
    path (docs/STREAMING.md). An empty spec (bare ``--streaming``) takes
    every default.

    Keys: chunk_rows (rows per streamed chunk), num_hot (hot-dense
    columns per chunk), dtype (float32|bfloat16|int8 chunk storage;
    default inherits the coordinate's dtype), depth (prefetch transfers
    in flight), pin (leading chunks pinned on the device), workers
    (staging canonicalization threads), solver (lbfgs|sdca|sgd; the
    stochastic solvers raise in the estimator, slice 7).
    """
    kv = parse_kv(spec)
    known = {"chunk_rows", "num_hot", "dtype", "depth", "pin", "workers",
             "solver"}
    unknown = set(kv) - known
    if unknown:
        raise ValueError(f"unknown streaming keys {sorted(unknown)}; "
                         f"expected {sorted(known)}")
    defaults = StreamingConfig()
    return StreamingConfig(
        chunk_rows=(int(kv["chunk_rows"]) if "chunk_rows" in kv
                    else defaults.chunk_rows),
        num_hot=int(kv["num_hot"]) if "num_hot" in kv else defaults.num_hot,
        feature_dtype=kv["dtype"].lower() if "dtype" in kv else None,
        prefetch_depth=(int(kv["depth"]) if "depth" in kv
                        else defaults.prefetch_depth),
        pin_chunks=int(kv["pin"]) if "pin" in kv else defaults.pin_chunks,
        workers=int(kv["workers"]) if "workers" in kv else None,
        solver=(kv["solver"].lower() if "solver" in kv
                else defaults.solver),
    )


def parse_sweep_config(spec: str):
    """The dirty-gated sweep mini-DSL: not ported (slice 8)."""
    raise not_ported("dirty-gated incremental sweeps (--sweep)", 8)


def parse_optimizer_config(spec: str) -> GLMOptimizationConfiguration:
    """Parse ``key=value,...`` mini-DSL (reference-style config strings).

    Keys: optimizer (LBFGS|OWLQN|TRON), max_iter, tolerance,
    reg (NONE|L1|L2|ELASTIC_NET), reg_weight, alpha, down_sampling_rate,
    variance (NONE|SIMPLE|FULL). Other keys are ignored, as in the
    reference.
    """
    kv = parse_kv(spec)

    opt = OptimizerConfig(
        optimizer_type=OptimizerType(kv.get("optimizer", "LBFGS").upper()),
        max_iterations=int(kv.get("max_iter", 100)),
        tolerance=float(kv.get("tolerance", 1e-7)),
    )
    reg = RegularizationContext(
        reg_type=RegularizationType(kv.get("reg", "NONE").upper()),
        reg_weight=float(kv.get("reg_weight", 0.0)),
        elastic_net_alpha=float(kv.get("alpha", 0.5)),
    )
    return GLMOptimizationConfiguration(
        optimizer=opt,
        regularization=reg,
        variance_computation=VarianceComputationType(
            kv.get("variance", "NONE").upper()),
        down_sampling_rate=float(kv.get("down_sampling_rate", 1.0)),
    )
