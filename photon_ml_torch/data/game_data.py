"""GAME dataset: columnar examples with feature shards and entity keys.

Port of ``photon_ml_tpu/data/game_data.py`` (host numpy, as there).
Reference parity: photon-api ``data/GameDatum.scala`` and
``data/GameConverters.scala``: each feature shard is a dense (n, d_shard)
matrix or an ELL :class:`SparseShard`, and each random-effect type is an
int32 id column indexing an entity table. Examples keep a stable order,
so per-coordinate scores add elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SparseShard:
    """ELL sparse feature shard: padding slots carry index ==
    ``num_features`` and value 0."""

    indices: np.ndarray  # (n, max_nnz) int32, padding slot == num_features
    values: np.ndarray  # (n, max_nnz) float32
    num_features: int

    @property
    def shape(self) -> tuple[int, int]:
        return (int(self.indices.shape[0]), int(self.num_features))


@dataclasses.dataclass
class GameDataset:
    """Columnar GAME dataset (host-side numpy; device placement per use)."""

    response: np.ndarray  # (n,)
    offsets: np.ndarray  # (n,) base offsets from the data (prior scores)
    weights: np.ndarray  # (n,)
    # shard id -> (n, d_shard) dense matrix OR a SparseShard (ELL).
    feature_shards: dict[str, object]
    entity_ids: dict[str, np.ndarray]  # RE type -> (n,) int32 entity rows
    num_entities: dict[str, int]  # RE type -> entity-table size
    # Optional per-shard intercept column index.
    intercept_index: dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)

    @property
    def num_rows(self) -> int:
        return int(self.response.shape[0])

    def shard_dim(self, shard_id: str) -> int:
        shard = self.feature_shards[shard_id]
        if isinstance(shard, SparseShard):
            return int(shard.num_features)
        return int(shard.shape[1])

    def subset(self, idx: np.ndarray) -> "GameDataset":
        """Row subset (host-side)."""
        def _sub(shard):
            if isinstance(shard, SparseShard):
                return SparseShard(indices=shard.indices[idx],
                                   values=shard.values[idx],
                                   num_features=shard.num_features)
            return shard[idx]

        return GameDataset(
            response=self.response[idx],
            offsets=self.offsets[idx],
            weights=self.weights[idx],
            feature_shards={k: _sub(v)
                            for k, v in self.feature_shards.items()},
            entity_ids={k: v[idx] for k, v in self.entity_ids.items()},
            num_entities=dict(self.num_entities),
            intercept_index=dict(self.intercept_index),
        )


def from_synthetic(syn) -> GameDataset:
    """Adapter from data/synthetic.py SyntheticGameData."""
    shards = {"global": syn.X_global}
    ids = {}
    intercepts = {"global": syn.X_global.shape[1] - 1}
    for name, Xr in syn.X_entity.items():
        shards[f"re_{name}"] = Xr
        ids[name] = syn.entity_ids[name]
        intercepts[f"re_{name}"] = Xr.shape[1] - 1
    return GameDataset(
        response=syn.response,
        offsets=syn.offsets,
        weights=syn.weights,
        feature_shards=shards,
        entity_ids=ids,
        num_entities=dict(syn.num_entities),
        intercept_index=intercepts,
    )
