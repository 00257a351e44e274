"""GAME model classes: fixed-effect and random-effect submodels.

Port of ``photon_ml_tpu/game/models.py``. Reference parity: photon-api
``model/GameModel.scala``, ``model/FixedEffectModel.scala``,
``model/RandomEffectModel.scala`` and
``model/RandomEffectModelInProjectedSpace.scala``.

A random-effect model is ONE (num_entities, d) tensor: scoring is a row
gather and a rowwise dot. Entities without a trained model keep zero
rows, and ids beyond the table contribute exactly zero (the reference's
passive/unseen-entity semantics). ``score`` runs on the device the
model's tensors live on. A dataset's arrays are host numpy, copied there
per call, or tensors already placed (``data/prefetch.stage_dataset``),
which are used as they are when they live on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops.sparse_aggregators import ell_matvec
from photon_ml_torch.types import TaskType

Tensor = torch.Tensor


def _to(x, device: torch.device) -> Tensor:
    """``x`` (host numpy or a tensor) on ``device``: no copy for a tensor
    already there."""
    if isinstance(x, Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _on(x, like: Tensor) -> Tensor:
    return _to(x, like.device)


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """One shared GLM over a feature shard (reference: FixedEffectModel)."""

    shard_id: str
    coefficients: Coefficients

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    def score(self, dataset: GameDataset) -> Tensor:
        shard = dataset.feature_shards[self.shard_id]
        means = self.coefficients.means
        if isinstance(shard, SparseShard):
            return ell_matvec(_on(shard.indices, means),
                              _on(shard.values, means), means)
        # A rowwise product and sum, not a matrix-vector product: each
        # row's sum then has one order whatever the rows around it, so
        # scoring in row chunks gives the same bits as scoring at once.
        return torch.sum(_on(shard, means) * means, dim=-1)


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity coefficient table (reference: RandomEffectModel).

    ``means`` is (num_entities, d); untrained entities hold zero rows.
    """

    re_type: str
    shard_id: str
    means: Tensor  # (num_entities, d)
    variances: Optional[Tensor] = None  # (num_entities, d)

    @property
    def num_entities(self) -> int:
        return int(self.means.shape[0])

    @property
    def dim(self) -> int:
        return int(self.means.shape[1])

    def entity_rows(self, ids: np.ndarray) -> np.ndarray:
        """Dense (len(ids), dim) host rows for in-table ids — the fetch
        contract the serving store's cache fill relies on."""
        return self.means.cpu().numpy()[np.asarray(ids, np.int64)]

    def score(self, dataset: GameDataset) -> Tensor:
        shard = dataset.feature_shards[self.shard_id]
        W = self.means
        E = W.shape[0]
        ids = _on(dataset.entity_ids[self.re_type], W).long()
        safe = torch.clamp(ids, max=E - 1)
        if isinstance(shard, SparseShard):
            # ELL padding slots carry value 0, so clamping their sentinel
            # index (== d) into range is exact.
            idx = torch.clamp(_on(shard.indices, W).long(),
                              max=W.shape[1] - 1)
            contrib = torch.sum(_on(shard.values, W) * W[safe[:, None], idx],
                                dim=-1)
        else:
            contrib = torch.sum(_on(shard, W) * W[safe], dim=-1)
        return torch.where(ids < E, contrib, torch.zeros_like(contrib))


def dense_rows_from_subspace(cols: np.ndarray, means: np.ndarray,
                             num_features: int) -> np.ndarray:
    """Scatter (k, A) subspace rows into dense (k, num_features) rows —
    the densification semantic shared by
    ``SubspaceRandomEffectModel.entity_rows`` and the serving store's
    cache fill (which densifies only the entities it fetches)."""
    cols = np.asarray(cols)
    means = np.asarray(means, np.float32)
    W = np.zeros((cols.shape[0], num_features), np.float32)
    r, c = np.nonzero(cols >= 0)
    W[r, cols[r, c]] = means[r, c]
    return W


def sort_subspace_rows(cols: np.ndarray, *tables: Optional[np.ndarray]):
    """Canonicalize subspace rows: sort each row by column id with padding
    (-1) last, permuting the parallel coefficient tables identically.

    This IS the SubspaceRandomEffectModel layout invariant — ``score()``'s
    per-row searchsorted requires it — shared by the coordinate's staging
    and, in the reference, its Avro loader. Returns (cols_sorted, order,
    *tables_sorted); ``order`` is the sorted←unsorted permutation; None
    tables pass through.
    """
    order = np.argsort(
        np.where(cols < 0, np.iinfo(np.int32).max, cols),
        axis=1, kind="stable").astype(np.int32)
    out = [np.take_along_axis(cols, order, axis=1), order]
    for t in tables:
        out.append(None if t is None
                   else np.take_along_axis(np.asarray(t), order, axis=1))
    return tuple(out)


def _subspace_positions(cols: np.ndarray, num_features: int,
                        entity_ids: np.ndarray,
                        indices: np.ndarray,
                        block_rows: int = 1 << 18) -> np.ndarray:
    """Map data nonzeros into per-entity subspace slots.

    ``cols`` is the model's (E, A) active-column table (-1 padding);
    ``indices`` the dataset's (n, k) ELL column ids (sentinel
    ``num_features`` for padding). Returns (n, k) FLAT indices into
    ``cols``-shaped tables, with misses (column inactive for that entity,
    entity beyond the table, ELL padding) mapped to E*A (one past the end).

    The reference's positions, found another way: instead of one
    searchsorted of every nonzero's (entity, column) key among all E·A
    keys (a cache miss at each of ~24 steps), each row compares its k
    columns with its entity's A table columns (A ≤ 64), in blocks of rows
    on a thread pool (numpy's compares release the GIL). Where an
    entity's row holds a column twice, the first slot wins, as the
    reference's stable sort makes it. The (E, d) dense table this
    replaces never exists.
    """
    import concurrent.futures as cf
    import os

    cols = np.asarray(cols)
    E, A = cols.shape
    ids = np.asarray(entity_ids, np.int64)
    idx = np.asarray(indices)
    out = np.full(idx.shape, E * A, np.int64)
    if not (cols >= 0).any():  # no active columns anywhere: all miss
        return out
    # Padding slots never match: every real column is < num_features.
    table = np.where(cols < 0, np.int64(num_features) + 1,
                     cols).astype(np.int64)

    def block(lo: int) -> None:
        rows = slice(lo, lo + block_rows)
        e = np.minimum(ids[rows], E - 1)
        q = np.minimum(idx[rows].astype(np.int64), num_features)
        eq = table[e][:, None, :] == q[:, :, None]  # (rows, k, A)
        hit = eq.any(axis=2) & (ids[rows] < E)[:, None]
        out[rows] = np.where(hit, e[:, None] * A + eq.argmax(axis=2),
                             E * A)

    starts = range(0, ids.shape[0], block_rows)
    with cf.ThreadPoolExecutor(max(1, min(len(starts),
                                          os.cpu_count() or 1))) as pool:
        list(pool.map(block, starts))
    return out


@dataclasses.dataclass(frozen=True)
class SubspaceRandomEffectModel:
    """Per-entity models kept in their active-column subspaces.

    ``cols`` (num_entities, A) holds each entity's active global columns,
    sorted ascending with -1 padding last; ``means`` the coefficients for
    exactly those columns (reference: RandomEffectModelInProjectedSpace).
    """

    re_type: str
    shard_id: str
    num_features: int  # full feature-space dimension d
    cols: Tensor  # (num_entities, A) int32 active columns; -1 padding
    means: Tensor  # (num_entities, A) coefficients for those columns
    variances: Optional[Tensor] = None  # (num_entities, A)

    @property
    def num_entities(self) -> int:
        return int(self.cols.shape[0])

    @property
    def dim(self) -> int:
        return int(self.num_features)

    @property
    def subspace_dim(self) -> int:
        return int(self.cols.shape[1])

    def entity_rows(self, ids: np.ndarray) -> np.ndarray:
        """Dense (len(ids), num_features) rows of the requested entities
        only."""
        ids = np.asarray(ids, np.int64)
        return dense_rows_from_subspace(
            self.cols.cpu().numpy()[ids], self.means.cpu().numpy()[ids],
            self.num_features)

    def to_random_effect_model(self) -> RandomEffectModel:
        """Materialize the dense (E, d) table (small-d interop only)."""
        E, A = self.cols.shape
        cols = self.cols.long()
        safe_c = torch.where(cols >= 0, cols,
                             self.num_features).reshape(-1)
        rows = torch.arange(E, device=cols.device).repeat_interleave(A)

        def scatter(tab):
            if tab is None:
                return None
            W = torch.zeros((E, self.num_features + 1), dtype=torch.float32,
                            device=cols.device)
            W[rows, safe_c] = tab.to(cols.device, torch.float32).reshape(-1)
            return W[:, :self.num_features].contiguous()

        return RandomEffectModel(
            re_type=self.re_type, shard_id=self.shard_id,
            means=scatter(self.means), variances=scatter(self.variances))

    def score(self, dataset: GameDataset) -> Tensor:
        """Score without materializing (E, d): a row's columns map into
        its entity's sorted subspace by a batched ``searchsorted``."""
        shard = dataset.feature_shards[self.shard_id]
        cols_all = self.cols.long()
        E, A = cols_all.shape
        ids = _on(dataset.entity_ids[self.re_type], self.means).long()
        safe_e = torch.clamp(ids, max=E - 1)
        Wn = self.means[safe_e]  # (n, A)
        C = cols_all[safe_e]  # (n, A)
        if isinstance(shard, SparseShard):
            Cs = torch.where(C < 0, torch.full_like(C, self.num_features + 1),
                             C)
            idx = _on(shard.indices, self.means).long()  # sentinel d padding
            pos = torch.clamp(torch.searchsorted(Cs, idx), max=A - 1)
            hit = ((torch.gather(Cs, 1, pos) == idx) & (ids[:, None] < E))
            return torch.sum(_on(shard.values, self.means)
                             * torch.gather(Wn, 1, pos) * hit, dim=-1)
        # Dense shard: gather each row's entity-active columns of X.
        X = _on(shard, self.means)
        xa = torch.gather(X, 1, torch.clamp(C, min=0)) * (C >= 0)
        contrib = torch.sum(xa * Wn, dim=-1)
        return torch.where(ids < E, contrib, torch.zeros_like(contrib))


CoordinateModel = Union[FixedEffectModel, RandomEffectModel,
                        SubspaceRandomEffectModel]


@dataclasses.dataclass
class GameModel:
    """Additive combination of coordinate models (reference: GameModel)."""

    task: TaskType
    models: dict[str, CoordinateModel]  # CoordinateId -> model

    def score(self, dataset: GameDataset,
              include_offsets: bool = True) -> Tensor:
        scores = self.coordinate_scores(dataset)
        device = (next(iter(scores.values())).device if scores
                  else torch.device("cpu"))
        total = (_to(dataset.offsets, device)
                 if include_offsets else
                 torch.zeros(dataset.num_rows, dtype=torch.float32,
                             device=device))
        for s in scores.values():
            total = total + s
        return total

    def coordinate_scores(self, dataset: GameDataset) -> dict[str, Tensor]:
        return {cid: m.score(dataset) for cid, m in self.models.items()}
