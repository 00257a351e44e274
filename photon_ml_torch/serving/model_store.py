"""Resident GAME model store: the online-serving memory hierarchy.

Port of ``photon_ml_tpu/serving/model_store.py`` (the eager host store;
the mmap "direct" mode and publication come with later slices). Three
tiers:

- **Fixed effects** are one (d,) vector per coordinate, used by every
  request: device tensors for the service's lifetime, placed once.
- **Random effects** are (E, d)-shaped tables, E up to millions: a
  hash-sharded HOST store in the model's own representation (dense rows
  or subspace cols+means, never densified wholesale), plus an **LRU
  device cache** of densified rows for the entities being scored.
- **Unseen entities** (ids outside the table, unknown vocabulary keys,
  requests that omit the id) resolve to a permanent all-zero fallback
  row: scores degrade to fixed-effect-only, the offline semantics.

The cache has C+1 rows; row C is the fallback row. Cache fills pad their
insert to a power of two with zero rows aimed at row C, so the fill
writes duplicate indices there — every value written is 0 (and its int8
scale 0), so the row stays exactly zero and the result is deterministic.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Optional

import numpy as np
import torch

from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                         RandomEffectModel,
                                         SubspaceRandomEffectModel,
                                         dense_rows_from_subspace)
# The int8 cache quantises on the host with the streamed chunks' helper,
# so its codes equal the reference's byte for byte.
from photon_ml_torch.ops.streaming_sparse import quantize_rows_int8

logger = logging.getLogger("photon_ml_torch.serving")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class HashShardedStore:
    """Host-resident per-entity coefficients, hash-sharded by entity id.

    Sharding is ``id % num_shards`` (ids are dense vocabulary rows, so the
    modulo is the hash); every row 0..E-1 exists, so an entity's position
    within its shard is ``id // num_shards``. Payloads stay in the
    model's representation; densification happens per fetched batch.
    """

    def __init__(self, model, num_shards: int = 8):
        self.num_shards = int(num_shards)
        self.num_entities = int(model.num_entities)
        self.dim = int(model.dim)
        ids = np.arange(self.num_entities, dtype=np.int64)
        part = [ids[ids % self.num_shards == s]
                for s in range(self.num_shards)]
        if isinstance(model, RandomEffectModel):
            means = model.means.cpu().numpy().astype(np.float32, copy=False)
            self._shards = [(means[p],) for p in part]
            self._densify = lambda payload, pos: payload[0][pos]
        elif isinstance(model, SubspaceRandomEffectModel):
            cols = model.cols.cpu().numpy()
            means = model.means.cpu().numpy().astype(np.float32, copy=False)
            nf = int(model.num_features)
            self._shards = [(cols[p], means[p]) for p in part]
            self._densify = lambda payload, pos: dense_rows_from_subspace(
                payload[0][pos], payload[1][pos], nf)
        else:
            raise TypeError(f"unsupported random-effect model type "
                            f"{type(model).__name__}")

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Dense (len(ids), dim) rows for in-table ids (the cache-fill
        path). Grouped by shard; result rows follow the input order."""
        ids = np.asarray(ids, np.int64)
        out = np.zeros((ids.shape[0], self.dim), np.float32)
        sid = ids % self.num_shards
        for s in np.unique(sid):
            m = sid == s
            out[m] = self._densify(self._shards[s],
                                   ids[m] // self.num_shards)
        return out

    def host_bytes(self) -> int:
        return sum(int(a.nbytes) for payload in self._shards
                   for a in payload)


class REServingState:
    """One random-effect coordinate's host store + LRU device cache.

    ``cache_dtype="int8"`` keeps the device table as symmetric per-row
    int8 codes plus an f32 scale per row: rows quantise once, on the
    host, at fill time; the scoring kernel dequantises. The table then
    costs ~dim bytes per row instead of 4·dim. The LRU bookkeeping is
    dtype-blind."""

    def __init__(self, cid: str, model, cache_entities: int,
                 store_shards: int, device: torch.device,
                 cache_dtype: str = "float32"):
        if cache_dtype not in ("float32", "int8"):
            raise ValueError(
                f"unsupported cache_dtype {cache_dtype!r}; expected "
                "float32 or int8")
        self.cid = cid
        self.re_type = model.re_type
        self.shard_id = model.shard_id
        self.cache_dtype = cache_dtype
        self.device = device
        self.store = HashShardedStore(model, num_shards=store_shards)
        self.num_entities = self.store.num_entities
        self.dim = self.store.dim
        # Cache size never exceeds the entity table (plus the fallback row).
        self.capacity = max(1, min(int(cache_entities), self.num_entities))
        self.fallback_slot = self.capacity
        self._lru: collections.OrderedDict[int, int] = \
            collections.OrderedDict()  # entity id → slot, oldest first
        self._free = list(range(self.capacity))
        rows = self.capacity + 1
        if cache_dtype == "int8":
            self.cache = torch.zeros((rows, self.dim), dtype=torch.int8,
                                     device=device)
            self.cache_scale = torch.zeros((rows,), dtype=torch.float32,
                                           device=device)
        else:
            self.cache = torch.zeros((rows, self.dim), dtype=torch.float32,
                                     device=device)
            self.cache_scale = None

    def device_bytes(self) -> int:
        """Device bytes of this coordinate's cache (table + scale vector
        under int8)."""
        rows = self.capacity + 1
        if self.cache_scale is not None:
            return rows * self.dim + rows * 4
        return rows * self.dim * 4

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def resolve(self, ids: np.ndarray) -> tuple[np.ndarray, dict]:
        """Entity ids → device-cache slots, filling the cache for misses.

        Returns (slots int32 (n,), counters dict). Ids outside [0, E) map
        to the fallback slot. The batch's own entities are PINNED for the
        duration of the resolve: eviction only reclaims slots no row of
        this batch reads (the caller guarantees capacity >= max_batch).
        Not thread-safe on its own; the service serialises resolve+score.
        """
        ids = np.asarray(ids, np.int64)
        slots = np.full(ids.shape[0], self.fallback_slot, np.int32)
        stats = {"hits": 0, "misses": 0, "unseen": 0, "evictions": 0}
        pinned = {int(e) for e in ids if 0 <= int(e) < self.num_entities}
        if len(pinned) > self.capacity:
            raise ValueError(
                f"batch references {len(pinned)} distinct entities of "
                f"coordinate {self.cid!r} but the device cache holds "
                f"{self.capacity} — raise cache_entities or lower "
                f"max_batch")
        miss_ids: list[int] = []
        miss_rows: list[int] = []
        for i, e in enumerate(ids):
            e = int(e)
            if e < 0 or e >= self.num_entities:
                stats["unseen"] += 1
                continue
            slot = self._lru.get(e)
            if slot is not None:
                self._lru.move_to_end(e)
                slots[i] = slot
                stats["hits"] += 1
            else:
                stats["misses"] += 1
                miss_ids.append(e)
                miss_rows.append(i)
        if miss_ids:
            # Assign slots to the unique missed entities (a batch may
            # repeat an entity), evicting the oldest UNPINNED entries.
            unique: dict[int, int] = {}
            for e in miss_ids:
                if e in unique:
                    continue
                if self._free:
                    slot = self._free.pop()
                else:
                    victim = next(v for v in self._lru if v not in pinned)
                    slot = self._lru.pop(victim)
                    stats["evictions"] += 1
                unique[e] = slot
                self._lru[e] = slot
            rows = self.store.fetch(np.fromiter(unique, np.int64,
                                                len(unique)))
            k = _next_pow2(len(unique))
            ins_slots = np.full(k, self.fallback_slot, np.int64)
            ins_slots[: len(unique)] = list(unique.values())
            slot_t = self._upload(ins_slots)
            if self.cache_scale is not None:
                q, row_scale = quantize_rows_int8(rows)
                ins_rows = np.zeros((k, self.dim), np.int8)
                ins_scale = np.zeros((k,), np.float32)
                ins_rows[: len(unique)] = q
                ins_scale[: len(unique)] = row_scale
                self.cache[slot_t] = self._upload(ins_rows)
                self.cache_scale[slot_t] = self._upload(ins_scale)
            else:
                ins_rows = np.zeros((k, self.dim), np.float32)
                ins_rows[: len(unique)] = rows
                self.cache[slot_t] = self._upload(ins_rows)
            for i in miss_rows:
                slots[i] = unique[int(ids[i])]
        return slots, stats

    def cached_entities(self) -> list[int]:
        return list(self._lru)


class ResidentModelStore:
    """A loaded GameModel arranged for low-latency online scoring on
    ``device``."""

    def __init__(
        self,
        model: GameModel,
        device: torch.device,
        cache_entities: int = 4096,
        store_shards: int = 8,
        entity_vocabs: Optional[dict[str, dict]] = None,
        cache_dtype: str = "float32",
    ):
        self.task = model.task
        self.device = device
        self.entity_vocabs = entity_vocabs or {}
        self.cache_dtype = cache_dtype
        self.fixed: list[tuple[str, str, torch.Tensor]] = []
        self.random: list[REServingState] = []
        self.shard_dims: dict[str, int] = {}
        self._lock = threading.Lock()
        # The served model's version (publication comes with a later
        # slice, so it stays at its boot value).
        self.version = 0
        for cid, m in model.models.items():
            if isinstance(m, FixedEffectModel):
                w = m.coefficients.means.to(device=device,
                                            dtype=torch.float32)
                self.fixed.append((cid, m.shard_id, w))
                self._claim_dim(m.shard_id, int(m.dim))
            else:
                st = REServingState(cid, m, cache_entities, store_shards,
                                    device, cache_dtype=cache_dtype)
                self.random.append(st)
                self._claim_dim(m.shard_id, st.dim)
        host = sum(st.store.host_bytes() for st in self.random)
        dev = sum(int(w.numel()) * 4 for _, _, w in self.fixed) \
            + self.device_cache_bytes()
        logger.info(
            "model store resident on %s: %d fixed + %d random "
            "coordinates, %.1f MB host store, %.1f MB device "
            "(coefficients + %s caches)", device, len(self.fixed),
            len(self.random), host / 2**20, dev / 2**20, cache_dtype)

    def device_cache_bytes(self) -> int:
        """Device bytes of the random-effect LRU caches."""
        return sum(st.device_bytes() for st in self.random)

    def _claim_dim(self, shard_id: str, dim: int) -> None:
        prev = self.shard_dims.setdefault(shard_id, dim)
        if prev != dim:
            raise ValueError(
                f"feature shard {shard_id!r} used at two dimensions "
                f"({prev} and {dim}) — model metadata is inconsistent")

    def entity_row_id(self, re_type: str, key) -> int:
        """A request's raw entity id → vocabulary row (−1 = unseen).

        Integers index the entity table directly (the NPZ-model
        contract); anything else goes through the serving vocabularies.
        """
        if key is None:
            return -1
        if isinstance(key, (int, np.integer)) \
                and not isinstance(key, bool):
            return int(key)
        vocab = self.entity_vocabs.get(re_type)
        if vocab is None:
            return -1
        return int(vocab.get(str(key), -1))

    def resolve_slots(self, ids_by_cid: dict[str, np.ndarray],
                      metrics=None) -> dict[str, np.ndarray]:
        """Per-coordinate entity ids → cache slots (filling caches)."""
        out = {}
        with self._lock:
            for st in self.random:
                slots, stats = st.resolve(ids_by_cid[st.cid])
                if metrics is not None:
                    metrics.record_cache(st.cid, **stats)
                out[st.cid] = slots
        return out

    def caches(self) -> dict[str, torch.Tensor]:
        return {st.cid: st.cache for st in self.random}

    def cache_scales(self) -> dict[str, Optional[torch.Tensor]]:
        """Per-coordinate dequantisation scale vectors (None for f32
        caches)."""
        return {st.cid: st.cache_scale for st in self.random}
