"""GameDataset persistence (npz + JSON metadata).

Port of ``photon_ml_tpu/data/io.py``, in the reference's on-disk format,
so either package reads the other's directories bit for bit: the arrays
in ``arrays.npz`` (written with ``np.savez_compressed``), dense shards as
``shard_<id>``, ELL shards as ``shard_<id>_indices`` and
``shard_<id>_values``, entity ids as ``entity_<type>``, and the shard
list, the sparse shards' widths, the entity-table sizes and the
intercept columns in ``dataset.json``. Reference note: the reference
stores training data as Avro records (photon-client
``data/avro/AvroDataReader.scala``); this is the fast native container
for the same columnar content, used by the CLI drivers.
"""

from __future__ import annotations

import json
import os

import numpy as np

from photon_ml_torch.data.game_data import GameDataset, SparseShard

_META = "dataset.json"
_ARRAYS = "arrays.npz"


def save_game_dataset(ds: GameDataset, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {
        "response": ds.response,
        "offsets": ds.offsets,
        "weights": ds.weights,
    }
    sparse_shards = {}
    for k, v in ds.feature_shards.items():
        if isinstance(v, SparseShard):
            arrays[f"shard_{k}_indices"] = v.indices
            arrays[f"shard_{k}_values"] = v.values
            sparse_shards[k] = int(v.num_features)
        else:
            arrays[f"shard_{k}"] = v
    for k, v in ds.entity_ids.items():
        arrays[f"entity_{k}"] = v
    np.savez_compressed(os.path.join(path, _ARRAYS), **arrays)
    meta = {
        "shards": list(ds.feature_shards),
        "sparse_shards": sparse_shards,  # shard id -> num_features
        "entities": {k: int(n) for k, n in ds.num_entities.items()},
        "intercept_index": dict(ds.intercept_index),
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def load_game_dataset(path: str) -> GameDataset:
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    z = np.load(os.path.join(path, _ARRAYS))
    sparse = meta.get("sparse_shards", {})

    def _shard(k):
        if k in sparse:
            return SparseShard(indices=z[f"shard_{k}_indices"],
                               values=z[f"shard_{k}_values"],
                               num_features=int(sparse[k]))
        return z[f"shard_{k}"]

    return GameDataset(
        response=z["response"],
        offsets=z["offsets"],
        weights=z["weights"],
        feature_shards={k: _shard(k) for k in meta["shards"]},
        entity_ids={k: z[f"entity_{k}"] for k in meta["entities"]},
        num_entities={k: int(v) for k, v in meta["entities"].items()},
        intercept_index={k: (None if v is None else int(v))
                         for k, v in meta["intercept_index"].items()},
    )
