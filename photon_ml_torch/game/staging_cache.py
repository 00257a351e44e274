"""Persistent, shard-granular staging cache for projected random effects.

Port of ``photon_ml_tpu/game/staging_cache.py``: the same key, the same
files and the same commit discipline, so either package reads the
other's entries. The host-side staging products (per-shard projected
feature blocks, column maps, subspace join tables) persist on disk keyed
by the DATASET CONTENT DIGEST (``game/descent._dataset_digest``) plus
every staging parameter, so a re-fit of the same data in a fresh process
skips the projection pass entirely — at the 10M-row / 1M-entity flagship
that pass is tens of seconds of sort/segment work per coordinate.

Layout (v3, shard-granular): ``<cache_dir>/<key>/`` holding

- ``s<i>_<j>.npy`` — array j of staged shard i (one shard = one lane
  slice of one bucket, the unit the parallel pipeline produces);
- ``s<i>.ok`` — shard i's commit marker (JSON with the arity, each
  array file's CRC32 and the version), written LAST via atomic rename,
  so a reader never trusts a half-written shard;
- ``sub_<name>.npy`` + ``meta.json`` — the subspace join arrays and the
  entry's completion record, written once every shard exists.

Shards are written **as they are produced** by the staging pipeline
(``game/staging.py``): a killed run leaves a partial entry whose valid
shards are reused on restart — only the missing or corrupt ones restage.
Loads memory-map the arrays read-only; the coordinate copies them into
its device transfer and never writes through the map.

Anything unreadable (version skew, partial copy, foreign files) is
treated as a per-shard miss — the caller restages and overwrites.
Corruption that keeps a parseable npy header (bit rot, a torn page) is
caught by the per-file CRC32 recorded in the commit marker: loads verify
every array's checksum before trusting the shard, so a corrupt shard
degrades to a restage of exactly that shard — never silently wrong
staged bytes.

Not ported: the reference's fault-injection sites
(``staging_cache.save_shard``, ``staging_cache.load_shard`` and
``staging_cache.shard_file``, its bit rot on a written shard file),
which come with the fault injector in slice 10.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np

from photon_ml_torch.utils.diskio import atomic_write as _atomic_write
from photon_ml_torch.utils.diskio import file_crc32

logger = logging.getLogger("photon_ml_torch.game")

# Bump when the staged representation changes shape/meaning. v2: whole-
# bucket tuples became per-shard (lane-slice) tuples with commit markers.
# v3: markers carry per-file CRC32s; loads verify before trusting.
STAGING_VERSION = 3


def staging_key(dataset, norm, **params) -> str:
    """Cache key: dataset content digest + normalization digest + every
    staging parameter (bounds, seed, projection flags, shard size, …)."""
    from photon_ml_torch.game.descent import (_dataset_digest,
                                              normalization_digest)

    h = hashlib.sha1()
    h.update(f"v{STAGING_VERSION}".encode())
    h.update(_dataset_digest(dataset).encode())
    h.update(normalization_digest(norm).encode())
    for k in sorted(params):
        h.update(f"{k}={params[k]!r};".encode())
    return h.hexdigest()


def save_shard(cache_dir: str, key: str, index: int,
               arrays: tuple[np.ndarray, ...]) -> None:
    """Persist one staged shard; the ``.ok`` marker (carrying each
    array file's CRC32) commits it last."""
    path = os.path.join(cache_dir, key)
    os.makedirs(path, exist_ok=True)
    crcs = []
    for j, a in enumerate(arrays):
        fpath = os.path.join(path, f"s{index}_{j}.npy")
        _atomic_write(fpath,
                      lambda f, _a=a: np.save(f, np.asarray(_a),
                                              allow_pickle=False))
        crcs.append(file_crc32(fpath))
    marker = json.dumps({"arity": len(arrays), "crc": crcs,
                         "version": STAGING_VERSION}).encode()
    _atomic_write(os.path.join(path, f"s{index}.ok"),
                  lambda f: f.write(marker))


def load_shard(cache_dir: str, key: str, index: int
               ) -> Optional[tuple[np.ndarray, ...]]:
    """One staged shard (memory-mapped, read-only), or None on any miss:
    no marker, version skew, unreadable arrays (truncation included —
    np.load validates the header), or a CRC mismatch against the commit
    marker (silent corruption)."""
    path = os.path.join(cache_dir, key)
    try:
        with open(os.path.join(path, f"s{index}.ok")) as f:
            marker = json.load(f)
        if marker.get("version") != STAGING_VERSION:
            return None
        crcs = marker["crc"]
        files = [os.path.join(path, f"s{index}_{j}.npy")
                 for j in range(int(marker["arity"]))]
        for fpath, want in zip(files, crcs):
            got = file_crc32(fpath)
            if got != want:
                logger.warning(
                    "staging cache shard %s is corrupt (crc %08x != "
                    "committed %08x) — treating as a miss and restaging",
                    fpath, got, want)
                return None
        return tuple(np.load(fpath, mmap_mode="r", allow_pickle=False)
                     for fpath in files)
    except Exception:
        logger.debug("staging cache miss for %s shard %d",
                     key, index, exc_info=True)
        return None


def save_meta(cache_dir: str, key: str, num_shards: int,
              subspace: Optional[dict] = None) -> None:
    """Finalize an entry: subspace join arrays + the completion record
    (``meta.json``, written last — its presence means COMPLETE)."""
    path = os.path.join(cache_dir, key)
    os.makedirs(path, exist_ok=True)
    for name, a in (subspace or {}).items():
        _atomic_write(os.path.join(path, f"sub_{name}.npy"),
                      lambda f, _a=a: np.save(f, np.asarray(_a),
                                              allow_pickle=False))
    meta = json.dumps({"version": STAGING_VERSION,
                       "num_shards": int(num_shards),
                       "subspace": sorted(subspace or {})}).encode()
    _atomic_write(os.path.join(path, "meta.json"),
                  lambda f: f.write(meta))


def load_subspace(cache_dir: str, key: str,
                  expected_shards: Optional[int] = None
                  ) -> Optional[dict]:
    """The subspace arrays of a COMPLETE entry (None when the entry is
    absent, partial, version-skewed, or shaped for a different plan)."""
    path = os.path.join(cache_dir, key)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("version") != STAGING_VERSION:
            return None
        if (expected_shards is not None
                and meta.get("num_shards") != expected_shards):
            return None
        return {name: np.load(os.path.join(path, f"sub_{name}.npy"),
                              mmap_mode="r", allow_pickle=False)
                for name in meta["subspace"]}
    except Exception:
        logger.debug("staging cache subspace miss for %s", key,
                     exc_info=True)
        return None


def save(cache_dir: str, key: str,
         shard_arrays: list[tuple[np.ndarray, ...]],
         subspace: Optional[dict] = None) -> None:
    """Convenience: persist a complete entry in one call."""
    for i, t in enumerate(shard_arrays):
        save_shard(cache_dir, key, i, t)
    save_meta(cache_dir, key, len(shard_arrays), subspace)


def load(cache_dir: str, key: str
         ) -> Optional[tuple[list[tuple[np.ndarray, ...]],
                             dict[str, np.ndarray]]]:
    """(shard_arrays, subspace) of a COMPLETE entry, or None on any miss
    (a single bad shard fails the whole-entry load; the pipeline's
    per-shard probing is what gives partial credit)."""
    path = os.path.join(cache_dir, key)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("version") != STAGING_VERSION:
            return None
        shards = []
        for i in range(int(meta["num_shards"])):
            t = load_shard(cache_dir, key, i)
            if t is None:
                return None
            shards.append(t)
        subspace = {
            name: np.load(os.path.join(path, f"sub_{name}.npy"),
                          mmap_mode="r", allow_pickle=False)
            for name in meta["subspace"]}
        return shards, subspace
    except Exception:
        logger.debug("staging cache whole-entry miss for %s", key,
                     exc_info=True)
        return None
