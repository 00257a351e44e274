"""The port's staging cache (``game/staging_cache.py``) against the
reference's.

Every test waits for the staging pipeline (``join()`` or
``wait_staged()``) before it reads or damages a cache directory: a shard
is handed to the fit stream before it is written, so a directory listed
any earlier may not hold it yet.

- An entry written by either package is read by the other, with equal
  keys for the same data: every shard comes from the cache, with the
  writer's bytes, and so do the subspace join arrays.
- A corrupt (CRC mismatch), truncated or uncommitted shard is a miss that
  restages only itself, to the same bytes; an entry without its
  completion record keeps its shards.
- Keys change with the data's content and with every staging parameter.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.game import buckets, staging, staging_cache
from photon_ml_torch.game.coordinates import RandomEffectCoordinate
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops import losses
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.utils import events
from photon_ml_tpu.data.game_data import GameDataset as RefGameDataset
from photon_ml_tpu.data.game_data import SparseShard as RefSparseShard
from photon_ml_tpu.game import staging_cache as ref_staging_cache
from photon_ml_tpu.game.coordinates import \
    RandomEffectCoordinate as RefRandomEffectCoordinate
from photon_ml_tpu.normalization import \
    NormalizationContext as RefNormalizationContext
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.parallel.mesh import make_mesh

N, E, D, K = 3000, 400, 100_000, 6
SHARD = 64


def _arrays(seed=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, N).astype(np.int32)
    pools = rng.integers(0, D, size=(E, 12))
    idx = np.sort(pools[ids[:, None], rng.integers(0, 12, (N, K))], axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    vals = rng.normal(size=(N, K)).astype(np.float32)
    idx[dup] = D
    vals[dup] = 0.0
    y = (rng.random(N) < 0.5).astype(np.float32)
    return ids, idx.astype(np.int32), vals, y


def _dataset(module_ds, module_shard, arrays):
    ids, idx, vals, y = (a.copy() for a in arrays)
    return module_ds(
        response=y, offsets=np.zeros(N, np.float32),
        weights=np.ones(N, np.float32),
        feature_shards={"re": module_shard(idx, vals, D)},
        entity_ids={"u": ids}, num_entities={"u": E}, intercept_index={})


def _port(ds, cache, **kw):
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=5))
    return RandomEffectCoordinate(
        ds, "u", "re", losses.LOGISTIC, cfg, lower_bound=2,
        subspace_model=True, staging_cache_dir=cache,
        staging=staging.StagingConfig(workers=2, shard_entities=SHARD),
        device="cpu", **kw)


def _ref(ds, cache):
    from photon_ml_tpu.game.staging import StagingConfig

    cfg = RefGLMConfig(optimizer=RefOptimizerConfig(max_iterations=5))
    return RefRandomEffectCoordinate(
        ds, "u", "re", ref_losses.LOGISTIC, cfg, make_mesh(), lower_bound=2,
        subspace_model=True, staging_cache_dir=cache,
        staging=StagingConfig(workers=2, shard_entities=SHARD))


def _entry(cache):
    (key,) = os.listdir(cache)
    return key, os.path.join(cache, key)


def _load_all(module, cache, key, count):
    shards = [module.load_shard(cache, key, i) for i in range(count)]
    assert all(s is not None for s in shards)
    return [tuple(np.asarray(a) for a in s) for s in shards]


def _same(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


class _Events:
    def __init__(self, emitter):
        self.seen = []
        self.emitter = emitter

    def __enter__(self):
        self.emitter.register(self.seen.append)
        return self

    def __exit__(self, *exc):
        self.emitter.unregister(self.seen.append)

    def sources(self):
        return {e.index: e.source for e in self.seen
                if type(e).__name__ == "StagingShard"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_an_entry_of_either_package_is_read_by_the_other(tmp_path, writer):
    from photon_ml_tpu.utils import events as ref_events

    arrays = _arrays()
    cache = str(tmp_path / "cache")
    ds = _dataset(GameDataset, SparseShard, arrays)
    rds = _dataset(RefGameDataset, RefSparseShard, arrays)
    if writer == "port":
        w = _port(ds, cache).wait_staged()
        key = w._stager._cache_key
        with _Events(ref_events.default_emitter) as seen:
            r = _ref(rds, cache).wait_staged()
        assert r._staging_cache_key == key
        reader_cols = r.subspace_cols
    else:
        w = _ref(rds, cache).wait_staged()
        key = w._staging_cache_key
        with _Events(events.default_emitter) as seen:
            r = _port(ds, cache).wait_staged()
        assert r._stager._cache_key == key
        reader_cols = r.subspace_cols
    assert _entry(cache)[0] == key
    count = len(seen.sources())
    assert count > 2 and set(seen.sources().values()) == {"cache"}
    _same(_load_all(staging_cache, cache, key, count),
          _load_all(ref_staging_cache, cache, key, count))
    np.testing.assert_array_equal(reader_cols, w.subspace_cols)
    sub = staging_cache.load_subspace(cache, key, expected_shards=count)
    rsub = ref_staging_cache.load_subspace(cache, key,
                                           expected_shards=count)
    assert sorted(sub) == sorted(rsub) == ["cols", "flat", "perm"]
    for name in sub:
        assert np.asarray(sub[name]).tobytes() == \
            np.asarray(rsub[name]).tobytes()
    # The reader's staged waves are the writer's shards.
    port = r if writer == "reference" else w
    for wave, t in zip(port._waves, _load_all(staging_cache, cache, key,
                                              count)):
        assert torch.equal(wave.X, torch.from_numpy(np.array(t[0])))
        assert torch.equal(wave.cols, torch.from_numpy(
            np.array(t[5])).long())


def _stager(bucketing, shard, y, cache, key, emitter=None):
    return staging.ProjectionStager(
        bucketing=bucketing, X=shard, response=y,
        weights=np.ones(N, np.float32), intercept_index=None,
        config=staging.StagingConfig(workers=2, shard_entities=SHARD),
        cache_dir=cache, cache_key=key, label="u:re", emitter=emitter)


def _damage(path, how):
    if how == "corrupt":
        # Flip a byte past the npy header: the file still parses, and only
        # the CRC in the commit marker can tell.
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) - 5)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    elif how == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:  # uncommitted: the marker of a shard killed mid-write
        os.remove(path.rsplit("_", 1)[0] + ".ok")


@pytest.mark.parametrize("how", ["corrupt", "truncated", "uncommitted"])
def test_a_bad_shard_restages_only_itself(tmp_path, how):
    ids, idx, vals, y = _arrays()
    bk = buckets.build_bucketing(ids, E, lower_bound=2,
                                 rng=np.random.default_rng(0))
    shard = SparseShard(idx, vals, D)
    cache, key = str(tmp_path), "k"
    first = _stager(bk, shard, y, cache, key)
    want = [tuple(np.array(a) for a in t) for t in first.shards()]
    first.join()
    staging_cache.save_meta(cache, key, first.num_shards)
    victim = first.num_shards // 2
    _damage(os.path.join(cache, key, f"s{victim}_0.npy"), how)
    assert staging_cache.load_shard(cache, key, victim) is None
    assert ref_staging_cache.load_shard(cache, key, victim) is None
    em = events.EventEmitter()
    with _Events(em) as seen:
        again = _stager(bk, shard, y, cache, key, emitter=em)
        got = [tuple(np.array(a) for a in t) for t in again.shards()]
        again.join()
    assert seen.sources() == {i: "staged" if i == victim else "cache"
                              for i in range(first.num_shards)}
    _same(got, want)
    # The restaged shard was written again, whole.
    _same([tuple(np.asarray(a) for a in staging_cache.load_shard(
        cache, key, victim))], [want[victim]])


def test_an_entry_without_its_completion_record_keeps_its_shards(tmp_path):
    ids, idx, vals, y = _arrays()
    bk = buckets.build_bucketing(ids, E, lower_bound=2,
                                 rng=np.random.default_rng(0))
    shard = SparseShard(idx, vals, D)
    cache, key = str(tmp_path), "k"
    first = _stager(bk, shard, y, cache, key)
    list(first.shards())
    first.join()
    # Nothing expected a subspace record, so the entry is complete.
    meta = json.load(open(os.path.join(cache, key, "meta.json")))
    assert meta == {"version": staging_cache.STAGING_VERSION,
                    "num_shards": first.num_shards, "subspace": []}
    os.remove(os.path.join(cache, key, "meta.json"))
    assert staging_cache.load(cache, key) is None
    assert staging_cache.load_subspace(cache, key) is None
    em = events.EventEmitter()
    with _Events(em) as seen:
        again = _stager(bk, shard, y, cache, key, emitter=em)
        list(again.shards())
        again.join()
    assert set(seen.sources().values()) == {"cache"}
    # A version skew in one marker is a miss of that shard alone.
    marker = os.path.join(cache, key, "s0.ok")
    m = json.load(open(marker))
    m["version"] = staging_cache.STAGING_VERSION + 1
    json.dump(m, open(marker, "w"))
    assert staging_cache.load_shard(cache, key, 0) is None
    assert staging_cache.load_shard(cache, key, 1) is not None


def test_whole_entries_round_trip_between_the_packages(tmp_path):
    rng = np.random.default_rng(0)
    shards = [(rng.normal(size=(8, 4, 2)).astype(np.float32),
               np.arange(8, dtype=np.int32)) for _ in range(3)]
    sub = {"cols": np.arange(6, dtype=np.int32).reshape(3, 2)}
    staging_cache.save(str(tmp_path), "a", shards, sub)
    ref_staging_cache.save(str(tmp_path), "b", shards, sub)
    for module in (staging_cache, ref_staging_cache):
        for key in ("a", "b"):
            got, got_sub = module.load(str(tmp_path), key)
            _same([tuple(np.asarray(x) for x in t) for t in got], shards)
            assert np.array_equal(got_sub["cols"], sub["cols"])
    for name in os.listdir(tmp_path / "a"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


def test_keys_follow_content_and_parameters():
    arrays = _arrays()
    ds = _dataset(GameDataset, SparseShard, arrays)
    rds = _dataset(RefGameDataset, RefSparseShard, arrays)
    params = dict(re_type="u", shard_id="re", lower_bound=2, upper_bound=None,
                  seed=0, pad=8, ratio=None, intercept=None, subspace=True,
                  num_entities=E, dim=D, shard_entities=SHARD)
    key = staging_cache.staging_key(ds, NormalizationContext(), **params)
    assert key == ref_staging_cache.staging_key(
        rds, RefNormalizationContext(), **params)
    f = np.linspace(0.5, 2.0, D).astype(np.float32)
    assert staging_cache.staging_key(
        ds, NormalizationContext(torch.from_numpy(f)), **params) == \
        ref_staging_cache.staging_key(
            rds, RefNormalizationContext(jnp.asarray(f)), **params)
    others = {staging_cache.staging_key(
        ds, NormalizationContext(torch.from_numpy(f)), **params)}
    for k, v in (("lower_bound", 3), ("seed", 1), ("ratio", 0.5),
                 ("subspace", False), ("shard_entities", 128),
                 ("upper_bound", 16)):
        others.add(staging_cache.staging_key(
            ds, NormalizationContext(), **{**params, k: v}))
    changed = _dataset(GameDataset, SparseShard, arrays)
    changed.feature_shards["re"].values[7, 0] += 1.0
    others.add(staging_cache.staging_key(changed, NormalizationContext(),
                                         **params))
    assert key not in others and len(others) == 8


def test_a_generator_with_a_cache_is_refused(tmp_path):
    ds = _dataset(GameDataset, SparseShard, _arrays())
    with pytest.raises(ValueError, match="seed"):
        _port(ds, str(tmp_path), rng=np.random.default_rng(0))
