"""The port's dataset container, LIBSVM → ELL and CLI parsers against the
reference, and the CPU prefetch pipeline.

``data/io.py`` writes the reference's on-disk format: each package reads
the other's directories (dense and ELL shards, entity ids, intercepts)
bit for bit. ``from_libsvm`` builds the reference's ELL arrays bit for
bit. The mini-DSL parsers give the reference's dataclass fields, and the
same ``ValueError`` on a bad token or an unknown key; the parsers of
configurations the port does not have raise ``NotImplementedError``
naming their slice. On the CPU ``device_prefetch`` is the identity
pipeline, and ``iter_row_chunks`` cuts views with a ragged last chunk.
A LIBSVM file parsed in parts, a process each, gives the one-process
parse's arrays and first error.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.api import configs
from photon_ml_torch.data import io as tio
from photon_ml_torch.data import prefetch
from photon_ml_torch.data import sparse
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.data.libsvm import read_libsvm
from photon_ml_tpu.api import configs as ref_configs
from photon_ml_tpu.data import io as jio
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data.game_data import GameDataset as RefGameDataset
from photon_ml_tpu.data.game_data import SparseShard as RefSparseShard
from photon_ml_tpu.data.libsvm import read_libsvm as ref_read_libsvm


def _dataset(cls, shard_cls, n=50, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 40, size=(n, 6)).astype(np.int32)
    idx[:, -2:] = 40  # padding slots at the sentinel column
    return cls(
        response=(rng.random(n) < 0.5).astype(np.float32),
        offsets=rng.normal(size=n).astype(np.float32),
        weights=rng.random(n).astype(np.float32),
        feature_shards={
            "global": rng.normal(size=(n, 5)).astype(np.float32),
            "re_userId": rng.normal(size=(n, 3)).astype(np.float32),
            "sparse": shard_cls(indices=idx,
                                values=rng.normal(size=(n, 6)).astype(
                                    np.float32),
                                num_features=40)},
        entity_ids={"userId": rng.integers(0, 7, size=n).astype(np.int32)},
        num_entities={"userId": 7},
        intercept_index={"global": 4, "re_userId": None})


def _assert_same(got, want):
    assert type(got).__module__.split(".")[0] != \
        type(want).__module__.split(".")[0]
    for name in ("response", "offsets", "weights"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(got.feature_shards) == list(want.feature_shards)
    for k, a in got.feature_shards.items():
        b = want.feature_shards[k]
        if hasattr(a, "indices"):
            assert a.num_features == b.num_features
            for f in ("indices", "values"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.entity_ids.keys() == want.entity_ids.keys()
    for k in got.entity_ids:
        assert np.array_equal(got.entity_ids[k], want.entity_ids[k])
    assert got.num_entities == want.num_entities
    assert got.intercept_index == want.intercept_index


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_dataset_directories_cross_packages_bit_for_bit(tmp_path, writer):
    port_ds = _dataset(GameDataset, SparseShard)
    ref_ds = _dataset(RefGameDataset, RefSparseShard)
    path = str(tmp_path / "ds")
    if writer == "port":
        tio.save_game_dataset(port_ds, path)
        _assert_same(jio.load_game_dataset(path), port_ds)
    else:
        jio.save_game_dataset(ref_ds, path)
        _assert_same(tio.load_game_dataset(path), ref_ds)
    # Each package reads its own directory back too, and both write the
    # same metadata.
    _assert_same(tio.load_game_dataset(path), ref_ds)
    other = str(tmp_path / "other")
    (jio.save_game_dataset(ref_ds, other) if writer == "port"
     else tio.save_game_dataset(port_ds, other))
    with open(f"{path}/dataset.json") as a, open(f"{other}/dataset.json") as b:
        assert a.read() == b.read()


def _write_sparse_libsvm(path, rng, n=80, d=30):
    with open(path, "w") as f:
        for i in range(n):
            k = int(rng.integers(0, 9))
            cols = np.sort(rng.choice(d, size=k, replace=False)) + 1
            vals = rng.normal(size=k).astype(np.float32)
            feats = " ".join(f"{c}:{v:.9g}" for c, v in zip(cols, vals))
            f.write(f"{int(rng.integers(0, 2))} {feats}\n")


@pytest.mark.parametrize("max_nnz", [None, 4])
def test_from_libsvm_matches_reference(tmp_path, max_nnz):
    path = str(tmp_path / "x.libsvm")
    _write_sparse_libsvm(path, np.random.default_rng(3))
    got = sparse.from_libsvm(read_libsvm(path, dense=False),
                             max_nnz=max_nnz)
    want = ref_sparse.from_libsvm(ref_read_libsvm(path, dense=False),
                                  max_nnz=max_nnz)
    assert got.num_features == want.num_features
    for name in ("indices", "values", "labels", "weights", "offsets"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    with pytest.raises(ValueError, match="no CSR arrays"):
        sparse.from_libsvm(read_libsvm(path, dense=True))


def _fields(obj):
    """A config dataclass as nested plain values (enums by value)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


PARSER_CASES = {
    "kv": ("parse_kv", " a = 1 ,b=x,, c=", None),
    "kv_bad_token": ("parse_kv", "a=1,b", "bad config token"),
    "streaming_defaults": ("parse_streaming_config", "", None),
    "streaming_all": ("parse_streaming_config",
                      "chunk_rows=1024,num_hot=64,dtype=INT8,depth=3,"
                      "pin=1,workers=2,solver=lbfgs", None),
    "streaming_unknown_key": ("parse_streaming_config", "chunk=5",
                              "unknown streaming keys"),
    "streaming_bad_dtype": ("parse_streaming_config", "dtype=float16",
                            "unsupported feature_dtype"),
    "streaming_bad_token": ("parse_streaming_config", "num_hot",
                            "bad config token"),
    "staging_defaults": ("parse_staging_config", "", None),
    "staging_all": ("parse_staging_config",
                    "workers=3,mode=PROCESS,depth=4,shard_entities=100,"
                    "retries=5,backoff=0.2,straggler=1.5", None),
    "staging_unknown_key": ("parse_staging_config", "threads=2",
                            "unknown staging keys"),
    "staging_bad_mode": ("parse_staging_config", "mode=fiber",
                         "staging mode"),
    "staging_bad_workers": ("parse_staging_config", "workers=0",
                            "staging workers"),
    "optimizer_defaults": ("parse_optimizer_config", "", None),
    "optimizer_all": ("parse_optimizer_config",
                      "optimizer=tron,max_iter=7,tolerance=1e-5,"
                      "reg=elastic_net,reg_weight=0.3,alpha=0.25,"
                      "down_sampling_rate=0.5,variance=simple", None),
    "optimizer_ignores_unknown_keys": ("parse_optimizer_config",
                                       "optimizer=LBFGS,nonsense=1", None),
    "optimizer_bad_enum": ("parse_optimizer_config", "reg=L3", "L3"),
    "optimizer_bad_token": ("parse_optimizer_config", "reg", "bad config"),
}


@pytest.mark.parametrize("case", sorted(PARSER_CASES))
def test_parsers_match_reference(case):
    name, spec, error = PARSER_CASES[case]
    got_fn, want_fn = getattr(configs, name), getattr(ref_configs, name)
    if error is not None:
        with pytest.raises(ValueError, match=error) as want:
            want_fn(spec)
        with pytest.raises(ValueError, match=error) as got:
            got_fn(spec)
        assert str(got.value) == str(want.value)
        return
    got, want = got_fn(spec), want_fn(spec)
    if name == "parse_kv":
        assert got == want
    else:
        assert type(got).__name__ == type(want).__name__
        assert _fields(got) == _fields(want)


@pytest.mark.parametrize("name,slice_no", [
    ("parse_ingest_config", 9), ("parse_sweep_config", 8)])
def test_unported_parsers_name_their_slice(name, slice_no):
    message = str(not_ported("x", slice_no)).split(": ", 1)[1]
    with pytest.raises(NotImplementedError, match=message):
        getattr(configs, name)("workers=2")


def test_cpu_prefetch_is_the_identity_pipeline():
    ds = _dataset(GameDataset, SparseShard, n=23)
    chunks = list(prefetch.iter_row_chunks(ds, 5))
    assert [c.num_rows for c in chunks] == [5, 5, 5, 5, 3]
    # Views, not copies, until a device copy.
    assert np.shares_memory(chunks[1].feature_shards["global"],
                            ds.feature_shards["global"])
    for device in (None, "cpu"):
        got = list(prefetch.device_prefetch(iter(chunks), depth=2,
                                            device=device))
        assert all(a is b for a, b in zip(got, chunks))
        assert len(got) == len(chunks)
    placed = []
    got = list(prefetch.device_prefetch(
        range(4), depth=3, place=lambda b: placed.append(b) or b * 10))
    assert got == [0, 10, 20, 30] and placed == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="depth"):
        next(prefetch.device_prefetch(chunks, depth=0))
    with pytest.raises(ValueError, match="batch_rows"):
        next(prefetch.iter_row_chunks(ds, 0))


def test_stage_dataset_places_every_array():
    ds = _dataset(GameDataset, SparseShard, n=9)
    ds._content_digest = "digest"
    staged = prefetch.stage_dataset(ds, device="cpu")
    assert staged._content_digest == "digest"
    assert isinstance(staged.response, torch.Tensor)
    assert isinstance(staged.entity_ids["userId"], torch.Tensor)
    shard = staged.feature_shards["sparse"]
    assert isinstance(shard.indices, torch.Tensor)
    assert shard.num_features == 40
    assert np.array_equal(staged.feature_shards["global"].numpy(),
                          ds.feature_shards["global"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prefetch.stage_dataset(ds)


def _parts_file(path, rng, crlf=False, bad=None):
    lines = ["# a comment", ""]
    for i in range(600):
        cols = np.sort(rng.choice(40, size=int(rng.integers(0, 7)),
                                  replace=False)) + 1
        vals = rng.normal(size=cols.size).astype(np.float32)
        feats = " ".join(f"{c}:{v:.9g}" for c, v in zip(cols, vals))
        lines.append(f"{int(rng.integers(0, 2))} {feats}".rstrip())
    if bad is not None:
        lines[500] = bad
    with open(path, "w", newline="") as f:
        f.write(("\r\n" if crlf else "\n").join(lines) + "\n")


@pytest.mark.parametrize("case", ["lf", "crlf", "zero_based",
                                  "malformed", "out_of_range"])
def test_parallel_parse_gives_the_one_process_parse(tmp_path, monkeypatch,
                                                    case):
    """A file cut into parts, each parsed in its own process: the arrays
    (bit for bit the reference's too) and the first error are the
    one-process parse's."""
    from photon_ml_torch.data import libsvm as tlibsvm

    path = str(tmp_path / "parts.libsvm")
    bad = {"malformed": "1 3:1:2 4:1", "out_of_range": "0 0:1.5"}.get(case)
    _parts_file(path, np.random.default_rng(7), crlf=case == "crlf",
                bad=bad)
    zero_based = case == "zero_based"
    with open(path) as f:
        lines = list(f)
    monkeypatch.setattr(tlibsvm, "_PART_BYTES", 1024)
    if bad is not None:
        with pytest.raises(ValueError) as one:
            tlibsvm._parse_lines(path, lines, zero_based)
        with pytest.raises(ValueError) as parts:
            tlibsvm._parse(path, zero_based)
        assert str(parts.value) == str(one.value)
        return
    want = tlibsvm._parse_lines(path, lines, zero_based)
    got = tlibsvm._parse(path, zero_based)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[4] == want[4]
    mine = read_libsvm(path, dense=False, zero_based=zero_based)
    ref = ref_read_libsvm(path, dense=False, zero_based=zero_based)
    for name in ("labels", "indptr", "indices", "values"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name
