"""chip_smoke.py's host-side helpers, on the CPU at a small size.

Config 4's rows are generated by a child process while the kernels build
and serve runs, and config 5's by another beside the config-4 phases;
they must be the bits that ``synthetic.game_data`` and
``synthetic_sparse`` give in process. game_cli_sparse's LIBSVM files read
back the rows they were written from.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from photon_ml_torch.data import sparse  # noqa: E402

ROWS = 20_000


def test_child_generates_config5_rows_bit_for_bit():
    proc = chip_smoke.start_sparse_data(ROWS)
    got = chip_smoke.collect_sparse_data(np, torch, proc, ROWS)
    want, _ = sparse.synthetic_sparse(
        n=ROWS, num_features=chip_smoke.SPARSE_DIM,
        nnz_per_row=chip_smoke.SPARSE_NNZ, seed=chip_smoke.SEED)
    assert proc.returncode == 0
    assert got.num_features == want.num_features
    for name in chip_smoke.SPARSE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    train, val = chip_smoke.make_sparse_data(np, ROWS, got)
    assert (train.num_rows, val.num_rows) == (ROWS - ROWS // 20, ROWS // 20)


def test_child_generates_config4_rows_bit_for_bit():
    proc = chip_smoke.start_train_data(ROWS)
    got = chip_smoke.collect_train_data(np, proc)
    want = chip_smoke.synthetic_train(np, ROWS)
    assert proc.returncode == 0
    assert got.num_entities == want.num_entities
    for name in ("response", "offsets", "weights", "X_global"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("X_entity", "entity_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert list(a) == list(b), name
        for k in b:
            assert a[k].dtype == b[k].dtype, (name, k)
            assert np.array_equal(a[k], b[k]), (name, k)
    train, val = chip_smoke.make_train_data(np, ROWS, got)
    assert (train.num_rows, val.num_rows) == (ROWS - ROWS // 20, ROWS // 20)
    assert list(train.feature_shards) == ["global", "re_userId",
                                          "re_itemId"]


def test_child_generates_sparse_re_rows_bit_for_bit():
    """sparse_re_train's rows from the child process are the in-process
    generator's, and each entity's columns come from its pool (at most
    16 distinct columns an entity, the ELL padding at d)."""
    rows, entities = 4000, 400
    proc = chip_smoke.start_sparse_re_data(rows, entities)
    got = chip_smoke.collect_sparse_re_data(np, proc)
    want = chip_smoke.make_sparse_re_arrays(np, rows, entities)
    assert proc.returncode == 0 and list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    ds = chip_smoke.sparse_re_dataset(np, got, entities)
    idx = ds.feature_shards["re"].indices
    live = idx < chip_smoke.SPARSE_RE_DIM
    pairs = np.unique(np.stack([np.broadcast_to(
        got["ids"][:, None], idx.shape)[live], idx[live]]), axis=1)
    assert np.bincount(pairs[0]).max() <= chip_smoke.SPARSE_RE_POOL
    assert np.all(ds.feature_shards["re"].values[~live] == 0.0)


def test_libsvm_text_reads_back_the_rows(tmp_path):
    """game_cli_sparse's LIBSVM files: game_train's own loader gives back
    the rows they were written from (every float32 exact), and the
    row check tells other rows apart."""
    from photon_ml_torch.cli.game_train import _load_dataset

    train, _ = chip_smoke.make_sparse_data(np, 2_000)
    path = str(tmp_path / "rows.libsvm")
    chip_smoke.write_ell_libsvm(path, train)
    got = _load_dataset(path)
    a, b = got.feature_shards["global"], train.feature_shards["global"]
    width = max(a.indices.shape[1], b.indices.shape[1])
    assert np.array_equal(got.response, train.response)
    for x, y in zip(chip_smoke.canonical_rows(np, a, width),
                    chip_smoke.canonical_rows(np, b, width)):
        assert np.array_equal(x, y)
    b.values[0, 0] += 1.0
    assert not np.array_equal(chip_smoke.canonical_rows(np, a, width)[1],
                              chip_smoke.canonical_rows(np, b, width)[1])
