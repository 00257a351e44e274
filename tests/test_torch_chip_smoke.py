"""chip_smoke.py's host-side helpers, on the CPU at a small size.

Config 5's rows are generated by a child process beside the config-4
phases; they must be the bits that ``synthetic_sparse`` gives in process.
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
