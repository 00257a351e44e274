"""LIBSVM-format reader and writer (the a1a and YearPredictionMSD configs).

Port of the Python reader of ``photon_ml_tpu/data/libsvm.py``. Host-side
parsing to dense or CSR numpy; ``LabeledBatch.build`` moves the arrays
to the device.

The grammar is the reference's: ``#`` comment lines and blank lines are
skipped, a row is a label followed by ``index:value`` tokens, an index
must land in [0, 2³¹) after the one-based shift, and each token holds
exactly one ``:``. Labels and values parse as Python ``float`` (a
double) and are stored as float32, which gives the bits of the
reference's native parser (a double from ``std::from_chars``, cast to
float).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

_MAX_INDEX = 2 ** 31 - 1


@dataclasses.dataclass
class LibsvmData:
    """Parsed LIBSVM file: labels plus features (dense or CSR triplet)."""

    labels: np.ndarray  # (n,)
    # Dense path:
    dense: Optional[np.ndarray] = None  # (n, d)
    # Sparse path (CSR):
    indptr: Optional[np.ndarray] = None  # (n+1,)
    indices: Optional[np.ndarray] = None  # (nnz,)
    values: Optional[np.ndarray] = None  # (nnz,)
    num_features: int = 0

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    def to_dense(self) -> np.ndarray:
        if self.dense is not None:
            return self.dense
        out = np.zeros((self.num_rows, self.num_features), np.float32)
        rows = np.repeat(np.arange(self.num_rows), np.diff(self.indptr))
        out[rows, self.indices] = self.values
        return out


def _parse(path: str, zero_based: bool):
    labels: list[float] = []
    indptr = [0]
    indices: list[int] = []
    values: list[float] = []
    offset = 0 if zero_based else 1
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            toks = parts[1:]
            if not toks:
                indptr.append(len(indices))
                continue
            # Exactly one ':' a token: every token holds one, and the line
            # holds no more than the tokens (the label parsed as a float,
            # so it holds none); a token with an empty side drops a field.
            kv = " ".join(toks).replace(":", " ").split()
            if (line.count(":") != len(toks) or len(kv) != 2 * len(toks)
                    or not all(":" in t for t in toks)):
                bad = next(t for t in toks if t.count(":") != 1
                           or t.startswith(":") or t.endswith(":"))
                raise ValueError(
                    f"malformed feature token in {path}: {bad!r}")
            ks = [int(k) - offset for k in kv[0::2]]
            lo, hi = min(ks), max(ks)
            if lo < 0 or hi > _MAX_INDEX:
                j = next(j for j, k in enumerate(ks)
                         if k < 0 or k > _MAX_INDEX)
                raise ValueError(
                    f"feature index out of range in {path}: {toks[j]!r}")
            if hi > max_idx:
                max_idx = hi
            indices.extend(ks)
            values.extend(map(float, kv[1::2]))
            indptr.append(len(indices))
    return (np.asarray(labels, np.float32), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int32), np.asarray(values, np.float32),
            max_idx)


def read_libsvm(
    path: str,
    num_features: Optional[int] = None,
    zero_based: bool = False,
    dense: bool = True,
    binary_labels_to_01: bool = True,
) -> LibsvmData:
    """Parse a LIBSVM text file.

    ``binary_labels_to_01`` maps {-1,+1} labels to {0,1} (the convention of
    this package's classification losses; a1a ships ±1).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    y, indptr, indices, values, max_idx = _parse(path, zero_based)
    if num_features is not None and max_idx >= num_features:
        # A caller-supplied feature space (e.g. "validation must share the
        # training space") makes out-of-range indices corrupt data, not
        # padding.
        raise ValueError(
            f"{path} contains feature index {max_idx} outside the declared "
            f"feature space of {num_features}")
    d = num_features if num_features is not None else max_idx + 1
    if binary_labels_to_01 and set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y + 1.0) / 2.0
    data = LibsvmData(labels=y, indptr=indptr, indices=indices,
                      values=values, num_features=d)
    if dense:
        data.dense = data.to_dense()
        data.indptr = data.indices = data.values = None
    return data


def write_libsvm(path: str, X: np.ndarray, y: np.ndarray,
                 zero_based: bool = False) -> None:
    """Write a dense matrix in LIBSVM format: the nonzeros of each row as
    ``index:value`` with values to 6 significant digits (the reference's
    text, character for character)."""
    offset = 0 if zero_based else 1
    X = np.asarray(X)
    rows, cols = np.nonzero(X)
    vals = X[rows, cols].tolist()
    cols = (cols + offset).tolist()
    ends = np.cumsum(np.bincount(rows, minlength=X.shape[0])).tolist()
    labels = np.asarray(y).tolist()
    with open(path, "w") as f:
        lo = 0
        for label, hi in zip(labels, ends):
            feats = " ".join(f"{c}:{v:.6g}"
                             for c, v in zip(cols[lo:hi], vals[lo:hi]))
            f.write(f"{label:g} {feats}\n")
            lo = hi
