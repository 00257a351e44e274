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

Parsing is Python work a token, so a large file is cut at line starts
into parts of at least ``_PART_BYTES``, one a host core, each parsed by
the same line parser in a Python process of its own (a fresh
interpreter that imports only this module); the parts' arrays are
joined in file order, and the first part that fails raises its error,
so the result and the errors are the one-process parse's.
"""

from __future__ import annotations

import dataclasses
import io
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_MAX_INDEX = 2 ** 31 - 1
_PART_BYTES = 16 << 20


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


# One part of a file, parsed in a process of its own: its four arrays
# written with np.save, then its largest index; a grammar error exits 3
# with its message.
_PART_CHILD = """\
import io, sys
import numpy as np
from photon_ml_torch.data.libsvm import _parse_lines
path, lo, hi, zero_based = sys.argv[1], *map(int, sys.argv[2:])
with open(path, "rb") as f:
    f.seek(lo)
    raw = f.read(hi - lo)
try:
    parsed = _parse_lines(path, io.TextIOWrapper(io.BytesIO(raw)),
                          bool(zero_based))
except ValueError as e:
    sys.stderr.write(str(e))
    sys.exit(3)
for a in parsed[:4]:
    np.save(sys.stdout.buffer, a)
sys.stdout.buffer.write(str(parsed[4]).encode())
"""


def _host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


def _parse(path: str, zero_based: bool):
    size = os.path.getsize(path)
    parts = min(_host_cores(), size // _PART_BYTES)
    if parts < 2:
        with open(path) as f:
            return _parse_lines(path, f, zero_based)
    # Cut at line starts: a part ends after a newline byte, so no line
    # (and no CR LF pair) is split.
    cuts = [0]
    with open(path, "rb") as f:
        for k in range(1, parts):
            f.seek(max(size * k // parts, cuts[-1]))
            f.readline()
            cuts.append(f.tell())
    cuts.append(size)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PART_CHILD, path, str(lo), str(hi),
         str(int(zero_based))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env)
        for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
    outputs = [p.communicate() for p in procs]
    for p, (_, err) in zip(procs, outputs):
        if p.returncode == 3:
            raise ValueError(err.decode())
        if p.returncode != 0:
            raise RuntimeError(f"parsing a part of {path} failed "
                               f"(exit {p.returncode}): {err.decode()}")
    labels, indptrs, indices, values, max_idx = [], [], [], [], -1
    offset = 0
    for out, _ in outputs:
        buf = io.BytesIO(out)
        y, ptr, idx, val = (np.load(buf) for _ in range(4))
        labels.append(y)
        indptrs.append(ptr[1:] + offset)
        offset += int(ptr[-1])
        indices.append(idx)
        values.append(val)
        max_idx = max(max_idx, int(buf.read()))
    return (np.concatenate(labels),
            np.concatenate([np.zeros(1, np.int64), *indptrs]),
            np.concatenate(indices), np.concatenate(values), max_idx)


def _parse_lines(path: str, lines, zero_based: bool):
    """Parse LIBSVM ``lines``, raising at the first that breaks the
    grammar."""
    labels: list[float] = []
    indptr = [0]
    indices: list[int] = []
    values: list[float] = []
    offset = 0 if zero_based else 1
    max_idx = -1
    for line in lines:
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
        # holds no more than the tokens (the label parsed as a float, so
        # it holds none); a token with an empty side drops a field.
        kv = " ".join(toks).replace(":", " ").split()
        if (line.count(":") != len(toks) or len(kv) != 2 * len(toks)
                or not all(":" in t for t in toks)):
            bad = next(t for t in toks if t.count(":") != 1
                       or t.startswith(":") or t.endswith(":"))
            raise ValueError(f"malformed feature token in {path}: {bad!r}")
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
