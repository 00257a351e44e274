"""Sparse example batches in ELL (padded-slot) layout.

Port of ``photon_ml_tpu/data/sparse.py`` with torch tensors. The
Criteo-scale path (BASELINE config 5): feature spaces of 1e6+ columns,
where dense (n, d) matrices are impossible, keep every example in a fixed
``max_nnz`` slots of (feature index, value) pairs:

    indices: (n, max_nnz) int32   — padding slots point at column d
    values:  (n, max_nnz) float32 — padding slots hold 0.0

The sentinel column d lands gathers and scatters on a zero slot of the
(d+1,)-padded coefficient vector, so padding contributes exactly nothing
without any masking. Rows with more than ``max_nnz`` non-zeros keep their
largest-magnitude entries.

Contract: rows must be CANONICAL — no feature index may repeat within a
row. Margins and gradients are linear and would tolerate duplicates, but
the Hessian diagonal is quadratic in the per-feature value (Σx² vs
(Σx)²), so duplicates silently skew SIMPLE variances. ``from_csr``
inherits canonicality from CSR; ``synthetic_sparse`` dedupes draws.

The generators stay host numpy with the reference's draws, so the port's
data equals the reference's bit for bit; the batch wraps the arrays as
CPU tensors without copying. :meth:`SparseBatch.to` stages a batch on a
device, and on a CUDA device also builds the column-sorted layout that
the ``ell_scatter`` kernel reads (``ops/kernels/ell_scatter.py``): the
ELL pattern is fixed for a whole fit, so it is sorted once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_torch.ops.kernels.ell_scatter import ColumnLayout, build_layout

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """ELL sparse batch: indices/values (n, max_nnz), labels etc. (n,).

    ``layout`` is the column-sorted view of ``indices`` that the
    ``ell_scatter`` kernel reads; :meth:`to` builds it on a CUDA device.
    ``dataclasses.replace`` of any other field keeps it, so swapping the
    offsets of a staged batch costs nothing.
    """

    indices: Tensor  # int32, padding slot == num_features
    values: Tensor
    labels: Tensor
    weights: Tensor
    offsets: Tensor
    num_features: int
    layout: Optional[ColumnLayout] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_rows(self) -> int:
        return int(self.indices.shape[-2])

    @property
    def max_nnz(self) -> int:
        return int(self.indices.shape[-1])

    @property
    def dim(self) -> int:
        return self.num_features

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def pad_to(self, n: int) -> "SparseBatch":
        """Pad rows to ``n`` with zero-weight sentinel rows (padding slots
        at column ``num_features``). The padded batch has no layout: on a
        card, stage it with :meth:`to` before the kernel reads it."""
        cur = self.num_rows
        if n == cur:
            return self
        if n < cur:
            raise ValueError(f"cannot shrink {cur} -> {n}")
        extra = n - cur

        def pad2(a, v):
            return torch.cat([a, a.new_full((extra, a.shape[1]), v)])

        def pad1(a):
            return torch.cat([a, a.new_zeros(extra)])

        return SparseBatch(
            indices=pad2(self.indices, self.num_features),
            values=pad2(self.values, 0.0),
            labels=pad1(self.labels),
            weights=pad1(self.weights),
            offsets=pad1(self.offsets),
            num_features=self.num_features)

    def to(self, device) -> "SparseBatch":
        """This batch on ``device``: int32 indices, float32 everything
        else, contiguous. On a CUDA device the column layout is built
        once here (one stable sort of the flat ids)."""
        device = torch.device(device)

        def put(a, dtype):
            return torch.as_tensor(a).to(device=device,
                                     dtype=dtype).contiguous()

        indices = put(self.indices, torch.int32)
        layout = self.layout
        if layout is None or layout.device != device:
            layout = (build_layout(indices, self.num_features)
                      if device.type == "cuda" else None)
        return SparseBatch(
            indices=indices,
            values=put(self.values, torch.float32),
            labels=put(self.labels, torch.float32),
            weights=put(self.weights, torch.float32),
            offsets=put(self.offsets, torch.float32),
            num_features=self.num_features, layout=layout)


def _host_batch(indices, values, labels, weights, offsets,
                num_features) -> SparseBatch:
    t = torch.from_numpy
    return SparseBatch(
        indices=t(np.ascontiguousarray(indices, np.int32)),
        values=t(np.ascontiguousarray(values, np.float32)),
        labels=t(np.ascontiguousarray(labels, np.float32)),
        weights=t(np.ascontiguousarray(weights, np.float32)),
        offsets=t(np.ascontiguousarray(offsets, np.float32)),
        num_features=int(num_features))


def from_csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
             labels: np.ndarray, num_features: int,
             weights: Optional[np.ndarray] = None,
             offsets: Optional[np.ndarray] = None,
             max_nnz: Optional[int] = None) -> SparseBatch:
    """CSR triplet -> ELL. ``max_nnz`` defaults to the true row maximum;
    rows over the cap keep their largest-|value| entries."""
    n = len(indptr) - 1
    row_nnz = np.diff(indptr)
    cap = int(row_nnz.max()) if row_nnz.size else 1
    if max_nnz is None:
        max_nnz = max(cap, 1)
    ell_idx = np.full((n, max_nnz), num_features, np.int32)
    ell_val = np.zeros((n, max_nnz), np.float32)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        k = hi - lo
        if k <= max_nnz:
            ell_idx[i, :k] = indices[lo:hi]
            ell_val[i, :k] = values[lo:hi]
        else:
            keep = np.argsort(-np.abs(values[lo:hi]))[:max_nnz]
            keep.sort()
            ell_idx[i] = indices[lo:hi][keep]
            ell_val[i] = values[lo:hi][keep]
    return _host_batch(
        ell_idx, ell_val, labels,
        np.ones(n, np.float32) if weights is None else weights,
        np.zeros(n, np.float32) if offsets is None else offsets,
        num_features)


def synthetic_sparse(n: int, num_features: int, nnz_per_row: int,
                     task: str = "logistic", seed: int = 0,
                     noise: float = 0.25, zipf: bool = True
                     ) -> tuple[SparseBatch, np.ndarray]:
    """Synthetic high-dimensional sparse GLM data (Criteo-shaped): returns
    (batch, true_weights). Feature popularity is Zipf(1.3) by default,
    like CTR data (``zipf=False`` gives uniform popularity). The draws
    are the reference's, so the arrays equal its bit for bit."""
    rng = np.random.default_rng(seed)
    w_true = (rng.normal(size=num_features) *
              (rng.random(num_features) < 0.2)).astype(np.float32)
    if zipf:
        raw = rng.zipf(1.3, size=(n, nnz_per_row)).astype(np.int64)
        ids = np.minimum(raw - 1, num_features - 1).astype(np.int32)
        del raw
    else:
        ids = rng.integers(0, num_features,
                           size=(n, nnz_per_row)).astype(np.int32)
    vals = rng.normal(size=(n, nnz_per_row)).astype(np.float32)
    # Canonicalize rows (ELL contract): duplicate draws of the same index
    # within a row become sentinel/zero slots.
    order = np.argsort(ids, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    del order
    dup = np.zeros_like(ids, dtype=bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids[dup] = num_features
    vals[dup] = 0.0
    valid = ~dup
    margin = np.einsum(
        "nk,nk->n", vals,
        np.where(valid, w_true[np.minimum(ids, num_features - 1)], 0.0))
    margin += noise * rng.normal(size=n).astype(np.float32)
    if task == "logistic":
        labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(
            np.float32)
    else:
        labels = margin.astype(np.float32)
    batch = _host_batch(ids, vals, labels, np.ones(n, np.float32),
                        np.zeros(n, np.float32), num_features)
    return batch, w_true
