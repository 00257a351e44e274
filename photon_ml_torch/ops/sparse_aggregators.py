"""Fused sparse (ELL) GLM aggregates: value/gradient, H·v, Hessian diagonal.

Port of ``photon_ml_tpu/ops/sparse_aggregators.py``. Reference parity:
the same ``ValueAndGradientAggregator`` / ``HessianVectorAggregator``
contracts as ``ops/aggregators.py``, over sparse batches — the
reference's per-example loop over sparse Breeze vectors (axpy into a
dense gradient) becomes

    margins:  gather  w_pad[indices] · values, summed over slots
    gradient: scatter-add of (weight · dl) ⊗ values back into w-shape

The coefficient vector is padded with one trailing zero slot, so ELL
padding (slot index == d) gathers 0; the scatter drops every id >= d.
Zero-weight (padded) rows are masked by their weight exactly as in the
dense aggregators. Coefficients are (d,), one problem at a time.

Every scatter goes through ``ops/kernels/ell_scatter.scatter_rowterm``:
the plain version on CPU tensors, the hand-written kernel on CUDA tensors,
at every dimension. The reference's dimension policy (its Pallas kernel
only up to d = 2048, XLA's scatter above) is a cost model of a TPU
one-hot compare whose work grows with d·nnz; the port's kernel costs
O(nnz + d) and runs at every d. The alternative would be wrong on this
card: a plain ``index_add_`` on CUDA adds with float atomics, so at
d = 1M its summation order, and its bits, change from run to run.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_torch.data.sparse import SparseBatch
from photon_ml_torch.ops.kernels import ell_scatter
from photon_ml_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor


def _w_padded(means: Tensor) -> Tensor:
    """(d,) -> (d+1,) with a zero sentinel slot for ELL padding."""
    return torch.cat([means, means.new_zeros(1)])


def ell_matvec(indices: Tensor, values: Tensor, means: Tensor) -> Tensor:
    """(n,) X @ w for ELL rows — THE sentinel gather-dot; every consumer
    of the ELL layout (objectives, model scoring) goes through here so the
    padding contract lives in one place."""
    w_pad = _w_padded(means)
    gathered = torch.index_select(w_pad, 0, indices.reshape(-1))
    return torch.sum(values * gathered.view(indices.shape), dim=-1)


def margins(batch: SparseBatch, means: Tensor) -> Tensor:
    """(n,) margins wᵀx + offset via slot gather."""
    return ell_matvec(batch.indices, batch.values, means) + batch.offsets


def _masked(weights: Tensor, term: Tensor) -> Tensor:
    return torch.where(weights > 0.0, weights * term,
                       torch.zeros_like(term))


def _scatter_rowterm(batch: SparseBatch, r: Tensor,
                     values: Optional[Tensor] = None) -> Tensor:
    """Σ_i r_i · x_i as a scatter-add of r ⊗ values into (d,)."""
    values = batch.values if values is None else values
    return ell_scatter.scatter_rowterm(batch.indices, r[:, None] * values,
                                       batch.num_features,
                                       layout=batch.layout)


def value_and_gradient(loss: PointwiseLoss, means: Tensor,
                       batch: SparseBatch) -> tuple[Tensor, Tensor]:
    """(Σ w·l, Σ w·dl·x) — fused pass, one gather + one scatter."""
    z = margins(batch, means)
    l, dl = loss.loss_and_dz(z, batch.labels)
    value = torch.sum(_masked(batch.weights, l), dim=-1)
    return value, _scatter_rowterm(batch, _masked(batch.weights, dl))


def hessian_vector(loss: PointwiseLoss, means: Tensor, v: Tensor,
                   batch: SparseBatch) -> Tensor:
    """Σ w·d2l·(x·v)·x — TRON's H·v without materializing H."""
    z = margins(batch, means)
    d2 = loss.d2z(z, batch.labels)
    xv = ell_matvec(batch.indices, batch.values, v)
    return _scatter_rowterm(batch, _masked(batch.weights, d2) * xv)


def hessian_diagonal(loss: PointwiseLoss, means: Tensor,
                     batch: SparseBatch) -> Tensor:
    """diag(H) = Σ w·d2l·x² (SIMPLE variance mode)."""
    z = margins(batch, means)
    d2 = loss.d2z(z, batch.labels)
    return _scatter_rowterm(batch, _masked(batch.weights, d2),
                            values=batch.values * batch.values)


def scores(batch: SparseBatch, means: Tensor,
           offsets: Optional[Tensor] = None) -> Tensor:
    s = margins(batch, means) - batch.offsets
    return s if offsets is None else s + offsets
