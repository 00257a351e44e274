"""Batch aggregations: value, gradient, Hessian·v, Hessian diagonal.

Port of ``photon_ml_tpu/ops/aggregators.py``. Reference parity: photon-lib
``function/glm/ValueAndGradientAggregator.scala``,
``HessianVectorAggregator.scala``, ``HessianDiagonalAggregator.scala``
and ``HessianMatrixAggregator.scala``.

Margins are one matrix product per batch and the gradient is the
transposed product Xᵀr; normalization factors and shifts fold in
algebraically (photon_ml_torch/normalization.py). The reference left
these dense products to XLA; here they are ``torch.matmul`` calls.

Every function takes a leading lane axis, as the reference's ``...nd``
einsums do under ``vmap``: features (..., n, d) with means (..., d). A
flat (n, d) batch with (L, d) means broadcasts to L lanes over the same
rows, which is how the single fixed-effect solve runs as one lane.
Zero-weight (padding) rows are masked with ``where`` so non-finite
values in padding cannot poison the sums (0·inf would be NaN).
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

_IDENTITY = NormalizationContext()


def _matvec(X: Tensor, w: Tensor) -> Tensor:
    """(..., n) = X (..., n, d) @ w (..., d)."""
    return torch.matmul(X, w.unsqueeze(-1)).squeeze(-1)


def _tmatvec(X: Tensor, r: Tensor) -> Tensor:
    """(..., d) = Xᵀ r: X (..., n, d), r (..., n) — the gradient
    reduction."""
    return torch.matmul(r.unsqueeze(-2), X).squeeze(-2)


def margins(batch: LabeledBatch, means: Tensor,
            norm: NormalizationContext = _IDENTITY) -> Tensor:
    """Transformed-space margins z = X' @ w + offset, X' = (X − s) ∘ f.

    Padded (zero-weight) rows get margin 0, not just weight 0, so garbage
    in padding stays out of the loss and its derivatives.
    """
    w_eff, shift = norm.effective_coefficients(means)
    z = _matvec(batch.features, w_eff) + shift.unsqueeze(-1) + batch.offsets
    return torch.where(batch.weights > 0.0, z, torch.zeros_like(z))


def _masked(weights: Tensor, x: Tensor) -> Tensor:
    """weights * x with hard masking of zero-weight (padded) rows."""
    wx = weights * x
    return torch.where(weights > 0.0, wx, torch.zeros_like(wx))


def value_and_gradient(loss: PointwiseLoss, means: Tensor,
                       batch: LabeledBatch,
                       norm: NormalizationContext = _IDENTITY
                       ) -> tuple[Tensor, Tensor]:
    """(Σᵢ wᵢ l(zᵢ, yᵢ),  ∇_w) over the batch, in transformed space."""
    z = margins(batch, means, norm)
    l, dl = loss.loss_and_dz(z, batch.labels)
    value = torch.sum(_masked(batch.weights, l), dim=-1)
    r = _masked(batch.weights, dl)
    xtr = _tmatvec(batch.features, r)
    grad = norm.pullback_gradient(xtr, torch.sum(r, dim=-1))
    return value, grad


def value_only(loss: PointwiseLoss, means: Tensor, batch: LabeledBatch,
               norm: NormalizationContext = _IDENTITY) -> Tensor:
    z = margins(batch, means, norm)
    l, _ = loss.loss_and_dz(z, batch.labels)
    return torch.sum(_masked(batch.weights, l), dim=-1)


def hessian_vector(loss: PointwiseLoss, means: Tensor, v: Tensor,
                   batch: LabeledBatch,
                   norm: NormalizationContext = _IDENTITY) -> Tensor:
    """H·v with H = Σᵢ wᵢ d²l(zᵢ) x'ᵢ x'ᵢᵀ, never materialising H."""
    z = margins(batch, means, norm)
    d2 = loss.d2z(z, batch.labels)
    v_eff, v_shift = norm.effective_coefficients(v)
    u = _matvec(batch.features, v_eff) + v_shift.unsqueeze(-1)
    r = _masked(batch.weights, d2 * u)
    xtr = _tmatvec(batch.features, r)
    return norm.pullback_gradient(xtr, torch.sum(r, dim=-1))


def hessian_diagonal(loss: PointwiseLoss, means: Tensor,
                     batch: LabeledBatch,
                     norm: NormalizationContext = _IDENTITY) -> Tensor:
    """diag(H) = Σᵢ wᵢ d²l(zᵢ) (x'ᵢⱼ)² per coordinate j (SIMPLE
    variances)."""
    z = margins(batch, means, norm)
    d2 = loss.d2z(z, batch.labels)
    r = _masked(batch.weights, d2)
    X = batch.features
    x2 = _tmatvec(X * X, r)
    if norm.is_identity:
        return x2
    f = norm.factors if norm.factors is not None else torch.ones_like(means)
    if norm.shifts is None:
        return x2 * f * f
    x1 = _tmatvec(X, r)
    r_sum = torch.sum(r, dim=-1)
    if x1.dim() > 1:
        r_sum = r_sum.unsqueeze(-1)
    s = norm.shifts
    return f * f * (x2 - 2.0 * s * x1 + (s * s) * r_sum)


def hessian_matrix(loss: PointwiseLoss, means: Tensor, batch: LabeledBatch,
                   norm: NormalizationContext = _IDENTITY) -> Tensor:
    """Full H = X'ᵀ diag(w d²l) X', only for small d (FULL variances)."""
    z = margins(batch, means, norm)
    d2 = loss.d2z(z, batch.labels)
    r = _masked(batch.weights, d2)
    Xp = batch.features
    if norm.shifts is not None:
        Xp = Xp - norm.shifts
    if norm.factors is not None:
        Xp = Xp * norm.factors
    return torch.matmul(Xp.transpose(-1, -2), Xp * r.unsqueeze(-1))


def scores(batch_features: Tensor, means: Tensor,
           offsets: Optional[Tensor] = None) -> Tensor:
    """Raw-space scores X @ w (+ offsets), for scoring and evaluation."""
    s = _matvec(batch_features, means)
    if offsets is not None:
        s = s + offsets
    return s
