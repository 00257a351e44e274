"""Batch aggregations: value, gradient, Hessian·v, Hessian diagonal.

Port of ``photon_ml_tpu/ops/aggregators.py``. Reference parity: photon-lib
``function/glm/ValueAndGradientAggregator.scala``,
``HessianVectorAggregator.scala``, ``HessianDiagonalAggregator.scala``
and ``HessianMatrixAggregator.scala``.

Margins are one matrix product per batch and the gradient is the
transposed product Xᵀr; normalization factors and shifts fold in
algebraically (photon_ml_torch/normalization.py). The reference left
these dense products to XLA; here they are ``torch.matmul`` calls.

Under bfloat16 feature storage the small operand (w, v or r) is rounded
to bfloat16 and each product accumulates and comes out in float32 (the
reference's ``preferred_element_type=float32`` einsums): one cuBLAS call
with a float32 output on a card, with no float32 copy of X, and the
upcast product on the CPU. A product of two bfloat16 numbers is exact in
float32, so the two agree to summation order. The variances upcast X to
float32 first, as the reference does.

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


def _bf16_product(a: Tensor, b: Tensor) -> Tensor:
    """float32 (m, p) = a (m, k) @ b (k, p) for bfloat16 operands, each
    product exact and the sums in float32: on a card one cuBLAS call
    with a float32 output (no float32 copy of either operand), on the
    CPU the plain version over upcast copies."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _bf16_batched(a: Tensor, b: Tensor) -> Tensor:
    """:func:`_bf16_product` over a leading lane axis: (L, m, p)."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _matvec(X: Tensor, w: Tensor) -> Tensor:
    """(..., n) = X (..., n, d) @ w (..., d). Under bfloat16 storage w is
    rounded to bfloat16 and the products accumulate in float32, as the
    reference's ``preferred_element_type`` einsum does."""
    if X.dtype != torch.bfloat16:
        return torch.matmul(X, w.unsqueeze(-1)).squeeze(-1)
    wb = w.to(torch.bfloat16)
    if X.dim() == 2:
        if wb.dim() == 1:
            return _bf16_product(X, wb.unsqueeze(-1)).squeeze(-1)
        # One shared X under (..., d) lanes: the lanes are columns.
        lanes = wb.reshape(-1, wb.shape[-1])
        out = _bf16_product(X, lanes.t()).t()
        return out.reshape(*wb.shape[:-1], X.shape[0])
    lead = X.shape[:-2]
    Xf = X.reshape(-1, *X.shape[-2:])
    wf = wb.expand(*lead, wb.shape[-1]).reshape(-1, wb.shape[-1], 1)
    return _bf16_batched(Xf, wf).reshape(*lead, X.shape[-2])


def _tmatvec(X: Tensor, r: Tensor) -> Tensor:
    """(..., d) = Xᵀ r: X (..., n, d), r (..., n) — the gradient
    reduction. Under bfloat16 storage r is rounded to bfloat16, as
    in :func:`_matvec`."""
    if X.dtype != torch.bfloat16:
        return torch.matmul(r.unsqueeze(-2), X).squeeze(-2)
    rb = r.to(torch.bfloat16)
    if X.dim() == 2:
        lanes = rb.reshape(-1, rb.shape[-1])
        out = _bf16_product(lanes, X)
        return out.reshape(*rb.shape[:-1], X.shape[-1])
    lead = X.shape[:-2]
    Xf = X.reshape(-1, *X.shape[-2:])
    rf = rb.expand(*lead, rb.shape[-1]).reshape(-1, 1, rb.shape[-1])
    return _bf16_batched(rf, Xf).reshape(*lead, X.shape[-1])


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
    # A once-per-fit path: bfloat16 storage is upcast before the square
    # (a bfloat16 square would round twice), as in the reference.
    X = batch.features.to(torch.float32)
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
    Xp = batch.features.to(torch.float32)
    # (..., d) factors and shifts apply to every row of their lane: shared
    # (d,) ones, or a projected wave's per-lane (B, d_active) ones.
    if norm.shifts is not None:
        Xp = Xp - norm.shifts.unsqueeze(-2)
    if norm.factors is not None:
        Xp = Xp * norm.factors.unsqueeze(-2)
    return torch.matmul(Xp.transpose(-1, -2), Xp * r.unsqueeze(-1))


def scores(batch_features: Tensor, means: Tensor,
           offsets: Optional[Tensor] = None) -> Tensor:
    """Raw-space scores X @ w (+ offsets), for scoring and evaluation."""
    s = _matvec(batch_features, means)
    if offsets is not None:
        s = s + offsets
    return s
