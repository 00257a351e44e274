"""Feature normalization folded into the margins: data is never rewritten.

Port of ``photon_ml_tpu/normalization.py``. Reference parity: photon-lib
``normalization/NormalizationContext.scala`` and
``NormalizationType.scala`` (NONE, SCALE_WITH_STANDARD_DEVIATION,
SCALE_WITH_MAX_MAGNITUDE, STANDARDIZATION). The raw data is untouched;
scale factors and shifts are folded into margin and gradient
computation, the model is trained in the transformed space, and
coefficients are mapped back to the original space on output:

    margin(x) = (w ∘ f)·x − (w ∘ f)·s  ( + offset )
    ∇_w       = f ∘ (Xᵀ r) − (Σ r)(f ∘ s)

Every function takes coefficients with any leading (lane) axes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


def _add_at(w: Tensor, index: int, amount: Tensor) -> Tensor:
    """A copy of ``w`` with ``amount`` added to column ``index``."""
    w = w.clone()
    w[..., index] = w[..., index] + amount
    return w


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Per-feature scale ``factors`` and ``shifts`` (both optional).

    Transformed feature: x' = (x − shifts) ∘ factors. The intercept column
    (if any) has factor 1 and shift 0 (the builders enforce it), and its
    position is kept in ``intercept_index`` so the shift mass folds back
    exactly on model export.
    """

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def to(self, device) -> "NormalizationContext":
        """The same context with its vectors on ``device``."""
        def put(t):
            return None if t is None else t.to(device)

        return NormalizationContext(put(self.factors), put(self.shifts),
                                    self.intercept_index)

    # -- margin-space helpers (used by objectives) ---------------------------

    def effective_coefficients(self, means: Tensor) -> tuple[Tensor, Tensor]:
        """(w_eff, margin_shift) with margin = X @ w_eff + margin_shift:
        ``w_eff = w ∘ f`` and ``margin_shift = −(w ∘ f)·s``."""
        w_eff = means if self.factors is None else means * self.factors
        if self.shifts is None:
            shift = torch.zeros(means.shape[:-1], dtype=means.dtype,
                                device=means.device)
        else:
            shift = -torch.sum(w_eff * self.shifts, dim=-1)
        return w_eff, shift

    def pullback_gradient(self, xtr: Tensor, r_sum: Tensor) -> Tensor:
        """Raw-space ``xtr = Xᵀ r`` and ``r_sum = Σ r`` → the gradient in
        transformed space, ``f ∘ xtr − r_sum (f ∘ s)``."""
        g = xtr if self.factors is None else xtr * self.factors
        if self.shifts is not None:
            s_eff = self.shifts if self.factors is None \
                else self.shifts * self.factors
            g = g - r_sum.unsqueeze(-1) * s_eff
        return g

    # -- model-space transforms (reference: modelToTransformedSpace etc.) ----

    def _need_intercept(self) -> None:
        if self.intercept_index is None:
            raise ValueError("shifts present but intercept_index unknown")

    def model_to_original_space(self, means: Tensor) -> Tensor:
        """Coefficients trained on x' → coefficients applying to raw x:
        w ∘ f, with the total shift −(w ∘ f)·s folded into the intercept."""
        w = means if self.factors is None else means * self.factors
        if self.shifts is not None:
            self._need_intercept()
            w = _add_at(w, self.intercept_index,
                        -torch.sum(w * self.shifts, dim=-1))
        return w

    def variances_to_original_space(self, variances: Tensor) -> Tensor:
        """Diagonal approximation matching ``model_to_original_space``:
        Var(w_orig_j) = f_j² Var(w_j) and Var(w0_orig) = Var(w0) +
        Σ_j (f_j s_j)² Var(w_j)."""
        v = variances if self.factors is None \
            else variances * self.factors * self.factors
        if self.shifts is not None:
            self._need_intercept()
            f = 1.0 if self.factors is None else self.factors
            shift_mass = torch.sum((f * self.shifts) ** 2 * variances, dim=-1)
            v = _add_at(v, self.intercept_index, shift_mass)
        return v

    def model_to_transformed_space(self, means: Tensor) -> Tensor:
        """Inverse of ``model_to_original_space`` (for warm starts)."""
        if self.shifts is not None:
            self._need_intercept()
            means = _add_at(means, self.intercept_index,
                            torch.sum(means * self.shifts, dim=-1))
        if self.factors is not None:
            means = means / self.factors
        return means


def build_normalization(
    norm_type: NormalizationType,
    *,
    means: Optional[np.ndarray] = None,
    variances: Optional[np.ndarray] = None,
    max_magnitudes: Optional[np.ndarray] = None,
    intercept_index: Optional[int] = None,
    dtype=torch.float32,
) -> NormalizationContext:
    """A NormalizationContext from summary statistics.

    Reference parity: ``NormalizationContext.apply(normalizationType,
    summary, interceptIdOpt)``. Features with zero variance or zero max
    magnitude get factor 1.
    """
    norm_type = NormalizationType(norm_type)
    if norm_type == NormalizationType.NONE:
        return NormalizationContext()

    def _safe_inv(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return np.where(x > 0.0, 1.0 / np.maximum(x, 1e-300), 1.0)

    shifts: Optional[np.ndarray] = None
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        if variances is None:
            raise ValueError(
                "SCALE_WITH_STANDARD_DEVIATION requires variances")
        factors = _safe_inv(np.sqrt(np.asarray(variances)))
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        if max_magnitudes is None:
            raise ValueError(
                "SCALE_WITH_MAX_MAGNITUDE requires max_magnitudes")
        factors = _safe_inv(np.abs(np.asarray(max_magnitudes)))
    elif norm_type == NormalizationType.STANDARDIZATION:
        if variances is None or means is None:
            raise ValueError("STANDARDIZATION requires means and variances")
        if intercept_index is None:
            raise ValueError(
                "STANDARDIZATION requires an intercept column (reference "
                "requires addIntercept=true when shifts are used)")
        factors = _safe_inv(np.sqrt(np.asarray(variances)))
        shifts = np.asarray(means, dtype=np.float64).copy()
    else:  # pragma: no cover
        raise ValueError(norm_type)

    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0

    return NormalizationContext(
        factors=torch.as_tensor(factors, dtype=dtype),
        shifts=None if shifts is None else torch.as_tensor(shifts,
                                                           dtype=dtype),
        intercept_index=intercept_index)
