"""Coefficients: a means vector plus optional variances.

Port of ``photon_ml_tpu/models/coefficients.py``. Reference parity:
photon-lib ``model/Coefficients.scala`` (means, optional per-coefficient
variances, dot/norm helpers, ``computeScore``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """GLM coefficients: means (d,) and optional variances (d,)."""

    means: Tensor
    variances: Optional[Tensor] = None

    @property
    def dim(self) -> int:
        return int(self.means.shape[-1])

    def compute_score(self, features: Tensor) -> Tensor:
        """w·x for a single vector or a batch (…, d) of feature vectors."""
        return features @ self.means

    def norm(self, ord: int = 2) -> Tensor:
        if ord == 1:
            return torch.sum(torch.abs(self.means))
        if ord == 2:
            return torch.sqrt(torch.sum(self.means * self.means))
        raise ValueError(f"unsupported norm order {ord!r} (use 1 or 2)")

    @staticmethod
    def zeros(dim: int, dtype=torch.float32, with_variances: bool = False,
              device="cpu") -> "Coefficients":
        means = torch.zeros((dim,), dtype=dtype, device=device)
        variances = (torch.zeros((dim,), dtype=dtype, device=device)
                     if with_variances else None)
        return Coefficients(means=means, variances=variances)
