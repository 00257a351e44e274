"""Per-feature summary statistics.

Port of ``photon_ml_tpu/data/statistics.py``. Reference parity:
photon-lib ``stat/FeatureDataStatistics.scala`` (mean, variance, min,
max, number of nonzeros per feature), feeding the NormalizationContext
and the model summary output.

One pass of weighted reductions over the feature matrix, on the batch's
device. Rows of weight 0 (padding) stay out of every statistic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.normalization import (NormalizationContext,
                                           NormalizationType,
                                           build_normalization)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureDataStatistics:
    """Weighted per-feature summary (reference: FeatureDataStatistics)."""

    count: Tensor  # scalar: Σ weights
    mean: Tensor  # (d,)
    variance: Tensor  # (d,) population variance in weighted form
    min: Tensor  # (d,)
    max: Tensor  # (d,)
    num_nonzeros: Tensor  # (d,)
    max_magnitude: Tensor  # (d,): max |x|

    @property
    def dim(self) -> int:
        return int(self.mean.shape[-1])


def summarize(batch: LabeledBatch) -> FeatureDataStatistics:
    """Weighted feature statistics of a flat (n, d) batch."""
    X = batch.features
    live = batch.weights > 0.0
    w = torch.where(live, batch.weights, torch.zeros_like(batch.weights))
    wsum = torch.sum(w)
    wn = w / torch.clamp(wsum, min=1e-12)
    mean = wn @ X
    ex2 = wn @ (X * X)
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    rows = live.unsqueeze(-1)
    inf = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
    Xmin = torch.amin(torch.where(rows, X, inf), dim=0)
    Xmax = torch.amax(torch.where(rows, X, -inf), dim=0)
    nnz = torch.sum((X != 0.0) & rows, dim=0).to(torch.float32)
    max_mag = torch.amax(torch.where(rows, torch.abs(X),
                                     torch.zeros_like(X)), dim=0)
    return FeatureDataStatistics(
        count=wsum, mean=mean, variance=var, min=Xmin, max=Xmax,
        num_nonzeros=nnz, max_magnitude=max_mag)


def normalization_from_statistics(
    stats: FeatureDataStatistics,
    norm_type: NormalizationType,
    intercept_index: Optional[int],
) -> NormalizationContext:
    """Reference parity: NormalizationContext.apply(type, summary,
    intercept). The context's vectors land on the statistics' device."""
    def host(t):
        return t.detach().cpu().numpy()

    return build_normalization(
        norm_type,
        means=host(stats.mean),
        variances=host(stats.variance),
        max_magnitudes=host(stats.max_magnitude),
        intercept_index=intercept_index,
    ).to(stats.mean.device)
