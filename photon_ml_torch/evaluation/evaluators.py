"""Evaluators: the area under the ROC curve.

Port of ``auc`` from ``photon_ml_tpu/evaluation/evaluators.py``.
Reference parity: photon-api ``evaluation/AreaUnderROCCurveEvaluator.scala``
(Spark BinaryClassificationMetrics). The rest of the reference's
evaluators (RMSE, the losses, precision@k, the grouped variants and the
suite) come with slice 3 of the port.

Global AUC is the tie-averaged rank-sum statistic over one sort, in
float32 as the reference computes it.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def auc(scores: Tensor, labels: Tensor,
        weights: Optional[Tensor] = None) -> Tensor:
    """Area under the ROC curve, tie-averaged rank-sum form; a weighted
    rank sum when ``weights`` are given."""
    scores = scores.to(torch.float32)
    labels = labels.to(torch.float32)
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    y_sorted = labels[order]
    # [left, right) bounds of each score's run of ties.
    left = torch.searchsorted(s_sorted, s_sorted, side="left")
    right = torch.searchsorted(s_sorted, s_sorted, side="right")
    if weights is None:
        n = scores.shape[0]
        avg_rank = (left + 1 + right).to(torch.float32) / 2.0
        p = torch.sum(y_sorted)
        nneg = n - p
        rank_sum = torch.sum(avg_rank * y_sorted)
        return (rank_sum - p * (p + 1) / 2.0) / torch.clamp(p * nneg,
                                                            min=1e-12)
    # Weighted AUC: P(score+ > score-) with example weights.
    w = weights.to(torch.float32)[order]
    wpos = w * y_sorted
    wneg = w * (1.0 - y_sorted)
    total_neg = torch.cumsum(wneg, dim=0)
    zero = torch.zeros_like(total_neg)
    below_run = torch.where(left > 0, total_neg[torch.clamp(left - 1, min=0)],
                            zero)
    run_neg = total_neg[right - 1] - below_run
    # Half credit within equal-score runs; wneg of a positive is 0, so
    # (run_neg - wneg) == run_neg for positives.
    credit = torch.sum(wpos * (below_run + 0.5 * (run_neg - wneg)))
    denom = torch.sum(wpos) * torch.sum(wneg)
    return credit / torch.clamp(denom, min=1e-12)
