"""Evaluators: AUC, RMSE, losses, precision@k — plus grouped variants.

Port of ``photon_ml_tpu/evaluation/evaluators.py``. Reference parity:
photon-api ``evaluation/`` — ``Evaluator.scala``,
``AreaUnderROCCurveEvaluator.scala``, ``RMSEEvaluator.scala``,
``SquaredLossEvaluator.scala``, ``PoissonLossEvaluator.scala``,
``PrecisionAtKEvaluator.scala``, and the grouped ("sharded") evaluators
``MultiAUCEvaluator`` / ``MultiPrecisionAtKEvaluator`` (metric per
user/query entity, then averaged), ``EvaluatorType.scala`` parsing
(``AUC``, ``RMSE``, ``PRECISION@k``, ``AUC@groupCol``...).

Everything is sort/segment math on the scores' device. Global AUC is the
tie-averaged rank-sum statistic over one sort, in float32 as the
reference computes it. Grouped metrics do not loop over groups: one
lexicographic sort of (group, score) and segment reductions compute every
group at once. Those segments are contiguous after the sort, so each
segment sum is a difference of one float64 prefix sum: a fixed order on
every device, where ``index_add_`` would add with float atomics on a card.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------- core metrics


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


def _weighted_mean(term: Tensor, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return torch.mean(term)
    return torch.sum(weights * term) / torch.clamp(torch.sum(weights),
                                                   min=1e-12)


def rmse(scores: Tensor, labels: Tensor,
         weights: Optional[Tensor] = None) -> Tensor:
    """Root weighted mean squared error (reference: RMSEEvaluator)."""
    r = scores - labels
    return torch.sqrt(_weighted_mean(r * r, weights))


def squared_loss(scores: Tensor, labels: Tensor,
                 weights: Optional[Tensor] = None) -> Tensor:
    """Mean 0.5(score−label)² (reference: SquaredLossEvaluator)."""
    r = scores - labels
    return _weighted_mean(0.5 * r * r, weights)


def poisson_loss(scores: Tensor, labels: Tensor,
                 weights: Optional[Tensor] = None) -> Tensor:
    """Mean Poisson NLL e^z − y·z at linear scores z (reference:
    PoissonLossEvaluator)."""
    return _weighted_mean(torch.exp(scores) - labels * scores, weights)


def logistic_loss(scores: Tensor, labels: Tensor,
                  weights: Optional[Tensor] = None) -> Tensor:
    """Mean logistic NLL (reference: LogisticLossEvaluator)."""
    return _weighted_mean(torch.nn.functional.softplus(scores)
                          - labels * scores, weights)


def precision_at_k(scores: Tensor, labels: Tensor, k: int) -> Tensor:
    """Fraction of positives among the k highest-scored examples (ties
    go to the earlier example, as ``lax.top_k`` breaks them)."""
    kk = min(k, scores.shape[0])
    idx = torch.argsort(-scores, stable=True)[:kk]
    return torch.mean(labels[idx].to(torch.float32))


# ------------------------------------------------------------- grouped metrics


def _segment_sum(x: Tensor, seg: Tensor, num: int) -> Tensor:
    """(num,) sums of ``x`` over the segments of ``seg``, which must be
    sorted ascending (contiguous segments): differences of one float64
    prefix sum, cast back to ``x``'s dtype."""
    counts = torch.bincount(seg, minlength=num)[:num]
    ends = torch.cumsum(counts, 0)
    c = torch.cat([x.new_zeros(1, dtype=torch.float64),
                   torch.cumsum(x.to(torch.float64), 0)])
    return (c[ends] - c[ends - counts]).to(x.dtype)


def _group_sort(scores: Tensor, group_ids: Tensor) -> Tensor:
    """Order examples by (group, score asc) via two stable argsorts."""
    order1 = torch.argsort(scores, stable=True)
    order2 = torch.argsort(group_ids[order1], stable=True)
    return order1[order2]


def grouped_auc(scores: Tensor, labels: Tensor, group_ids: Tensor,
                num_groups: int, weights: Optional[Tensor] = None
                ) -> tuple[Tensor, Tensor]:
    """Per-group tie-averaged AUC for ALL groups at once.

    Returns ``(per_group_auc, valid)`` where ``valid`` marks groups having
    at least one positive and one negative (the reference's
    MultiAUCEvaluator skips one-class groups). With ``weights``, each
    group's statistic is the weighted P(score+ > score-) with half credit
    on ties, and ``valid`` requires positive weight on both classes.
    """
    group_ids = group_ids.long()
    order = _group_sort(scores, group_ids)
    g = group_ids[order]
    s = scores[order]
    y = labels[order].to(torch.float32)
    n = scores.shape[0]
    # Tie runs within (group, score).
    prev_same = (g == torch.roll(g, 1)) & (s == torch.roll(s, 1))
    if n:
        prev_same[0] = False
    run_id = torch.cumsum((~prev_same).long(), 0) - 1

    if weights is not None:
        w = weights[order].to(torch.float32)
        wpos = w * y
        wneg = w * (1.0 - y)
        # Within-group exclusive cumulative negative weight (the layout is
        # group-major, so subtract each group's exclusive prefix).
        cn = torch.cumsum(wneg, 0)
        grp_tot_neg = _segment_sum(wneg, g, num_groups)
        grp_prefix = torch.cumsum(grp_tot_neg, 0) - grp_tot_neg
        within_excl = cn - wneg - grp_prefix[g]
        # Strictly-below credit stops at the tie run's first element,
        # where the non-decreasing within_excl takes its run minimum.
        run_first = torch.cumsum(torch.bincount(run_id, minlength=n), 0) \
            - torch.bincount(run_id, minlength=n)
        below_run = within_excl[run_first[run_id]]
        run_neg = _segment_sum(wneg, run_id, n)[run_id]
        credit = wpos * (below_run + 0.5 * (run_neg - wneg))
        wp = _segment_sum(wpos, g, num_groups)
        wn = grp_tot_neg
        auc_g = _segment_sum(credit, g, num_groups) \
            / torch.clamp(wp * wn, min=1e-12)
        return auc_g, (wp > 0) & (wn > 0)

    pos_idx = torch.arange(n, dtype=torch.float32, device=scores.device)
    ones = torch.ones_like(pos_idx)
    run_pos_sum = _segment_sum(pos_idx, run_id, n)
    run_count = _segment_sum(ones, run_id, n)
    avg_pos = (run_pos_sum / torch.clamp(run_count, min=1.0))[run_id]
    counts = _segment_sum(ones, g, num_groups)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    rank_in_group = avg_pos - starts[g] + 1.0
    p = _segment_sum(y, g, num_groups)
    nneg = counts - p
    rank_sum = _segment_sum(rank_in_group * y, g, num_groups)
    auc_g = (rank_sum - p * (p + 1) / 2.0) / torch.clamp(p * nneg,
                                                         min=1e-12)
    return auc_g, (p > 0) & (nneg > 0)


def _mean_valid(metric: Tensor, valid: Tensor) -> Tensor:
    v = valid.to(torch.float32)
    return torch.sum(metric * v) / torch.clamp(torch.sum(v), min=1.0)


def mean_grouped_auc(scores, labels, group_ids, num_groups,
                     weights=None) -> Tensor:
    """Average per-group AUC over valid groups (MultiAUCEvaluator)."""
    return _mean_valid(*grouped_auc(scores, labels, group_ids, num_groups,
                                    weights))


def grouped_precision_at_k(scores: Tensor, labels: Tensor,
                           group_ids: Tensor, num_groups: int, k: int,
                           weights: Optional[Tensor] = None
                           ) -> tuple[Tensor, Tensor]:
    """Per-group precision@k for all groups at once.

    ``valid`` marks groups with at least k examples (reference:
    MultiPrecisionAtKEvaluator filters groups with < k samples). With
    ``weights``, the top k are still chosen by score alone; the precision
    over them is the weighted positive fraction Σ w·y / Σ w, and a group
    whose top k all weigh 0 is not valid.
    """
    group_ids = group_ids.long()
    order = _group_sort(-scores, group_ids)  # score descending per group
    g = group_ids[order]
    y = labels[order].to(torch.float32)
    n = scores.shape[0]
    ones = torch.ones(n, dtype=torch.float32, device=scores.device)
    counts = _segment_sum(ones, g, num_groups)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_group = torch.arange(n, dtype=torch.float32,
                                device=scores.device) - starts[g]
    in_top_k = (pos_in_group < k).to(torch.float32)
    if weights is not None:
        w = weights[order].to(torch.float32)
        hits = _segment_sum(w * y * in_top_k, g, num_groups)
        denom = _segment_sum(w * in_top_k, g, num_groups)
        prec = hits / torch.clamp(denom, min=1e-12)
        return prec, (counts >= k) & (denom > 0)
    hits = _segment_sum(y * in_top_k, g, num_groups)
    denom = torch.clamp(counts, max=float(k))
    return hits / torch.clamp(denom, min=1.0), counts >= k


def mean_grouped_precision_at_k(scores, labels, group_ids, num_groups, k,
                                weights=None) -> Tensor:
    return _mean_valid(*grouped_precision_at_k(
        scores, labels, group_ids, num_groups, k, weights))


# ---------------------------------------------------------- evaluator objects


class MetricDirection(enum.Enum):
    HIGHER_IS_BETTER = "higher"
    LOWER_IS_BETTER = "lower"


@dataclasses.dataclass(frozen=True)
class EvaluatorType:
    """Parsed evaluator spec (reference: EvaluatorType.scala).

    Accepts: ``AUC``, ``RMSE``, ``SQUARED_LOSS``, ``POISSON_LOSS``,
    ``LOGISTIC_LOSS``, ``PRECISION@k``, and grouped forms ``AUC@col`` /
    ``PRECISION@k@col`` (metric per value of the id column ``col``,
    averaged).
    """

    name: str
    k: Optional[int] = None
    group_column: Optional[str] = None

    @property
    def direction(self) -> MetricDirection:
        if self.name in ("AUC", "PRECISION"):
            return MetricDirection.HIGHER_IS_BETTER
        return MetricDirection.LOWER_IS_BETTER

    def better_than(self, a: float, b: float) -> bool:
        if self.direction == MetricDirection.HIGHER_IS_BETTER:
            return a > b
        return a < b

    def __str__(self) -> str:
        parts = [self.name]
        if self.k is not None:
            parts.append(str(self.k))
        if self.group_column is not None:
            parts.append(self.group_column)
        return "@".join(parts)

    @staticmethod
    def parse(spec: str) -> "EvaluatorType":
        s = spec.strip()
        m = re.fullmatch(r"(?i)PRECISION@(\d+)(?:@(\w+))?", s)
        if m:
            return EvaluatorType("PRECISION", k=int(m.group(1)),
                                 group_column=m.group(2))
        m = re.fullmatch(r"(?i)(AUC|RMSE|SQUARED_LOSS|POISSON_LOSS|"
                         r"LOGISTIC_LOSS)(?:@(\w+))?", s)
        if m:
            name = m.group(1).upper()
            group = m.group(2)
            if group is not None and name != "AUC":
                raise ValueError(f"grouped form not supported for {name}")
            return EvaluatorType(name, group_column=group)
        raise ValueError(f"unrecognized evaluator spec: {spec!r}")


def evaluate(etype: EvaluatorType, scores: Tensor, labels: Tensor,
             weights: Optional[Tensor] = None,
             group_ids: Optional[Tensor] = None,
             num_groups: Optional[int] = None) -> Tensor:
    """Compute one metric (reference: Evaluator.evaluate on a score
    RDD)."""
    if etype.group_column is not None:
        if group_ids is None or num_groups is None:
            raise ValueError(f"{etype} needs group_ids/num_groups")
        if etype.name == "AUC":
            return mean_grouped_auc(scores, labels, group_ids, num_groups,
                                    weights)
        if etype.name == "PRECISION":
            return mean_grouped_precision_at_k(scores, labels, group_ids,
                                               num_groups, etype.k, weights)
        raise ValueError(etype)  # pragma: no cover
    if etype.name == "AUC":
        return auc(scores, labels, weights)
    if etype.name == "RMSE":
        return rmse(scores, labels, weights)
    if etype.name == "SQUARED_LOSS":
        return squared_loss(scores, labels, weights)
    if etype.name == "POISSON_LOSS":
        return poisson_loss(scores, labels, weights)
    if etype.name == "LOGISTIC_LOSS":
        return logistic_loss(scores, labels, weights)
    if etype.name == "PRECISION":
        return precision_at_k(scores, labels, etype.k)
    raise ValueError(etype)  # pragma: no cover


@dataclasses.dataclass
class EvaluationResults:
    """Metric values keyed by evaluator spec; the first entry is primary.

    Reference parity: EvaluationResults.scala (the primary evaluator
    drives model selection in GameEstimator).
    """

    metrics: dict[str, float]
    primary: str

    @property
    def primary_value(self) -> float:
        return self.metrics[self.primary]

    def better_than(self, other: Optional["EvaluationResults"]) -> bool:
        if other is None:
            return True
        et = EvaluatorType.parse(self.primary)
        return et.better_than(self.primary_value, other.primary_value)


def evaluation_suite(specs: list[str], scores: Tensor, labels,
                     weights=None,
                     group_ids_by_column: Optional[dict] = None,
                     num_groups_by_column: Optional[dict[str, int]] = None
                     ) -> EvaluationResults:
    """Run several evaluators over one score set (EvaluationSuite.scala).
    Labels, weights and group ids (tensors or host numpy) move to the
    scores' device once; every metric then runs there."""
    dev = scores.device

    def put(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, Tensor)
                               else x, device=dev).to(dtype)

    labels = put(labels, torch.float32)
    weights = None if weights is None else put(weights, torch.float32)
    metrics: dict[str, float] = {}
    for spec in specs:
        et = EvaluatorType.parse(spec)
        gids = ngroups = None
        if et.group_column is not None:
            raw = (group_ids_by_column or {}).get(et.group_column)
            gids = None if raw is None else put(raw, torch.int64)
            ngroups = (num_groups_by_column or {}).get(et.group_column)
        metrics[str(et)] = float(evaluate(et, scores, labels, weights,
                                          gids, ngroups))
    return EvaluationResults(metrics=metrics, primary=str(
        EvaluatorType.parse(specs[0])))
