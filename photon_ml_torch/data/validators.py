"""Input-data sanity validation.

Port of ``photon_ml_tpu/data/validators.py``. Reference parity:
photon-client ``DataValidators.scala``: before training, check that the
data is sane for the task: features, offsets and weights finite, weights
non-negative (zero weights are legal per-row masks, but an all-zero
weight column is a degenerate model and draws a warning), and labels
valid for the objective (binary for logistic and smoothed-hinge, finite
for linear regression, non-negative for Poisson). The validation levels
(VALIDATE_FULL / VALIDATE_SAMPLE / DISABLED) are ``level``.

Host-side numpy checks, one vectorized pass per array; tensors are read
back to the host first. Under VALIDATE_SAMPLE the rows checked are the
reference's for the same seed.
"""

from __future__ import annotations

import enum
import logging

import numpy as np
import torch

from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)


class DataValidationLevel(enum.Enum):
    """Reference: DataValidationType (VALIDATE_FULL / VALIDATE_SAMPLE /
    DISABLED)."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    DISABLED = "DISABLED"


_SAMPLE = 10_000  # rows checked under VALIDATE_SAMPLE


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rows(n: int, level: DataValidationLevel, rng: np.random.Generator):
    """Row subset to check: None means ALL rows (checked in place, no
    gather copy). Sampling draws with replacement (rng.integers) — O(k)
    rather than the O(n) permutation rng.choice(replace=False) costs."""
    if level == DataValidationLevel.VALIDATE_SAMPLE and n > _SAMPLE:
        return np.unique(rng.integers(0, n, size=_SAMPLE))
    return None


def _take(a: np.ndarray, idx):
    return a if idx is None else a[idx]


def _orig_row(idx, i: int) -> int:
    """Map a position in the checked subset back to the dataset row."""
    return int(i) if idx is None else int(idx[i])


def _check_finite(name: str, a: np.ndarray, idx=None) -> None:
    checked = _take(a, idx)
    bad = ~np.isfinite(checked)
    if bad.any():
        flat = int(np.flatnonzero(bad.reshape(-1))[0])
        row, rest = flat // int(np.prod(checked.shape[1:], dtype=int) or 1), \
            flat % int(np.prod(checked.shape[1:], dtype=int) or 1)
        loc = f"row {_orig_row(idx, row)}"
        if checked.ndim > 1:
            loc += f", flat offset {rest} within the row"
        raise ValueError(
            f"{name} contains {int(bad.sum())} non-finite value(s) in the "
            f"checked rows; first at {loc} "
            f"({checked.reshape(-1)[flat]})")


def validate_labels(task: TaskType, labels, _idx=None) -> None:
    """Per-task label validity (reference: *LabelValidator per TaskType)."""
    labels = _host(labels)
    _check_finite("labels", labels, _idx)
    checked = _take(labels, _idx)
    task = TaskType(task)
    if task in (TaskType.LOGISTIC_REGRESSION,
                TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        bad = ~np.isin(checked, (0.0, 1.0))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"binary classification needs labels in {{0, 1}}; "
                f"{int(bad.sum())} invalid in the checked rows (first: "
                f"labels[{_orig_row(_idx, i)}] = {checked[i]})")
    elif task == TaskType.POISSON_REGRESSION:
        bad = checked < 0.0
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"Poisson regression needs non-negative labels; "
                f"{int(bad.sum())} negative in the checked rows (first: "
                f"labels[{_orig_row(_idx, i)}] = {checked[i]})")


def validate_arrays(
    task: TaskType,
    labels,
    weights=None,
    offsets=None,
    level: DataValidationLevel = DataValidationLevel.VALIDATE_FULL,
    seed: int = 0,
) -> None:
    """Validate the scalar per-example columns."""
    level = DataValidationLevel(level)
    if level == DataValidationLevel.DISABLED:
        return
    rng = np.random.default_rng(seed)
    labels = _host(labels)
    idx = _rows(labels.shape[0], level, rng)
    validate_labels(task, labels, idx)
    if weights is not None:
        weights = _host(weights)
        w = _take(weights, idx)
        _check_finite("weights", weights, idx)
        bad = w < 0.0
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"weights must be >= 0; first negative at row "
                f"{_orig_row(idx, i)} ({w[i]})")
        if w.size and not (w > 0.0).any():
            logger.warning(
                "every checked weight is zero — the objective is "
                "identically 0 and training will produce a degenerate "
                "model (did the weight column default wrong?)")
    if offsets is not None:
        _check_finite("offsets", _host(offsets), idx)


def validate_features(
    name: str,
    shard,
    level: DataValidationLevel = DataValidationLevel.VALIDATE_FULL,
    seed: int = 0,
) -> None:
    """Validate a dense (n, d) matrix or an ELL shard's values."""
    level = DataValidationLevel(level)
    if level == DataValidationLevel.DISABLED:
        return
    rng = np.random.default_rng(seed)
    values = _host(shard.values if hasattr(shard, "values") else shard)
    idx = _rows(values.shape[0], level, rng)
    _check_finite(f"feature shard {name!r}", values, idx)


def validate_game_dataset(
    task: TaskType,
    dataset,
    level: DataValidationLevel = DataValidationLevel.VALIDATE_FULL,
    seed: int = 0,
) -> None:
    """Validate a GameDataset end to end (reference: sanityCheckData on the
    input DataFrame before GameEstimator.fit)."""
    level = DataValidationLevel(level)
    if level == DataValidationLevel.DISABLED:
        return
    validate_arrays(task, dataset.response, dataset.weights, dataset.offsets,
                    level=level, seed=seed)
    for name, shard in dataset.feature_shards.items():
        validate_features(name, shard, level=level, seed=seed)
