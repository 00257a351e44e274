"""Task types (port of ``TaskType`` in ``photon_ml_tpu/types.py``).

Reference parity: photon-lib ``TaskType.scala``.
"""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    """Supported training tasks (reference: photon-lib TaskType.scala)."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @property
    def is_classification(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )
