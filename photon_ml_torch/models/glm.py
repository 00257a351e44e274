"""Generalized linear model.

Port of ``photon_ml_tpu/models/glm.py``. Reference parity: photon-lib
``supervised/model/GeneralizedLinearModel.scala`` and its subclasses
(``LogisticRegressionModel``, ``SmoothedHingeLossLinearSVMModel``,
``LinearRegressionModel``, ``PoissonRegressionModel``): score =
wᵀx + offset, mean = link⁻¹(score), and a threshold rule for the
classifiers.

One dataclass parameterized by TaskType rather than a class hierarchy:
the behavior differences are exactly (loss, mean function,
classification threshold), all derivable from the task.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops import losses
from photon_ml_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A trained GLM: task + coefficients (raw/original feature space)."""

    task: TaskType
    coefficients: Coefficients

    def compute_score(self, features: Tensor,
                      offsets: Optional[Tensor] = None) -> Tensor:
        """Linear score wᵀx (+ offset) — reference ``computeScore``."""
        s = features @ self.coefficients.means
        if offsets is not None:
            s = s + offsets
        return s

    def compute_mean(self, features: Tensor,
                     offsets: Optional[Tensor] = None) -> Tensor:
        """E[y|x] through the inverse link — reference ``computeMean``."""
        loss = losses.loss_for_task(self.task)
        return loss.mean(self.compute_score(features, offsets))

    def predict_class(self, features: Tensor, threshold: float = 0.5,
                      offsets: Optional[Tensor] = None) -> Tensor:
        """Binary prediction for classification tasks.

        Logistic thresholds the probability; the smoothed-hinge SVM has no
        probability and thresholds the raw margin at 0, so it accepts only
        the default threshold (reference behavior).
        """
        task = TaskType(self.task)
        if not task.is_classification:
            raise ValueError(f"{task} is not a classification task")
        if task == TaskType.LOGISTIC_REGRESSION:
            return (self.compute_mean(features, offsets)
                    >= threshold).to(torch.float32)
        if threshold != 0.5:
            raise ValueError(
                "smoothed-hinge SVM predictions threshold the raw margin at "
                "0; a probability threshold does not apply")
        return (self.compute_score(features, offsets) >= 0.0).to(
            torch.float32)


# Convenience constructors mirroring the reference's concrete classes.

def logistic_regression_model(coefficients: Coefficients
                              ) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.LOGISTIC_REGRESSION, coefficients)


def linear_regression_model(coefficients: Coefficients
                            ) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.LINEAR_REGRESSION, coefficients)


def poisson_regression_model(coefficients: Coefficients
                             ) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.POISSON_REGRESSION, coefficients)


def smoothed_hinge_svm_model(coefficients: Coefficients
                             ) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
                                  coefficients)
