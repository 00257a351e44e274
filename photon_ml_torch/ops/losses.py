"""Pointwise GLM losses: l(margin, label) and its d/dmargin derivatives.

Port of ``photon_ml_tpu/ops/losses.py``. Reference parity: photon-lib
``function/glm/PointwiseLossFunction.scala`` (``lossAndDzLoss`` /
``DzzLoss``) and its logistic, squared and Poisson implementations, plus
the smoothed hinge in ``function/svm/SingleNodeSmoothedHingeLossFunction``.

Each loss is a set of elementwise functions of ``(margin, label)``
tensors, so they run on whatever device the tensors are on.

Labels: logistic and smoothed hinge expect labels in {0, 1}; the hinge
converts internally to {-1, +1}. Poisson expects non-negative counts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss l(margin, label) with closed-form margin derivatives.

    ``loss_and_dz`` returns ``(l, dl/dz)``; ``d2z`` returns d²l/dz², used
    by Hessian-vector and Hessian-diagonal products.
    """

    name: str
    loss_and_dz: Callable[[Tensor, Tensor], tuple[Tensor, Tensor]]
    d2z: Callable[[Tensor, Tensor], Tensor]
    # The inverse link ("mean function") for scoring: E[y] = mean(margin).
    mean: Callable[[Tensor], Tensor]

    def loss(self, margin: Tensor, label: Tensor) -> Tensor:
        return self.loss_and_dz(margin, label)[0]

    def dz(self, margin: Tensor, label: Tensor) -> Tensor:
        return self.loss_and_dz(margin, label)[1]


def _logistic_loss_and_dz(margin: Tensor, label: Tensor
                          ) -> tuple[Tensor, Tensor]:
    # l = log(1 + e^z) - y*z, computed stably as softplus(z) - y*z, with
    # softplus(z) = logaddexp(z, 0) as the reference computes it
    # (F.softplus returns z itself above its threshold of 20).
    l = torch.logaddexp(margin, torch.zeros_like(margin)) - label * margin
    dl = torch.sigmoid(margin) - label
    return l, dl


def _logistic_d2z(margin: Tensor, label: Tensor) -> Tensor:
    del label
    s = torch.sigmoid(margin)
    return s * (1.0 - s)


def _squared_loss_and_dz(margin: Tensor, label: Tensor
                         ) -> tuple[Tensor, Tensor]:
    r = margin - label
    return 0.5 * r * r, r


def _squared_d2z(margin: Tensor, label: Tensor) -> Tensor:
    del label
    return torch.ones_like(margin)


def _poisson_loss_and_dz(margin: Tensor, label: Tensor
                         ) -> tuple[Tensor, Tensor]:
    # Negative log-likelihood up to the label-only constant log(y!):
    # l = e^z - y*z;  dl = e^z - y.
    ez = torch.exp(margin)
    return ez - label * margin, ez - label


def _poisson_d2z(margin: Tensor, label: Tensor) -> Tensor:
    del label
    return torch.exp(margin)


def _smoothed_hinge_loss_and_dz(margin: Tensor, label: Tensor
                                ) -> tuple[Tensor, Tensor]:
    # Rennie's smoothed hinge on the product t = y*z with y in {-1,+1}
    # (labels arrive in {0,1}):
    #   l(t) = 1/2 - t        t <= 0
    #   l(t) = (1 - t)^2 / 2  0 < t < 1
    #   l(t) = 0              t >= 1
    y = 2.0 * label - 1.0
    t = y * margin
    zero = torch.zeros_like(t)
    l = torch.where(t <= 0.0, 0.5 - t,
                    torch.where(t < 1.0, 0.5 * (1.0 - t) ** 2, zero))
    dl_dt = torch.where(t <= 0.0, -torch.ones_like(t),
                        torch.where(t < 1.0, t - 1.0, zero))
    return l, y * dl_dt


def _smoothed_hinge_d2z(margin: Tensor, label: Tensor) -> Tensor:
    y = 2.0 * label - 1.0
    t = y * margin
    return ((t > 0.0) & (t < 1.0)).to(margin.dtype)


def _identity(z: Tensor) -> Tensor:
    return z


LOGISTIC = PointwiseLoss(
    name="logistic",
    loss_and_dz=_logistic_loss_and_dz,
    d2z=_logistic_d2z,
    mean=torch.sigmoid,
)

SQUARED = PointwiseLoss(
    name="squared",
    loss_and_dz=_squared_loss_and_dz,
    d2z=_squared_d2z,
    mean=_identity,
)

POISSON = PointwiseLoss(
    name="poisson",
    loss_and_dz=_poisson_loss_and_dz,
    d2z=_poisson_d2z,
    mean=torch.exp,
)

SMOOTHED_HINGE = PointwiseLoss(
    name="smoothed_hinge",
    loss_and_dz=_smoothed_hinge_loss_and_dz,
    d2z=_smoothed_hinge_d2z,
    # Scoring for the linear SVM is the raw margin; classification applies
    # a threshold at 0 (reference: SmoothedHingeLossLinearSVMModel.scala).
    mean=_identity,
)

_BY_NAME = {
    loss.name: loss for loss in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE)
}


def get_loss(name: str) -> PointwiseLoss:
    return _BY_NAME[name]


def loss_for_task(task) -> PointwiseLoss:
    """Map a TaskType to its pointwise loss."""
    return {
        TaskType.LOGISTIC_REGRESSION: LOGISTIC,
        TaskType.LINEAR_REGRESSION: SQUARED,
        TaskType.POISSON_REGRESSION: POISSON,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SMOOTHED_HINGE,
    }[TaskType(task)]
