"""Optimizers: L-BFGS, OWL-QN and TRON over a leading lane axis.

Port of ``photon_ml_tpu/optim/__init__.py``. Reference parity: photon-lib
``optimization/`` — ``Optimizer.scala``, ``OptimizerFactory.scala``,
``LBFGS.scala``, ``OWLQN.scala``, ``TRON.scala``. The reference's
streamed stochastic solvers (SDCA, SGD) are not optimizer types here.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_torch.optim import lbfgs as _lbfgs
from photon_ml_torch.optim import tron as _tron
from photon_ml_torch.optim.common import (Hvp, OptResult, OptimizerConfig,
                                          OptimizerType, ValueAndGrad)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType,
                                                  intercept_mask,
                                                  l1_weights_vector, with_l2,
                                                  with_l2_hvp)

Tensor = torch.Tensor

minimize_lbfgs = _lbfgs.minimize
minimize_owlqn = _lbfgs.minimize_owlqn
minimize_tron = _tron.minimize


def optimize(value_and_grad: ValueAndGrad, w0: Tensor,
             config: OptimizerConfig, *, hvp: Optional[Hvp] = None,
             l1_weights: Optional[Tensor] = None) -> OptResult:
    """Dispatch on OptimizerType (reference: OptimizerFactory.scala).

    ``w0`` is (lanes, d). ``value_and_grad`` must already include any L2
    term (use ``with_l2``); ``l1_weights`` routes to OWL-QN; TRON
    additionally needs ``hvp``.
    """
    t = OptimizerType(config.optimizer_type)
    if t == OptimizerType.LBFGS:
        if l1_weights is not None:
            raise ValueError("L1 regularization requires OWLQN, not LBFGS")
        return minimize_lbfgs(value_and_grad, w0, config)
    if t == OptimizerType.OWLQN:
        if l1_weights is None:
            raise ValueError("OWLQN requires l1_weights (else use LBFGS)")
        return minimize_owlqn(value_and_grad, w0, l1_weights, config)
    if t == OptimizerType.TRON:
        if hvp is None:
            raise ValueError("TRON requires a Hessian-vector product (hvp)")
        if l1_weights is not None:
            raise ValueError("TRON does not support L1 (reference parity)")
        return minimize_tron(value_and_grad, hvp, w0, config)
    raise ValueError(t)  # pragma: no cover


__all__ = [
    "OptResult", "OptimizerConfig", "OptimizerType", "ValueAndGrad", "Hvp",
    "RegularizationContext", "RegularizationType",
    "minimize_lbfgs", "minimize_owlqn", "minimize_tron", "optimize",
    "with_l2", "with_l2_hvp", "l1_weights_vector", "intercept_mask",
]
