"""Shared optimizer scaffolding: configs, results, convergence.

Port of ``photon_ml_tpu/optim/common.py``. Reference parity: photon-lib
``optimization/Optimizer.scala``, ``OptimizerConfig.scala``,
``OptimizerType.scala``, ``OptimizationStatesTracker.scala``.

The optimizers run over an explicit leading lane axis: one solve is one
lane, a random-effect bucket is thousands. Each lane stops on its own;
``masked_update`` freezes the lanes that have, so they are not
perturbed by the steps the others still take. Per-iteration (value,
grad-norm) history goes into preallocated ``max_iterations + 1`` buffers,
NaN past the end (the ``OptimizationStatesTracker`` analogue).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

Tensor = torch.Tensor

# objective(w (L, d)) -> (value (L,), grad (L, d)). Regularization is
# folded in by the caller (photon_ml_torch/optim/regularization.py).
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]
# hvp(w, v) -> H·v, for TRON.
Hvp = Callable[[Tensor, Tensor], Tensor]


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    TRON = "TRON"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Reference parity: OptimizerConfig (type, maxIter, tolerance)."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    # L-BFGS/OWL-QN history length (Breeze default m=10).
    history_length: int = 10
    # Max line-search / inner-CG steps.
    max_line_search_steps: int = 25
    max_cg_iterations: int = 20
    # Strong-Wolfe constants (Breeze StrongWolfeLineSearch defaults):
    # sufficient decrease c1, curvature c2.
    wolfe_c1: float = 1e-4
    wolfe_c2: float = 0.9


@dataclasses.dataclass(frozen=True)
class OptResult:
    """Final state and per-iteration history, one row per lane."""

    w: Tensor  # (L, d)
    value: Tensor  # (L,)
    grad_norm: Tensor  # (L,)
    iterations: Tensor  # (L,) iterations actually executed
    converged: Tensor  # (L,) bool
    value_history: Tensor  # (L, max_iterations + 1), NaN past the end
    grad_norm_history: Tensor  # (L, max_iterations + 1), NaN past the end


def masked_update(frozen: Tensor, new, old):
    """``new`` where the lane is live, ``old`` where ``frozen``: over a
    tensor, a tuple or list, or a dataclass of them. ``frozen`` is (L,)
    and broadcasts over each tensor's trailing axes."""
    if isinstance(new, Tensor):
        c = frozen.reshape(frozen.shape + (1,) * (new.dim() - frozen.dim()))
        return torch.where(c, old, new)
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: masked_update(frozen, getattr(new, f.name),
                                  getattr(old, f.name))
            for f in dataclasses.fields(new)})
    return type(new)(masked_update(frozen, n, o) for n, o in zip(new, old))


def check_convergence(value: Tensor, prev_value: Tensor, grad_norm: Tensor,
                      initial_grad_norm: Tensor, tolerance: float) -> Tensor:
    """Relative gradient norm OR relative objective change below
    tolerance (reference: Optimizer.scala's ``relativeTolerance`` on
    both)."""
    grad_ok = grad_norm <= tolerance * torch.clamp(initial_grad_norm,
                                                   min=1.0)
    val_ok = torch.abs(value - prev_value) <= tolerance * torch.clamp(
        torch.abs(prev_value), min=1e-12)
    return grad_ok | val_ok
