"""Sparse GLM fit on one device: the Criteo-path optimization problem.

The single-device counterpart of ``photon_ml_tpu/parallel/sparse_problem.run``
and of its objectives ``parallel/sparse_objective.make_value_and_gradient``
/ ``make_hvp`` / ``make_hessian_diagonal`` on a one-device mesh, as
``optim/problem.run`` is of the dense ``parallel/problem.run``. Reference
parity: optimization/DistributedOptimizationProblem.scala bound to a
sparse DistributedGLMLossFunction. The optimizers are the dense path's
(L-BFGS / OWL-QN / TRON on the (d,) coefficient vector, as one lane);
only the objective evaluation is sparse (``ops/sparse_aggregators.py``).

Not ported: the mesh and ``feature_sharded=True`` (the coefficient
dimension sharded over a ``model`` axis), which are slice 9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_torch import not_ported
from photon_ml_torch.data.sparse import SparseBatch
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops import sparse_aggregators as sagg
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.optim import (OptResult, l1_weights_vector, optimize,
                                   with_l2, with_l2_hvp)
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType,
                                           resolve_optimizer_config,
                                           variances_from_diagonal)
from photon_ml_torch.optim.regularization import intercept_mask

Tensor = torch.Tensor


@dataclasses.dataclass
class SolveStats:
    """What one solve cost: objective evaluations by kind. Each one runs
    the ``ell_scatter`` kernel once on a CUDA batch."""

    gradient_evaluations: int = 0
    hessian_vector_products: int = 0


def make_value_and_gradient(loss: PointwiseLoss, batch: SparseBatch,
                            stats: Optional[SolveStats] = None):
    """(w (L, d)) → (value (L,), grad (L, d)), one lane at a time over the
    staged batch (a fixed effect is one lane)."""
    def vg(w: Tensor):
        if stats is not None:
            stats.gradient_evaluations += w.shape[0]
        pairs = [sagg.value_and_gradient(loss, lane, batch) for lane in w]
        return (torch.stack([v for v, _ in pairs]),
                torch.stack([g for _, g in pairs]))

    return vg


def make_hvp(loss: PointwiseLoss, batch: SparseBatch,
             stats: Optional[SolveStats] = None):
    """(w, v (L, d)) → H·v (L, d), TRON's inner product."""
    def hvp(w: Tensor, v: Tensor) -> Tensor:
        if stats is not None:
            stats.hessian_vector_products += w.shape[0]
        return torch.stack([sagg.hessian_vector(loss, wl, vl, batch)
                            for wl, vl in zip(w, v)])

    return hvp


def make_hessian_diagonal(loss: PointwiseLoss, batch: SparseBatch):
    """(w (d,)) → diag(H) (d,), for SIMPLE variances."""
    return lambda w: sagg.hessian_diagonal(loss, w, batch)


def run(loss: PointwiseLoss, batch: SparseBatch,
        config: GLMOptimizationConfiguration,
        initial: Optional[Coefficients] = None,
        intercept_index: Optional[int] = None,
        feature_sharded: bool = False,
        stats: Optional[SolveStats] = None
        ) -> tuple[Coefficients, OptResult]:
    """Fit one sparse GLM on ``batch``'s device; returns (d,) coefficients
    and the one-lane OptResult. ``stats``, when given, counts the
    objective evaluations."""
    if feature_sharded:
        raise not_ported("feature_sharded=True (the coefficient dimension "
                         "sharded over a model mesh axis)", 9)
    dim = batch.num_features
    dev = batch.device
    mask = torch.as_tensor(intercept_mask(dim, intercept_index), device=dev)
    reg = config.regularization
    l2 = reg.l2_weight()
    vg = with_l2(make_value_and_gradient(loss, batch, stats), l2, mask)
    hvp = with_l2_hvp(make_hvp(loss, batch, stats), l2, mask)
    l1 = reg.l1_weight()
    l1w = (l1_weights_vector(l1, dim, intercept_index, device=dev)
           if l1 > 0.0 else None)
    opt_cfg = resolve_optimizer_config(config.optimizer, l1w is not None)
    w0 = (initial.means.to(device=dev, dtype=torch.float32)
          if initial is not None else
          torch.zeros(dim, dtype=torch.float32, device=dev))
    result = optimize(vg, w0.unsqueeze(0), opt_cfg, hvp=hvp, l1_weights=l1w)
    w = result.w[0]
    variances = None
    kind = VarianceComputationType(config.variance_computation)
    if kind == VarianceComputationType.SIMPLE:
        diag = make_hessian_diagonal(loss, batch)(w)
        variances = variances_from_diagonal(diag, l2, mask)
    elif kind == VarianceComputationType.FULL:
        raise NotImplementedError(
            "FULL variance needs the dense d×d Hessian — not available at "
            "sparse/Criteo scale (use SIMPLE, as the reference does)")
    return Coefficients(means=w, variances=variances), result
