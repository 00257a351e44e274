"""GLM optimization problems: bind loss + data + regularization + optimizer.

Port of ``photon_ml_tpu/optim/problem.py``. Reference parity: photon-api
``optimization/GeneralizedLinearOptimizationProblem.scala`` /
``SingleNodeOptimizationProblem.scala`` and the config bundle in
photon-lib ``optimization/game/GLMOptimizationConfiguration.scala``.

Variance computation (reference ``computeVariances``,
``VarianceComputationType``): SIMPLE = 1/diag(H); FULL = diag(H⁻¹).

The objectives take a leading lane axis (see ``ops/aggregators.py``):
over a bucket batch (E_b, cap, d) each lane is one entity's problem; over
a flat (n, d) batch one lane is the whole problem, and :func:`run_grid`
solves one lane per L2 weight of a grid over the same rows.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops import aggregators as agg
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.optim import (OptimizerConfig, OptimizerType, OptResult,
                                   RegularizationContext, l1_weights_vector,
                                   optimize, with_l2, with_l2_hvp)
from photon_ml_torch.optim.regularization import intercept_mask

Tensor = torch.Tensor


class VarianceComputationType(enum.Enum):
    NONE = "NONE"
    SIMPLE = "SIMPLE"  # 1 / diag(H)
    FULL = "FULL"  # diag(H^-1): materializes H, small d only


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """(optimizer, regularization, variance) bundle for one coordinate.

    Reference parity: GLMOptimizationConfiguration.scala.
    """

    optimizer: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = RegularizationContext()
    variance_computation: VarianceComputationType = \
        VarianceComputationType.NONE
    # Down-sampling rate for this coordinate (1.0 = off); applied by the
    # coordinate, not here (reference: DownSampler).
    down_sampling_rate: float = 1.0


def resolve_optimizer_config(opt_cfg: OptimizerConfig,
                             has_l1: bool) -> OptimizerConfig:
    """L1/elastic-net silently selects OWL-QN (reference behavior)."""
    if has_l1 and OptimizerType(opt_cfg.optimizer_type) == OptimizerType.LBFGS:
        return dataclasses.replace(opt_cfg, optimizer_type=OptimizerType.OWLQN)
    return opt_cfg


def variances_from_diagonal(diag: Tensor, l2: float,
                            reg_mask: Tensor) -> Tensor:
    """SIMPLE variances: elementwise 1/(diag(H) + λ·mask)."""
    return 1.0 / torch.clamp(diag + l2 * reg_mask, min=1e-12)


def variances_from_matrix(H: Tensor, l2: float, reg_mask: Tensor) -> Tensor:
    """FULL variances: diag(H⁻¹) with the L2 term on the diagonal, over
    any leading lane axes of H (..., d, d)."""
    dim = H.shape[-1]
    eye = torch.eye(dim, dtype=H.dtype, device=H.device)
    H = H + torch.diag(l2 * reg_mask) + 1e-9 * eye
    return torch.diagonal(torch.linalg.solve(H, eye.expand_as(H)),
                          dim1=-2, dim2=-1)


def _mask(dim: int, intercept_index: Optional[int], like: Tensor) -> Tensor:
    return torch.as_tensor(intercept_mask(dim, intercept_index),
                           device=like.device)


def make_objective(loss: PointwiseLoss, batch: LabeledBatch,
                   norm: NormalizationContext, reg: RegularizationContext,
                   intercept_index: Optional[int], dim: int):
    """(value_and_grad, hvp, l1_weights) for a batch; each takes (L, d)
    coefficients."""
    mask = _mask(dim, intercept_index, batch.features)

    def vg(w: Tensor):
        return agg.value_and_gradient(loss, w, batch, norm)

    def hvp(w: Tensor, v: Tensor):
        return agg.hessian_vector(loss, w, v, batch, norm)

    l2 = reg.l2_weight()
    vg = with_l2(vg, l2, mask)
    hvp = with_l2_hvp(hvp, l2, mask)
    l1 = reg.l1_weight()
    l1_weights = (l1_weights_vector(l1, dim, intercept_index,
                                    device=batch.features.device)
                  if l1 > 0.0 else None)
    return vg, hvp, l1_weights


def run(loss: PointwiseLoss, batch: LabeledBatch,
        config: GLMOptimizationConfiguration,
        initial: Optional[Coefficients] = None,
        norm: NormalizationContext = NormalizationContext(),
        intercept_index: Optional[int] = None
        ) -> tuple[Coefficients, OptResult]:
    """Solve one GLM on one flat (n, d) batch
    (SingleNodeOptimizationProblem.run): one lane. The coefficients come
    back as (d,); the OptResult keeps its lane axis of 1."""
    dim = batch.dim
    w0 = initial.means if initial is not None else batch.features.new_zeros(
        (dim,), dtype=torch.float32)
    vg, hvp, l1w = make_objective(loss, batch, norm, config.regularization,
                                  intercept_index, dim)
    opt_cfg = resolve_optimizer_config(config.optimizer, l1w is not None)
    result = optimize(vg, w0.unsqueeze(0), opt_cfg, hvp=hvp, l1_weights=l1w)
    w = result.w[0]
    variances = compute_variances(loss, w, batch, norm,
                                  config.variance_computation,
                                  config.regularization, intercept_index)
    return Coefficients(means=w, variances=variances), result


def run_grid(loss: PointwiseLoss, batch: LabeledBatch,
             config: GLMOptimizationConfiguration, lambdas,
             initial: Optional[Coefficients] = None,
             norm: NormalizationContext = NormalizationContext(),
             intercept_index: Optional[int] = None
             ) -> tuple[Tensor, OptResult]:
    """Fit the SAME GLM at every L2 weight in ``lambdas`` in one solve,
    one lane per weight (port of ``photon_ml_tpu/parallel/problem.py``'s
    ``run_grid``, which vmaps the solver over λ; here on one device).

    Each evaluation reads the rows once for every lane, and λ is an
    (L, 1) tensor folded in as ``f + ½λ‖w∘mask‖²`` and ``g + λ·w∘mask``.
    Returns ``(W, result)`` with ``W`` of shape (len(lambdas), dim) and
    the OptResult's per-lane rows. L2/NONE regularization with
    L-BFGS/TRON only: L1 grids (OWL-QN's per-λ orthant sets) and
    variance computation stay on the sequential :func:`run` path.
    """
    reg = config.regularization
    if reg.l1_weight() > 0.0:
        raise ValueError("run_grid handles L2/NONE grids; L1 grids use "
                         "sequential run() (OWL-QN per-λ orthant sets)")
    if OptimizerType(config.optimizer.optimizer_type) == OptimizerType.OWLQN:
        raise ValueError("run_grid supports L-BFGS/TRON; OWL-QN exists for "
                         "L1 objectives, which run_grid does not handle")
    if VarianceComputationType(config.variance_computation) != \
            VarianceComputationType.NONE:
        raise ValueError("run_grid does not compute variances; evaluate "
                         "them per selected model via run()")
    dim = batch.dim
    X = batch.features
    mask = _mask(dim, intercept_index, X)
    lam = torch.as_tensor(lambdas, dtype=torch.float32,
                          device=X.device).reshape(-1, 1)

    def vg(w: Tensor):
        f, g = agg.value_and_gradient(loss, w, batch, norm)
        wm = w * mask
        return (f + 0.5 * lam[:, 0] * torch.sum(wm * wm, dim=-1),
                g + lam * wm)

    def hvp(w: Tensor, v: Tensor):
        return agg.hessian_vector(loss, w, v, batch, norm) + lam * (v * mask)

    opt_cfg = resolve_optimizer_config(config.optimizer, False)
    w0 = initial.means if initial is not None else X.new_zeros(
        (dim,), dtype=torch.float32)
    result = optimize(vg, w0.expand(lam.shape[0], dim).clone(), opt_cfg,
                      hvp=hvp)
    return result.w, result


def compute_variances(loss: PointwiseLoss, w: Tensor, batch: LabeledBatch,
                      norm: NormalizationContext,
                      kind: VarianceComputationType,
                      reg: RegularizationContext,
                      intercept_index: Optional[int]) -> Optional[Tensor]:
    """Coefficient variance estimates from the Hessian at the optimum.

    Reference parity: GeneralizedLinearOptimizationProblem.computeVariances:
    SIMPLE → elementwise 1/diag(H); FULL → diag(H⁻¹). L2 contributes λ to
    regularized diagonal entries.
    """
    kind = VarianceComputationType(kind)
    if kind == VarianceComputationType.NONE:
        return None
    l2 = reg.l2_weight()
    mask = _mask(w.shape[-1], intercept_index, w)
    if kind == VarianceComputationType.SIMPLE:
        return variances_from_diagonal(
            agg.hessian_diagonal(loss, w, batch, norm), l2, mask)
    return variances_from_matrix(
        agg.hessian_matrix(loss, w, batch, norm), l2, mask)
