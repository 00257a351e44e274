"""TRON: Trust-Region Newton with conjugate-gradient inner solves.

Port of ``photon_ml_tpu/optim/tron.py``. Reference parity: photon-lib
``optimization/TRON.scala`` — itself a port of LIBLINEAR's tron.cpp (Lin,
Weng & Keerthi 2008): an outer trust-region loop whose step comes from a
Steihaug conjugate-gradient solve of H·s = −g using Hessian-VECTOR
products only (H is never materialized), truncated at the trust-region
boundary. Each CG iteration costs one Hessian-vector product.

Lanes: as in ``optim/lbfgs.py``, every state tensor has a leading lane
axis (L, ...), each loop runs ``while live.any()`` and
:func:`~photon_ml_torch.optim.common.masked_update` keeps a lane's old
state wherever its own condition is false: the outer
``(~converged) & (it < max_iter)`` and CG's
``(~done) & (i < max_cg) & (‖r‖ > cg_tol)``. Lane i of an L-lane solve
takes exactly the steps of a one-lane solve of lane i, so each lane
equals the reference's ``minimize`` on that lane's objective.

Host syncs: one per outer iteration and one per CG step, for all lanes
together (``minimize.host_syncs`` counts them).
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.optim.common import (Hvp, OptResult, OptimizerConfig,
                                          ValueAndGrad, check_convergence,
                                          masked_update)

Tensor = torch.Tensor

# LIBLINEAR trust-region constants (tron.cpp).
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
# CG stops once ‖r‖ falls below this fraction of ‖g‖.
_CG_TOL = 0.1


@dataclasses.dataclass(frozen=True)
class _TronState:
    w: Tensor  # (L, d)
    f: Tensor  # (L,)
    g: Tensor  # (L, d)
    delta: Tensor  # (L,) trust-region radius
    it: Tensor  # (L,) int64
    converged: Tensor  # (L,) bool
    failed: Tensor  # (L,) bool: trust region collapsed before convergence
    g0_norm: Tensor  # (L,)
    value_history: Tensor  # (L, max_iter + 1)
    grad_norm_history: Tensor  # (L, max_iter + 1)


def _any(live: Tensor) -> bool:
    """Whether any lane is still live: the loops' one host sync."""
    minimize.host_syncs += 1
    return bool(live.any())


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _col(v: Tensor) -> Tensor:
    return v.unsqueeze(-1)


def _cg_steihaug(hvp: Hvp, w: Tensor, g: Tensor, delta: Tensor,
                 max_cg: int, done: Tensor):
    """Truncated CG per lane: approximately solve H s = −g within
    ‖s‖ ≤ delta. Lanes flagged ``done`` do not iterate. Returns
    (s, sHs, gs) with sHs = sᵀHs and gs = gᵀs, the pieces of the model
    decrease."""
    L = g.shape[0]
    r = -g  # residual −g − H s at s = 0
    rr = _dot(r, r)
    cg_tol = _CG_TOL * torch.sqrt(rr)
    st = (torch.zeros_like(g), r, r, rr,
          torch.zeros(L, dtype=torch.int64, device=g.device), done)
    while True:
        s, r, p, rr, i, done = st
        live = (~done) & (i < max_cg) & (torch.sqrt(rr) > cg_tol)
        if not _any(live):
            break
        hp = hvp(w, p)
        php = _dot(p, hp)
        # Negative or tiny curvature → step to the boundary.
        alpha = rr / torch.clamp(php, min=1e-30)
        s_next = s + _col(alpha) * p
        over = (php <= 0.0) | (_norm(s_next) >= delta)
        # Boundary step: tau >= 0 with ‖s + tau p‖ = delta.
        ss, sp, pp = _dot(s, s), _dot(s, p), _dot(p, p)
        disc = torch.sqrt(torch.clamp(sp * sp + pp * (delta * delta - ss),
                                      min=0.0))
        tau = (disc - sp) / torch.clamp(pp, min=1e-30)
        s_new = torch.where(_col(over), s + _col(tau) * p, s_next)
        r_new = r - _col(torch.where(over, tau, alpha)) * hp
        rr_new = _dot(r_new, r_new)
        beta = rr_new / torch.clamp(rr, min=1e-30)
        new = (s_new, r_new, r_new + _col(beta) * p, rr_new, i + 1,
               done | over)
        st = masked_update(~live, new, st)
    s, r = st[0], st[1]
    sHs = _dot(s, -g - r)  # H s = −g − r by the residual invariant
    return s, sHs, _dot(g, s)


def _set_slot(buf: Tensor, slot: Tensor, value: Tensor) -> Tensor:
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), slot] = value
    return out


def minimize(value_and_grad: ValueAndGrad, hvp: Hvp, w0: Tensor,
             config: OptimizerConfig = OptimizerConfig()) -> OptResult:
    """Trust-region Newton minimization of a twice-differentiable
    objective, for each of the L lanes of ``w0`` (L, d).
    ``value_and_grad`` maps (L, d) to ((L,), (L, d)); ``hvp(w, v)``
    maps two (L, d) to (L, d)."""
    if w0.dim() != 2:
        raise ValueError(f"w0 must be (lanes, d), got {tuple(w0.shape)}")
    max_iter = config.max_iterations
    L = w0.shape[0]
    dev = w0.device
    f0, g0 = value_and_grad(w0)
    g0_norm = _norm(g0)
    vh = torch.full((L, max_iter + 1), float("nan"), dtype=torch.float32,
                    device=dev)
    gh = vh.clone()
    vh[:, 0] = f0.to(torch.float32)
    gh[:, 0] = g0_norm.to(torch.float32)
    state = _TronState(
        w=w0, f=f0, g=g0,
        delta=g0_norm,  # LIBLINEAR: initial radius = ‖g0‖
        it=torch.zeros(L, dtype=torch.int64, device=dev),
        converged=g0_norm <= config.tolerance,
        failed=torch.zeros(L, dtype=torch.bool, device=dev),
        g0_norm=g0_norm, value_history=vh, grad_norm_history=gh)

    def step(st: _TronState, active: Tensor) -> _TronState:
        s, sHs, gs = _cg_steihaug(hvp, st.w, st.g, st.delta,
                                  config.max_cg_iterations, ~active)
        prered = -(gs + 0.5 * sHs)  # predicted decrease of the model
        w_new = st.w + s
        f_new, g_new = value_and_grad(w_new)
        actred = st.f - f_new
        snorm = _norm(s)
        # Radius update (LIBLINEAR tron.cpp rules, simplified alpha=1).
        ratio = actred / torch.clamp(prered, min=1e-30)
        d0 = st.delta
        delta = torch.where(
            ratio < _ETA0, _SIGMA1 * torch.minimum(d0, snorm),
            torch.where(
                ratio < _ETA1, torch.maximum(_SIGMA1 * d0, _SIGMA2 * snorm),
                torch.where(ratio < _ETA2, d0,
                            torch.maximum(d0, _SIGMA3 * snorm))))
        accept = (actred > _ETA0 * prered) & torch.isfinite(f_new)
        w_acc = torch.where(_col(accept), w_new, st.w)
        f_acc = torch.where(accept, f_new, st.f)
        g_acc = torch.where(_col(accept), g_new, st.g)
        gnorm = _norm(g_acc)
        it = st.it + 1
        # Value-based convergence counts only on accepted steps (a
        # rejected step has Δf = 0); the gradient test holds anywhere.
        grad_conv = gnorm <= config.tolerance * torch.clamp(st.g0_norm,
                                                            min=1.0)
        conv = grad_conv | (accept & check_convergence(
            f_acc, st.f, gnorm, st.g0_norm, config.tolerance))
        stalled = delta < 1e-12  # a collapsed radius is a true stall
        slot = torch.clamp(it, max=max_iter)
        return _TronState(
            w=w_acc, f=f_acc, g=g_acc, delta=delta, it=it,
            converged=st.converged | conv | stalled,
            failed=st.failed | (stalled & ~conv),
            g0_norm=st.g0_norm,
            value_history=_set_slot(st.value_history, slot,
                                    f_acc.to(torch.float32)),
            grad_norm_history=_set_slot(st.grad_norm_history, slot,
                                        gnorm.to(torch.float32)))

    while True:
        active = (~state.converged) & (state.it < max_iter)
        if not _any(active):
            break
        state = masked_update(~active, step(state, active), state)

    return OptResult(
        w=state.w, value=state.f, grad_norm=_norm(state.g),
        iterations=state.it, converged=state.converged & ~state.failed,
        value_history=state.value_history,
        grad_norm_history=state.grad_norm_history)


# Device→host reads made by the loops' live checks in this process.
minimize.host_syncs = 0
