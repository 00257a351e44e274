"""L-BFGS and OWL-QN over an explicit leading lane axis.

Port of ``photon_ml_tpu/optim/lbfgs.py``. Reference parity: photon-lib
``optimization/LBFGS.scala`` (wraps ``breeze.optimize.LBFGS``, m=10
history, strong-Wolfe line search) and ``OWLQN.scala`` (orthant-wise QN
with per-coordinate L1 weights, intercept excluded; Andrew & Gao 2007).

The reference solves one problem per ``lax.while_loop`` and runs a
random-effect bucket under ``jax.vmap``. There, each loop keeps going
while ANY lane's condition holds, runs its body on every lane, and
select-freezes the lanes whose own condition is false: the outer
``(~converged) & (it < max_iter)`` and the line search's
``(~done) & (steps < max_line_search_steps)``. This module writes that
out: every state tensor has a leading lane axis (L, ...), each loop runs
``while live.any()``, and :func:`~photon_ml_torch.optim.common.masked_update`
keeps a lane's old state wherever its own condition is false. Lane i of
an L-lane solve therefore takes exactly the steps of an L=1 solve of
lane i: the same iterations and the same ``converged``. The fixed effect
is one lane; a bucket wave is up to 65,536.

The circular (m, d) history has a per-lane ``head`` and ``count``, so the
two-loop recursion gathers each lane's own slots.

Host syncs: each ``live.any()`` is one device→host read, once per outer
iteration and once per line-search trial, for the whole wave and never
per lane. ``minimize.host_syncs`` counts them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_torch.optim.common import (OptResult, OptimizerConfig,
                                          ValueAndGrad, check_convergence,
                                          masked_update)

Tensor = torch.Tensor

_EPS = 1e-10


@dataclasses.dataclass(frozen=True)
class _LBFGSState:
    w: Tensor  # (L, d)
    f: Tensor  # (L,)
    g: Tensor  # (L, d) gradient of the SMOOTH part
    s_hist: Tensor  # (L, m, d)
    y_hist: Tensor  # (L, m, d)
    rho: Tensor  # (L, m)
    head: Tensor  # (L,) int64: slot of the newest pair
    count: Tensor  # (L,) int64: number of valid pairs
    it: Tensor  # (L,) int64
    converged: Tensor  # (L,) bool
    failed: Tensor  # (L,) bool: line search stalled
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


def _set_slot(buf: Tensor, slot: Tensor, value: Tensor) -> Tensor:
    """A copy of ``buf`` (L, K, ...) with ``buf[l, slot[l]] = value[l]``."""
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), slot] = value
    return out


def _two_loop(g: Tensor, s_hist: Tensor, y_hist: Tensor, rho: Tensor,
              head: Tensor, count: Tensor) -> Tensor:
    """Two-loop recursion per lane: returns d ≈ H⁻¹ g (the descent
    direction is −d). Slot j of the gathered history is each lane's
    j-th newest pair, ``(head − j) mod m``."""
    L, m, _ = s_hist.shape
    j = torch.arange(m, device=g.device)
    order = torch.remainder(head.unsqueeze(1) - j, m)  # (L, m) newest first
    s = torch.take_along_dim(s_hist, order.unsqueeze(-1), dim=1)
    y = torch.take_along_dim(y_hist, order.unsqueeze(-1), dim=1)
    r_ = torch.take_along_dim(rho, order, dim=1)
    valid = j < count.unsqueeze(1)  # (L, m)
    zero = g.new_zeros(L)
    q = g
    alphas = []
    for k in range(m):
        a = torch.where(valid[:, k], r_[:, k] * _dot(s[:, k], q), zero)
        q = q - _col(a) * y[:, k]
        alphas.append(a)
    # Slot 0 is the newest pair (the reference reads it at ``head``).
    sy = _dot(s[:, 0], y[:, 0])
    yy = _dot(y[:, 0], y[:, 0])
    gamma = torch.where(count > 0, sy / torch.clamp(yy, min=_EPS),
                        torch.ones_like(sy))
    r = _col(gamma) * q
    for k in reversed(range(m)):  # oldest → newest
        b = r_[:, k] * _dot(y[:, k], r)
        r = r + _col(torch.where(valid[:, k], alphas[k] - b, zero)) * s[:, k]
    return r


def _project_orthant(x: Tensor, orthant: Tensor) -> Tensor:
    """Zero coordinates whose sign disagrees with the orthant."""
    return torch.where(torch.sign(x) == orthant, x, torch.zeros_like(x))


def _pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """OWL-QN pseudo-gradient of f(w) + Σ l1ⱼ|wⱼ| (Andrew & Gao 2007)."""
    right = g + l1
    left = g - l1
    zero = torch.zeros_like(g)
    pg_zero = torch.where(left > 0.0, left,
                          torch.where(right < 0.0, right, zero))
    return torch.where(w > 0.0, right, torch.where(w < 0.0, left, pg_zero))


def minimize(value_and_grad: ValueAndGrad, w0: Tensor,
             config: OptimizerConfig = OptimizerConfig(),
             l1_weights: Optional[Tensor] = None) -> OptResult:
    """Minimize f(w) (+ Σ l1ⱼ|wⱼ| when ``l1_weights`` is given → OWL-QN)
    for each of the L lanes of ``w0`` (L, d).

    ``value_and_grad`` maps (L, d) to ((L,), (L, d)) and is the SMOOTH
    part only; the L1 term is handled by pseudo-gradients and orthant
    projection, never differentiated.
    """
    if w0.dim() != 2:
        raise ValueError(f"w0 must be (lanes, d), got {tuple(w0.shape)}")
    m = config.history_length
    max_iter = config.max_iterations
    is_owlqn = l1_weights is not None
    L, d = w0.shape
    dtype, dev = w0.dtype, w0.device

    def total_value(f_smooth: Tensor, w: Tensor) -> Tensor:
        if not is_owlqn:
            return f_smooth
        return f_smooth + torch.sum(l1_weights * torch.abs(w), dim=-1)

    def search_gradient(w: Tensor, g: Tensor) -> Tensor:
        """The gradient driving direction and convergence (the
        pseudo-gradient for OWL-QN)."""
        if not is_owlqn:
            return g
        return _pseudo_gradient(w, g, l1_weights)

    f0, g0 = value_and_grad(w0)
    ft0 = total_value(f0, w0)
    g0_norm = _norm(search_gradient(w0, g0))
    vh = torch.full((L, max_iter + 1), float("nan"), dtype=torch.float32,
                    device=dev)
    gh = vh.clone()
    vh[:, 0] = ft0.to(torch.float32)
    gh[:, 0] = g0_norm.to(torch.float32)
    zero_i = torch.zeros(L, dtype=torch.int64, device=dev)
    state = _LBFGSState(
        w=w0, f=f0, g=g0,
        s_hist=w0.new_zeros((L, m, d)), y_hist=w0.new_zeros((L, m, d)),
        rho=w0.new_zeros((L, m)), head=zero_i, count=zero_i, it=zero_i,
        converged=g0_norm <= config.tolerance,
        failed=torch.zeros(L, dtype=torch.bool, device=dev),
        g0_norm=g0_norm, value_history=vh, grad_norm_history=gh)

    def line_search_owlqn(w, ft, sg, direction, done):
        """Backtracking Armijo on the TOTAL objective at the point
        projected onto the orthant of sign(w) (sign(−pg) at zeros): the
        projection leaves the Wolfe curvature condition ill-defined."""
        orthant = torch.where(w != 0.0, torch.sign(w), torch.sign(-sg))
        st = (torch.ones(L, dtype=dtype, device=dev), zero_i, done,
              w, torch.full((L,), float("inf"), dtype=dtype, device=dev), sg)
        while True:
            alpha, steps, done, best_w, best_f, best_g = st
            live = (~done) & (steps < config.max_line_search_steps)
            if not _any(live):
                break
            cand = _project_orthant(w + _col(alpha) * direction, orthant)
            f_new, g_new = value_and_grad(cand)
            ft_new = total_value(f_new, cand)
            # Armijo with the projected displacement (OWL-QN form).
            decrease = _dot(sg, cand - w)
            ok = torch.isfinite(ft_new) & (
                ft_new <= ft + config.wolfe_c1 * decrease)
            new = (alpha * 0.5, steps + 1, ok,
                   torch.where(_col(ok), cand, best_w),
                   torch.where(ok, f_new, best_f),
                   torch.where(_col(ok), g_new, best_g))
            st = masked_update(~live, new, st)
        _, _, ok, new_w, new_f, new_g = st
        return ok, new_w, new_f, new_g

    def line_search_wolfe(w, ft, sg, direction, done):
        """Strong-Wolfe line search as a bounded bisection with
        expansion (Breeze ``StrongWolfeLineSearch`` parity), keeping a
        bracket [a, b], b = ∞ until an upper bound is seen:

        - Armijo fails, or the slope overshot   → b = α
        - Armijo holds, slope < c2·φ'(0)        → a = α
        - Armijo holds and |φ'(α)| ≤ −c2·φ'(0)  → accept

        Next trial: 2α while unbracketed, else the midpoint. On budget
        exhaustion the best Armijo point seen is returned (the sy > eps
        gate in the outer step discards its pair if curvature is bad).
        """
        c1 = config.wolfe_c1
        c2 = config.wolfe_c2
        dg0 = _dot(sg, direction)  # φ'(0) < 0 for descent directions
        false = torch.zeros(L, dtype=torch.bool, device=dev)
        st = (torch.zeros(L, dtype=dtype, device=dev),
              torch.full((L,), float("inf"), dtype=dtype, device=dev),
              torch.ones(L, dtype=dtype, device=dev), zero_i, done, false,
              w, ft, sg)
        while True:
            a, b, alpha, steps, done, has_pt, res_w, res_f, res_g = st
            live = (~done) & (steps < config.max_line_search_steps)
            if not _any(live):
                break
            cand = w + _col(alpha) * direction
            f_new, g_new = value_and_grad(cand)
            dg_new = _dot(g_new, direction)
            armijo = torch.isfinite(f_new) & (f_new <= ft + c1 * alpha * dg0)
            strong = armijo & (torch.abs(dg_new) <= -c2 * dg0)
            curv_low = dg_new < c2 * dg0
            # A strong point always wins; otherwise keep the lowest-f
            # Armijo point as the exhaustion fallback (res_f starts at
            # f(w), and any Armijo point is below that).
            take = strong | (armijo & (f_new < res_f))
            grow = armijo & curv_low & ~strong
            a2 = torch.where(grow, alpha, a)
            b2 = torch.where(~strong & ~grow, alpha, b)
            alpha2 = torch.where(grow & ~torch.isfinite(b2), 2.0 * alpha,
                                 0.5 * (a2 + b2))
            new = (a2, b2, alpha2, steps + 1, strong, has_pt | armijo,
                   torch.where(_col(take), cand, res_w),
                   torch.where(take, f_new, res_f),
                   torch.where(_col(take), g_new, res_g))
            st = masked_update(~live, new, st)
        done, has_pt, new_w, new_f, new_g = st[4:]
        return done | has_pt, new_w, new_f, new_g

    line_search = line_search_owlqn if is_owlqn else line_search_wolfe

    def step(s: _LBFGSState, active: Tensor) -> _LBFGSState:
        sg = search_gradient(s.w, s.g)
        d_dir = -_two_loop(sg, s.s_hist, s.y_hist, s.rho, s.head, s.count)
        if is_owlqn:
            # Constrain the direction to the descent orthant of −pg.
            d_dir = torch.where(d_dir * (-sg) > 0.0, d_dir,
                                torch.zeros_like(d_dir))
        # Safeguard: steepest descent on non-descent directions.
        descent = _dot(sg, d_dir) < 0.0
        d_dir = torch.where(_col(descent), d_dir, -sg)
        # First iteration: scale like Breeze (step ~ 1/‖g‖).
        first = s.count == 0
        d_dir = torch.where(
            _col(first), d_dir / _col(torch.clamp(_norm(d_dir), min=1.0)),
            d_dir)

        ft = total_value(s.f, s.w)
        # Lanes already frozen start the search done: their results are
        # discarded below, as the reference's select discards them.
        ok, new_w, new_f, new_g = line_search(s.w, ft, sg, d_dir, ~active)

        sv = new_w - s.w
        yv = new_g - s.g
        sy = _dot(sv, yv)
        good = ok & (sy > _EPS)
        new_head = torch.where(good, torch.remainder(s.head + 1, m), s.head)
        new_count = torch.where(good, torch.clamp(s.count + 1, max=m),
                                s.count)
        s_hist = masked_update(~good, _set_slot(s.s_hist, new_head, sv),
                               s.s_hist)
        y_hist = masked_update(~good, _set_slot(s.y_hist, new_head, yv),
                               s.y_hist)
        rho = masked_update(
            ~good, _set_slot(s.rho, new_head,
                             1.0 / torch.clamp(sy, min=_EPS)), s.rho)

        new_gnorm = _norm(search_gradient(new_w, new_g))
        ft_new = total_value(new_f, new_w)
        it = s.it + 1
        conv = ok & check_convergence(ft_new, ft, new_gnorm, s.g0_norm,
                                      config.tolerance)
        failed = ~ok  # line search exhausted: stop (stalled)
        slot = torch.clamp(it, max=max_iter)
        vh = _set_slot(s.value_history, slot,
                       torch.where(ok, ft_new, ft).to(torch.float32))
        gh = _set_slot(s.grad_norm_history, slot,
                       torch.where(ok, new_gnorm, _norm(sg)).to(
                           torch.float32))
        return _LBFGSState(
            w=torch.where(_col(ok), new_w, s.w),
            f=torch.where(ok, new_f, s.f),
            g=torch.where(_col(ok), new_g, s.g),
            s_hist=s_hist, y_hist=y_hist, rho=rho,
            head=new_head, count=new_count, it=it,
            converged=s.converged | conv | failed,
            failed=s.failed | failed,
            g0_norm=s.g0_norm, value_history=vh, grad_norm_history=gh)

    while True:
        active = (~state.converged) & (state.it < max_iter)
        if not _any(active):
            break
        state = masked_update(~active, step(state, active), state)

    sg_final = search_gradient(state.w, state.g)
    return OptResult(
        w=state.w,
        value=total_value(state.f, state.w),
        grad_norm=_norm(sg_final),
        iterations=state.it,
        converged=state.converged & ~state.failed,
        value_history=state.value_history,
        grad_norm_history=state.grad_norm_history)


# Device→host reads made by the loops' live checks in this process: the
# solver's syncs, counted so a run can report them per descent.
minimize.host_syncs = 0


def minimize_owlqn(value_and_grad: ValueAndGrad, w0: Tensor,
                   l1_weights: Tensor,
                   config: OptimizerConfig = OptimizerConfig()) -> OptResult:
    """OWL-QN: minimize smooth f(w) + Σⱼ l1ⱼ |wⱼ| per lane.

    Reference parity: photon-lib ``optimization/OWLQN.scala``.
    """
    return minimize(value_and_grad, w0, config, l1_weights=l1_weights)
