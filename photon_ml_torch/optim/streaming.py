"""Host-driven L-BFGS and OWL-QN for row-streamed objectives.

Port of ``photon_ml_tpu/optim/streaming.py``. Reference parity:
photon-api's distributed fits iterate Breeze L-BFGS in the Spark
application's main process, and every value/gradient is one
cluster pass (``DistributedGLMLossFunction`` → ``treeAggregate``). A
row-streamed objective (``ops/streaming_sparse.py``) is a Python loop over
the chunks, so the iteration control runs in Python too, while the
two-loop recursion and the vector math stay on the objective's device
((d,) vectors; the history for d = 1M and m = 10 is 40 MB). Each
objective evaluation streams the chunks once.

Line search is backtracking Armijo (not strong Wolfe): each probe costs a
FULL pass over the data, and Armijo accepts in 1–2 probes from the
well-scaled L-BFGS direction. Curvature pairs that fail s·y > 0 are
skipped. With ``value_only`` the probes run the cheaper value pass and
the gradient pass runs once per accepted iteration.

L1/OWL-QN (``l1_weights``): the PSEUDO-gradient drives the direction and
the convergence norm, every probe is projected onto the orthant of the
current point (sign(w), or sign(−pg) at zeros), Armijo tests the TOTAL
objective with the projected displacement ``pg·(cand − w)``, and
curvature pairs come from the RAW smooth gradients. The streamed passes
stay the smooth part; the L1 term is added on the host at the probe.

Host reads are where the reference has them: one scalar per probe and a
few per iteration. Unlike the lane-batched solvers of ``optim/lbfgs.py``,
this one solves one problem: ``OptResult``'s fields carry no lane axis.

Telemetry (docs/OBSERVABILITY.md): the ``lbfgs.initial_pass``,
``lbfgs.iteration`` and ``lbfgs.probe`` spans, a live ``opt_iter`` ledger
row per accepted iteration and the convergence watchdog, each one
``None`` check when off. They read only the values the loop already
holds on the host. Fault poisoning and the fabric's ``on_accept`` hook
are not ported (slices 9–10).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_torch import obs
from photon_ml_torch.obs.ledger import transfer_totals
from photon_ml_torch.obs.watchdog import ConvergenceWatchdog
from photon_ml_torch.optim.common import OptResult, OptimizerConfig
from photon_ml_torch.optim.lbfgs import _project_orthant, _pseudo_gradient

Tensor = torch.Tensor


def _two_loop(grad: Tensor, s_stack: Tensor, y_stack: Tensor, rho: Tensor,
              m: int) -> Tensor:
    """Standard L-BFGS two-loop recursion over the (M, d) history; the
    ``m`` live pairs sit at rows 0..m−1, the newest at m−1. Returns the
    descent direction −H·grad. (The reference runs all M rows with the
    dead ones masked to exact zeros; skipping them is the same
    arithmetic.)"""
    q = grad
    alpha: list = [None] * m
    for j in range(m - 1, -1, -1):  # newest → oldest
        a = rho[j] * torch.dot(s_stack[j], q)
        q = q - a * y_stack[j]
        alpha[j] = a
    gamma = torch.ones((), dtype=grad.dtype, device=grad.device)
    if m > 0:
        # Initial Hessian scaling γ = s·y / y·y from the newest pair.
        sy = torch.dot(s_stack[m - 1], y_stack[m - 1])
        yy = torch.dot(y_stack[m - 1], y_stack[m - 1])
        gamma = torch.where(yy > 0, sy / torch.clamp(yy, min=1e-30), gamma)
    r = gamma * q
    for j in range(m):  # oldest → newest
        beta = rho[j] * torch.dot(y_stack[j], r)
        r = r + (alpha[j] - beta) * s_stack[j]
    return -r


def _shift_in(stack: Tensor, v: Tensor, m: int) -> Tensor:
    """A copy of ``stack`` with ``v`` at row m (or shifted left when
    full)."""
    M = stack.shape[0]
    out = torch.roll(stack, -1, dims=0) if m >= M else stack.clone()
    out[min(m, M - 1)] = v
    return out


def snapshot_state(w, g, s_stack, y_stack, rho, m_host, it, fv, gn_prev,
                   f0, gn0, vals, gns) -> dict:
    """Host-side snapshot of the FULL host-loop state at an iteration
    boundary: everything the loop reads before its next streamed pass.
    Plain numpy (float32 exact), so a resume from it replays the remaining
    iterations BIT-identically to an uninterrupted run."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    return {
        "w": host(w), "g": host(g), "s_stack": host(s_stack),
        "y_stack": host(y_stack), "rho": host(rho), "m": np.int32(m_host),
        "it": np.int32(it), "fv": np.float32(fv),
        "gn_prev": np.float32(gn_prev), "f0": np.float32(f0),
        "gn0": np.float32(gn0), "vals": np.asarray(vals).copy(),
        "gns": np.asarray(gns).copy(),
    }


def minimize_streaming(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig,
    log: Callable[[str], None] = lambda m: None,
    value_only: Optional[Callable[[Tensor], Tensor]] = None,
    checkpoint_save: Optional[Callable[[dict], None]] = None,
    resume_state: Optional[dict] = None,
    l1_weights: Optional[Tensor] = None,
) -> OptResult:
    """Host-loop L-BFGS: minimize a host-driven (value, grad) callable
    of a (d,) tensor, on ``w0``'s device.

    ``value_only``, when given, is the cheaper streamed value pass the
    Armijo probes use. ``checkpoint_save``, when given, is called at the
    end of every accepted iteration with a :func:`snapshot_state` dict;
    passing a saved snapshot back as ``resume_state`` restarts the loop at
    the NEXT iteration with bit-identical state (no initial pass: the
    snapshot carries it). ``l1_weights`` switches the loop to OWL-QN; the
    callables must then be the SMOOTH part only.

    When a run ledger is active (``obs.ledger()``), every accepted
    iteration records an ``opt_iter`` row LIVE — value, gradient norm,
    step, probe/pass counts, per-iteration wall seconds, cumulative
    transfer counters. When a watchdog config is installed
    (``obs.watchdog_config()``), the same per-iteration stream feeds a
    :class:`ConvergenceWatchdog`: NaN/stall/divergence/slow-iteration
    become a loud event plus a defined error or early stop.
    """
    d = int(w0.shape[0])
    dev = w0.device
    M = config.history_length
    max_it = config.max_iterations
    led = obs.ledger()
    wd_cfg = obs.watchdog_config()
    wd = (ConvergenceWatchdog(wd_cfg) if wd_cfg is not None else None)
    l1 = (None if l1_weights is None
          else torch.as_tensor(l1_weights, dtype=torch.float32, device=dev))
    opt_name = "lbfgs-stream" if l1 is None else "owlqn-stream"

    def _sgrad(w, g):
        """Gradient driving direction + convergence (pg under L1)."""
        return g if l1 is None else _pseudo_gradient(w, g, l1)

    def _l1_term(w) -> float:
        if l1 is None:
            return 0.0
        return float(torch.sum(l1 * torch.abs(w)))

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    v_passes = g_passes = 0  # streamed passes, cumulative this call
    if resume_state is not None:
        st = resume_state
        if st["s_stack"].shape != (M, d) or st["w"].shape != (d,):
            raise ValueError(
                f"resume state shape mismatch: saved history "
                f"{st['s_stack'].shape} / w {st['w'].shape}, expected "
                f"({M}, {d}) / ({d},) — the checkpoint was written under "
                f"a different optimizer configuration")
        w, g = put(st["w"]), put(st["g"])
        s_stack, y_stack, rho = (put(st["s_stack"]), put(st["y_stack"]),
                                 put(st["rho"]))
        m_host = int(st["m"])
        f0, gn0 = float(st["f0"]), float(st["gn0"])
        fv, gn_prev = float(st["fv"]), float(st["gn_prev"])
        start_it = int(st["it"]) + 1
        vals = np.full((max_it + 1,), np.nan, np.float32)
        gns = np.full((max_it + 1,), np.nan, np.float32)
        k = min(st["vals"].shape[0], max_it + 1)
        vals[:k], gns[:k] = st["vals"][:k], st["gns"][:k]
        sg = _sgrad(w, g)  # the snapshot carries the RAW gradient
        log(f"resuming streamed L-BFGS at iteration {start_it} "
            f"(f={fv:.6g})")
    else:
        w = w0.to(device=dev, dtype=torch.float32)
        with obs.span("lbfgs.initial_pass", cat="optim"):
            f, g = value_and_grad(w)
        g_passes += 1
        sg = _sgrad(w, g)
        f0 = float(f) + _l1_term(w)
        gn0 = float(torch.linalg.vector_norm(sg))
        s_stack = torch.zeros((M, d), dtype=torch.float32, device=dev)
        y_stack = torch.zeros((M, d), dtype=torch.float32, device=dev)
        rho = torch.zeros((M,), dtype=torch.float32, device=dev)
        m_host = 0
        vals = np.full((max_it + 1,), np.nan, np.float32)
        gns = np.full((max_it + 1,), np.nan, np.float32)
        vals[0], gns[0] = f0, gn0
        fv, gn_prev = f0, gn0
        start_it = 1
    converged = False
    it = start_it - 1
    for it in range(start_it, max_it + 1):
        t_iter = time.perf_counter()
        v0_passes, g0_passes = v_passes, g_passes
        # One span per iteration: its passes, probes and the checkpoint
        # write nest under it.
        with obs.span("lbfgs.iteration", cat="optim", it=it):
            direction = _two_loop(sg, s_stack, y_stack, rho, m_host)
            # One scalar read per iteration: the direction-validity guard.
            dg = float(torch.dot(direction, sg))
            if not np.isfinite(dg) or dg >= 0.0:
                direction, dg = -sg, -float(torch.dot(sg, sg))
            # First iteration: steepest descent scaled to unit step length
            # (Breeze's determineStepSize init); later γ-scaling makes 1.0
            # the natural trial step.
            step = 1.0 if m_host > 0 else min(1.0,
                                              1.0 / max(gn_prev, 1e-12))
            # OWL-QN probes live in the orthant of the CURRENT point
            # (sign(w); sign(−pg) at zeros), fixed across backtracks.
            orthant = (None if l1 is None else
                       torch.where(w != 0.0, torch.sign(w), torch.sign(-sg)))
            accepted = False
            for probe in range(config.max_line_search_steps):
                w_try = w + step * direction
                if orthant is not None:
                    w_try = _project_orthant(w_try, orthant)
                # The Armijo probe: the host decides on this value.
                with obs.span("lbfgs.probe", cat="optim", it=it,
                              probe=probe, step=step):
                    if value_only is None:
                        f_try, g_try = value_and_grad(w_try)
                        g_passes += 1
                        f_try_h = float(f_try)
                    else:
                        v_passes += 1
                        f_try_h = float(value_only(w_try))
                f_try_h += _l1_term(w_try)  # total objective under L1
                if l1 is None:
                    decrease = step * dg
                else:
                    # Armijo with the projected displacement (the orthant
                    # projection breaks the step·dg identity).
                    decrease = float(torch.dot(sg, w_try - w))
                if np.isfinite(f_try_h) and \
                        f_try_h <= fv + config.wolfe_c1 * decrease:
                    accepted = True
                    break
                step *= 0.5
            if not accepted:
                if wd is not None:
                    # A line search that died on NON-FINITE probes is the
                    # NaN failure shape (a finite failed search stays the
                    # optimizer's own stop).
                    wd.on_line_search_failure(f_try_h, it)
                log(f"iter {it}: line search failed (f={fv:.6g}); "
                    f"stopping")
                break
            if value_only is not None:
                # The gradient pass only on acceptance (the curvature pair
                # and the next direction need it).
                _, g_try = value_and_grad(w_try)
                g_passes += 1
            s = w_try - w
            y = g_try - g  # RAW smooth gradients (OWL-QN included)
            sy = float(torch.dot(s, y))
            if sy > 1e-10:
                s_stack = _shift_in(s_stack, s, m_host)
                y_stack = _shift_in(y_stack, y, m_host)
                rho = _shift_in(rho, torch.full((), 1.0 / sy,
                                                dtype=torch.float32,
                                                device=dev), m_host)
                m_host = min(m_host + 1, M)
            w, g = w_try, g_try
            sg = _sgrad(w, g)
            f_prev, fv = fv, f_try_h
            gn = float(torch.linalg.vector_norm(sg))
            vals[it], gns[it] = fv, gn
            log(f"iter {it}: f={fv:.6g} |g|={gn:.3g} step={step:.3g}")
            if led is not None:
                # Append-as-produced: a kill one iteration later still
                # leaves this point on the curve.
                led.record("opt_iter", opt=opt_name, iteration=it,
                           value=fv, grad_norm=gn, step=step,
                           probes=probe + 1,
                           value_passes=v_passes - v0_passes,
                           grad_passes=g_passes - g0_passes,
                           seconds=round(time.perf_counter() - t_iter, 6),
                           **transfer_totals())
            if checkpoint_save is not None:
                # Iteration boundary = the resume point (gn_prev is the gn
                # just computed: the value the next iteration would see).
                checkpoint_save(snapshot_state(
                    w, g, s_stack, y_stack, rho, m_host, it, fv, gn, f0,
                    gn0, vals, gns))
            if wd is not None:
                # After the checkpoint write: a "raise" verdict still
                # leaves a resumable snapshot + a flushed ledger row.
                if wd.observe(it, fv, gn,
                              time.perf_counter() - t_iter) == "stop":
                    log(f"iter {it}: watchdog early stop")
                    break
            if gn <= config.tolerance * max(gn0, 1.0) or \
                    abs(fv - f_prev) <= config.tolerance * max(abs(f_prev),
                                                               1e-12):
                converged = True
                break
            gn_prev = gn

    return OptResult(
        w=w,
        value=torch.tensor(fv, dtype=torch.float32),
        grad_norm=torch.tensor(gns[it] if not np.isnan(gns[it]) else gn_prev,
                               dtype=torch.float32),
        iterations=torch.tensor(it, dtype=torch.int32),
        converged=torch.tensor(converged),
        value_history=torch.from_numpy(vals),
        grad_norm_history=torch.from_numpy(gns),
    )
