"""Convergence watchdogs: loud, defined failure for sick training runs.

Port of ``photon_ml_tpu/obs/watchdog.py``. A NaN'd objective would
surface as a silent line-search stall, a diverging fit would burn its
whole wall budget, and a straggling iteration would look like progress.
The watchdog sits on the same per-iteration telemetry stream the run
ledger records (obs/ledger.py) and turns those shapes into a LOUD event
plus a defined action — off by default at one ``None`` check per site
(``obs.watchdog_config()`` is the switch).

Detectors (each independently armed by its config field):

* ``nan``        — NaN/Inf in an ACCEPTED objective value or gradient
  norm, or a line search that failed on non-finite probe values
  (transient non-finite PROBES are normal Armijo backtracking and are
  never flagged).
* ``stall``      — no objective improvement beyond ``stall_rtol`` for
  ``stall_iterations`` consecutive iterations.
* ``divergence`` — the objective exceeds the best seen by
  ``divergence_factor × max(|f0|, 1)``.
* ``slow_iter``  — one iteration's wall time exceeds
  ``iter_seconds_factor ×`` the EMA of previous iterations (needs ≥ 3
  observations before it can fire — the first iterations build the
  kernels).
* ``gap``        — the duality-gap convergence gate of the stochastic
  streamed solvers: ``gap <= gap_tolerance`` fires with ``gap_action``
  (default ``stop``); a NON-FINITE gap is the NaN failure shape and
  fires the ``nan`` detector. Fed via
  :meth:`ConvergenceWatchdog.observe_gap`, whose only caller, the
  stochastic solvers, comes with slice 7; the host-driven L-BFGS never
  calls it, so arming ``gap=`` is a no-op there.

The streamed fit (``optim/streaming.minimize_streaming``) is the one
feeder of ``observe``: the lane-batched solvers of ``optim/lbfgs.py``
and ``optim/tron.py`` keep their iterations on the device, as the
reference's compiled solvers do.

Every alert emits a ``WatchdogAlert`` event (→ a timeline instant + the
``photon_watchdog_alerts_total{kind=...}`` counter via the obs bridge)
and a ``watchdog`` ledger row, then applies the detector's ACTION:
``warn`` logs, ``stop`` asks the optimizer to stop early (a defined
degradation — the partial ledger and checkpoint survive), ``raise``
raises :class:`WatchdogError`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

logger = logging.getLogger("photon_ml_torch.obs")

_ACTIONS = ("off", "warn", "stop", "raise")


class WatchdogError(RuntimeError):
    """A convergence watchdog fired with action="raise" — the DEFINED
    error of a sick training run (NaN objective, divergence)."""

    def __init__(self, kind: str, detail: str):
        super().__init__(f"watchdog[{kind}]: {detail}")
        self.kind = kind
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Which detectors are armed and what each does when it fires.
    The defaults arm ONLY the NaN detector — install via
    ``obs.set_watchdog(WatchdogConfig())`` / ``GameEstimator(watchdog=)``;
    no config installed = every site pays one ``None`` check."""

    nan: str = "raise"
    stall_iterations: int = 0       # 0 = off
    stall_rtol: float = 1e-9
    stall_action: str = "stop"
    divergence_factor: float = 0.0  # 0 = off
    divergence_action: str = "raise"
    iter_seconds_factor: float = 0.0  # 0 = off
    iter_action: str = "warn"
    gap_tolerance: float = 0.0      # 0 = off (absolute duality gap)
    gap_action: str = "stop"

    def __post_init__(self):
        for field, value in (("nan", self.nan),
                             ("stall_action", self.stall_action),
                             ("divergence_action", self.divergence_action),
                             ("iter_action", self.iter_action),
                             ("gap_action", self.gap_action)):
            if value not in _ACTIONS:
                raise ValueError(f"watchdog {field} must be one of "
                                 f"{_ACTIONS}, got {value!r}")
        if self.stall_iterations < 0:
            raise ValueError("stall_iterations must be >= 0")
        if self.divergence_factor < 0 or self.iter_seconds_factor < 0:
            raise ValueError("watchdog factors must be >= 0")
        if self.gap_tolerance < 0:
            raise ValueError("gap_tolerance must be >= 0")


def parse_watchdog_config(spec: str) -> WatchdogConfig:
    """``key=value,...`` mini-DSL (the reference's ``game_train
    --watchdog``): ``nan=``
    raise|warn|stop|off; ``stall=K[:action]`` (iterations); ``stall_rtol=``;
    ``divergence=F[:action]``; ``slow_iter=F[:action]``; ``gap=TOL[:action]``
    (absolute duality-gap convergence gate, stochastic solvers only). A bare
    ``--watchdog`` takes every default (NaN → raise)."""
    kv: dict[str, str] = {}
    for part in (p for p in spec.split(",") if p.strip()):
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError(f"watchdog spec needs key=value, got {part!r}")
        kv[k.strip()] = v.strip()
    known = {"nan", "stall", "stall_rtol", "divergence", "slow_iter", "gap"}
    unknown = set(kv) - known
    if unknown:
        raise ValueError(f"unknown watchdog keys {sorted(unknown)}; "
                         f"expected {sorted(known)}")

    def _split(value: str, default_action: str) -> tuple[str, str]:
        main, sep, action = value.partition(":")
        return main, (action if sep else default_action)

    d = WatchdogConfig()
    out = {"nan": kv.get("nan", d.nan)}
    if "stall" in kv:
        k, action = _split(kv["stall"], d.stall_action)
        out["stall_iterations"] = int(k)
        out["stall_action"] = action
    if "stall_rtol" in kv:
        out["stall_rtol"] = float(kv["stall_rtol"])
    if "divergence" in kv:
        f, action = _split(kv["divergence"], d.divergence_action)
        out["divergence_factor"] = float(f)
        out["divergence_action"] = action
    if "slow_iter" in kv:
        f, action = _split(kv["slow_iter"], d.iter_action)
        out["iter_seconds_factor"] = float(f)
        out["iter_action"] = action
    if "gap" in kv:
        f, action = _split(kv["gap"], d.gap_action)
        out["gap_tolerance"] = float(f)
        out["gap_action"] = action
    return WatchdogConfig(**out)


class ConvergenceWatchdog:
    """Per-optimization detector state. One instance per optimizer run
    (``minimize_streaming`` builds one when a config is installed);
    ``observe`` once per ACCEPTED iteration."""

    def __init__(self, config: WatchdogConfig,
                 coordinate: Optional[str] = None):
        self.config = config
        self.coordinate = coordinate
        self._f0: Optional[float] = None
        self._best: Optional[float] = None
        self._stall = 0
        self._ema: Optional[float] = None
        self._ema_n = 0

    # -- alert plumbing ------------------------------------------------------

    def _alert(self, kind: str, action: str, detail: str,
               **fields) -> Optional[str]:
        from photon_ml_torch import obs
        from photon_ml_torch.utils import events as ev_mod

        ev_mod.default_emitter.emit(ev_mod.WatchdogAlert(
            kind=kind, action=action, coordinate=self.coordinate,
            detail=detail))
        led = obs.ledger()
        if led is not None:
            led.record("watchdog", watchdog_kind=kind, action=action,
                       detail=detail, **fields)
            led.flush()  # the next thing may be a raise — keep the row
        if action == "warn":
            logger.warning("watchdog[%s]%s: %s", kind,
                           f" ({self.coordinate})" if self.coordinate
                           else "", detail)
            return None
        if action == "stop":
            logger.warning("watchdog[%s]%s: %s — stopping early", kind,
                           f" ({self.coordinate})" if self.coordinate
                           else "", detail)
            return "stop"
        raise WatchdogError(kind, detail)

    # -- detectors -----------------------------------------------------------

    def on_line_search_failure(self, last_probe_value: float,
                               iteration: int) -> Optional[str]:
        """A failed line search whose probes were NON-FINITE is the NaN
        failure shape (a poisoned objective NaNs every probe); a finite
        failed search is ordinary numerical exhaustion and stays the
        optimizer's own stop path."""
        if self.config.nan != "off" and \
                not math.isfinite(last_probe_value):
            return self._alert(
                "nan", self.config.nan,
                f"line search failed on a non-finite objective "
                f"(value={last_probe_value!r}) at iteration {iteration}",
                iteration=iteration, value=last_probe_value)
        return None

    def observe(self, iteration: int, value: float, grad_norm: float,
                seconds: float) -> Optional[str]:
        """Feed one accepted iteration; returns "stop" when an armed
        detector with action="stop" fired (the caller breaks its loop),
        None otherwise. action="raise" raises WatchdogError."""
        cfg = self.config
        if cfg.nan != "off" and (not math.isfinite(value)
                                 or not math.isfinite(grad_norm)):
            return self._alert(
                "nan", cfg.nan,
                f"non-finite convergence state at iteration {iteration} "
                f"(value={value!r}, grad_norm={grad_norm!r})",
                iteration=iteration, value=value, grad_norm=grad_norm)
        if self._f0 is None:
            self._f0 = value
        if cfg.divergence_factor > 0 and self._best is not None:
            limit = self._best + cfg.divergence_factor * \
                max(abs(self._f0), 1.0)
            if value > limit:
                return self._alert(
                    "divergence", cfg.divergence_action,
                    f"objective {value:.6g} exceeded best "
                    f"{self._best:.6g} by more than "
                    f"{cfg.divergence_factor:g} x max(|f0|, 1) at "
                    f"iteration {iteration}",
                    iteration=iteration, value=value, best=self._best)
        if cfg.stall_iterations > 0:
            if self._best is not None and value >= self._best - \
                    cfg.stall_rtol * max(abs(self._best), 1e-12):
                self._stall += 1
            else:
                self._stall = 0
            if self._stall >= cfg.stall_iterations:
                self._stall = 0
                return self._alert(
                    "stall", cfg.stall_action,
                    f"no objective progress beyond rtol "
                    f"{cfg.stall_rtol:g} for {cfg.stall_iterations} "
                    f"consecutive iterations (value {value:.6g})",
                    iteration=iteration, value=value)
        if self._best is None or value < self._best:
            self._best = value
        if cfg.iter_seconds_factor > 0:
            if self._ema_n >= 3 and seconds > \
                    cfg.iter_seconds_factor * self._ema:
                verdict = self._alert(
                    "slow_iter", cfg.iter_action,
                    f"iteration {iteration} took {seconds:.3g}s vs "
                    f"{self._ema:.3g}s EMA "
                    f"(> {cfg.iter_seconds_factor:g}x)",
                    iteration=iteration, seconds=seconds, ema=self._ema)
                if verdict is not None:
                    return verdict
            self._ema = (seconds if self._ema is None
                         else 0.7 * self._ema + 0.3 * seconds)
            self._ema_n += 1
        return None

    def observe_gap(self, iteration: int, gap: float) -> Optional[str]:
        """Feed the epoch's duality gap (stochastic solvers,
        optim/stochastic.py). A NON-FINITE gap is the NaN failure shape
        (a poisoned certificate must not silently certify convergence);
        ``gap <= gap_tolerance`` fires the ``gap`` detector — the
        default ``stop`` is the gap-gated convergence stop."""
        cfg = self.config
        if cfg.nan != "off" and not math.isfinite(gap):
            return self._alert(
                "nan", cfg.nan,
                f"non-finite duality gap at iteration {iteration} "
                f"(gap={gap!r})",
                iteration=iteration, gap=gap)
        if cfg.gap_tolerance > 0 and gap <= cfg.gap_tolerance:
            return self._alert(
                "gap", cfg.gap_action,
                f"duality gap {gap:.6g} <= tolerance "
                f"{cfg.gap_tolerance:g} at iteration {iteration} — "
                f"convergence certified",
                iteration=iteration, gap=gap)
        return None
