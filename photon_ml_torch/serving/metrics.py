"""Serving metrics: latency percentiles, throughput, batch fill, RE cache,
per-stage latency attribution, and sliding-window SLO accounting.

Port of ``photon_ml_tpu/serving/metrics.py`` (without ``ShardHeat``,
which belongs to the elastic fleet). Metric names in the ``/metrics``
exposition are the reference's own, so the same dashboards read both.

All methods are thread-safe (one lock; the HTTP front end and the batcher
worker record concurrently).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np

from photon_ml_torch.obs.metrics import Gauge
from photon_ml_torch.obs.metrics import Histogram as LatencyHistogram

__all__ = ["CacheCounters", "LatencyHistogram", "STAGES", "SLOTracker",
           "ServingMetrics"]

# The request lifecycle stages: a queued request's end-to-end latency
# decomposes into exactly these four intervals.
STAGES = ("queue_wait", "assemble", "device_score", "respond")


class SLOTracker:
    """Sliding-window latency percentiles + error-budget accounting.

    ``record_ok(latency_s)`` is one answered request; ``record_bad(kind)``
    one the service failed: ``shed`` (admission control, HTTP 503),
    ``deadline`` (expired in the queue, HTTP 504) or ``error`` (other
    5xx). A request slower than ``latency_objective_ms`` (when set) also
    burns budget, as ``slow``.

    With availability objective ``a`` over the window, the budget is a
    ``1 - a`` fraction of requests; ``budget_burn_rate`` is
    (bad fraction) / (1 - a). Clocks are monotonic; the window prunes
    lazily, and beyond ``max_samples`` the oldest samples drop first.
    """

    def __init__(self, window_s: float = 60.0,
                 availability_objective: float = 0.999,
                 latency_objective_ms: Optional[float] = None,
                 max_samples: int = 65536):
        if not 0.0 < availability_objective < 1.0:
            raise ValueError(
                f"availability objective must be in (0, 1), got "
                f"{availability_objective}")
        self._lock = threading.Lock()
        self.window_s = float(window_s)
        self.availability_objective = float(availability_objective)
        self.latency_objective_ms = (
            None if latency_objective_ms is None
            else float(latency_objective_ms))
        # (monotonic_t, latency_s) / (monotonic_t, kind)
        self._ok: collections.deque = collections.deque(maxlen=max_samples)
        self._bad: collections.deque = collections.deque(maxlen=max_samples)

    def record_ok(self, latency_s: float,
                  now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._ok.append((now, float(latency_s)))
            if (self.latency_objective_ms is not None
                    and latency_s * 1e3 > self.latency_objective_ms):
                self._bad.append((now, "slow"))
            self._prune_locked(now)

    def record_bad(self, kind: str, n: int = 1,
                   now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            for _ in range(int(n)):
                self._bad.append((now, kind))
            self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        for q in (self._ok, self._bad):
            while q and q[0][0] < horizon:
                q.popleft()

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(now)
            lats = [v for _, v in self._ok]
            bad = collections.Counter(k for _, k in self._bad)
        ok_n, bad_n = len(lats), sum(bad.values())
        total = ok_n + bad_n
        # "slow" requests were ALSO recorded ok (they completed); they
        # burn budget without changing the request count.
        total -= bad.get("slow", 0)
        bad_frac = bad_n / total if total else 0.0
        budget = 1.0 - self.availability_objective
        if lats:
            arr = np.asarray(lats)
            p50, p95, p99 = (float(np.percentile(arr, p))
                             for p in (50, 95, 99))
        else:
            p50 = p95 = p99 = 0.0
        return {
            "window_seconds": self.window_s,
            "availability_objective": self.availability_objective,
            "latency_objective_ms": self.latency_objective_ms,
            "requests_in_window": total,
            "ok_in_window": ok_n,
            "bad_in_window": bad_n,
            "bad_by_kind": dict(bad),
            "availability": 1.0 - bad_frac,
            "error_budget_fraction": budget,
            "budget_burn_rate": bad_frac / budget,
            "p50_ms": p50 * 1e3,
            "p95_ms": p95 * 1e3,
            "p99_ms": p99 * 1e3,
        }


class CacheCounters:
    """Per-coordinate random-effect device-cache counters."""

    def __init__(self):
        self.hits = 0  # rows whose entity was already device-resident
        self.misses = 0  # rows whose entity was fetched from the host store
        self.unseen = 0  # rows scored fixed-effect-only (entity unknown)
        self.evictions = 0  # LRU slots reclaimed

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def summary(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "unseen": self.unseen, "evictions": self.evictions,
                "hit_rate": self.hit_rate()}


class ServingMetrics:
    """One scoreboard per ScoringService."""

    def __init__(self, slo_window_s: float = 60.0,
                 slo_availability: float = 0.999,
                 slo_latency_ms: Optional[float] = None):
        self._lock = threading.Lock()
        # Wall clock is for the timestamp only; uptime and throughput are
        # durations and come off the monotonic clock.
        self.started_at = time.time()
        self._started_mono = time.monotonic()
        self.request_latency = LatencyHistogram()  # submit → result
        self.batch_latency = LatencyHistogram()  # one device flush
        self.rows_total = 0
        self.padded_rows_total = 0
        self.batches_total = 0
        # Distinct padded batch shapes served (the reference counts one
        # jit compile per shape; the bucket set is the same here).
        self.compiles_total = 0
        self.cache: dict[str, CacheCounters] = {}  # coordinate id → counts
        self.shed_total = 0  # requests rejected by admission control
        self.deadline_exceeded_total = 0  # requests expired in the queue
        self.flush_errors_total = 0  # batches whose flush raised
        self.recoveries_total = 0  # batcher worker deaths recovered from
        self.http_errors_total: dict[int, int] = {}  # status code → count
        # Each completed queued request adds its own queue wait plus the
        # full assemble/device/respond walls of the flush that carried it,
        # so sum(stages) tracks sum(request_latency).
        self.stage_seconds_total: dict[str, float] = {
            s: 0.0 for s in STAGES}
        self.stage_requests_total = 0  # requests attributed above
        self.queue_depth = Gauge()
        self.slo = SLOTracker(window_s=slo_window_s,
                              availability_objective=slo_availability,
                              latency_objective_ms=slo_latency_ms)

    def coordinate(self, cid: str) -> CacheCounters:
        with self._lock:
            return self.cache.setdefault(cid, CacheCounters())

    def record_batch(self, rows: int, padded_rows: int,
                     seconds: float) -> None:
        with self._lock:
            self.rows_total += rows
            self.padded_rows_total += padded_rows
            self.batches_total += 1
            self.batch_latency.record(seconds)

    def record_request_latency(self, seconds: float) -> None:
        with self._lock:
            self.request_latency.record(seconds)
        self.slo.record_ok(seconds)

    def record_stages(self, queue_wait_s: float, assemble_s: float,
                      device_s: float, respond_s: float) -> None:
        """One completed queued request's stage split (seconds)."""
        with self._lock:
            st = self.stage_seconds_total
            st["queue_wait"] += queue_wait_s
            st["assemble"] += assemble_s
            st["device_score"] += device_s
            st["respond"] += respond_s
            self.stage_requests_total += 1

    def record_compile(self) -> None:
        with self._lock:
            self.compiles_total += 1

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.shed_total += n
        self.slo.record_bad("shed", n)

    def record_deadline_exceeded(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_exceeded_total += n
        self.slo.record_bad("deadline", n)

    def record_flush_error(self) -> None:
        with self._lock:
            self.flush_errors_total += 1

    def record_recovery(self) -> None:
        with self._lock:
            self.recoveries_total += 1

    def record_http_error(self, code: int) -> None:
        with self._lock:
            self.http_errors_total[code] = \
                self.http_errors_total.get(code, 0) + 1
        # 5xx burns error budget; 503/504 are excluded here because shed
        # and deadline expiry already burned it at their sources.
        if code >= 500 and code not in (503, 504):
            self.slo.record_bad("error")

    def record_cache(self, cid: str, hits: int = 0, misses: int = 0,
                     unseen: int = 0, evictions: int = 0) -> None:
        c = self.coordinate(cid)
        with self._lock:
            c.hits += hits
            c.misses += misses
            c.unseen += unseen
            c.evictions += evictions

    # -- views -------------------------------------------------------------

    def fill_ratio(self) -> float:
        return (self.rows_total / self.padded_rows_total
                if self.padded_rows_total else 0.0)

    def uptime_seconds(self) -> float:
        return time.monotonic() - self._started_mono

    def throughput_rows_per_sec(self) -> float:
        dt = self.uptime_seconds()
        return self.rows_total / dt if dt > 0 else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_seconds": self.uptime_seconds(),
                "rows_total": self.rows_total,
                "batches_total": self.batches_total,
                "padded_rows_total": self.padded_rows_total,
                "batch_fill_ratio": self.fill_ratio(),
                "throughput_rows_per_sec": self.throughput_rows_per_sec(),
                "compiles_total": self.compiles_total,
                "shed_total": self.shed_total,
                "deadline_exceeded_total": self.deadline_exceeded_total,
                "flush_errors_total": self.flush_errors_total,
                "recoveries_total": self.recoveries_total,
                "http_errors_total": dict(self.http_errors_total),
                "request_latency": self.request_latency.summary(),
                "request_latency_sum_seconds":
                    self.request_latency.values()["sum"],
                "batch_latency": self.batch_latency.summary(),
                "stage_seconds_total": dict(self.stage_seconds_total),
                "stage_requests_total": self.stage_requests_total,
                "queue_depth": self.queue_depth.value,
                "queue_depth_peak": self.queue_depth.peak,
                "re_cache": {cid: c.summary()
                             for cid, c in self.cache.items()},
            }

    def render_text(self) -> str:
        """Prometheus-style text exposition (the /metrics endpoint body)."""
        s = self.snapshot()
        lines = [
            f"photon_serving_uptime_seconds {s['uptime_seconds']:.3f}",
            f"photon_serving_rows_total {s['rows_total']}",
            f"photon_serving_batches_total {s['batches_total']}",
            f"photon_serving_batch_fill_ratio {s['batch_fill_ratio']:.6f}",
            f"photon_serving_throughput_rows_per_sec "
            f"{s['throughput_rows_per_sec']:.3f}",
            f"photon_serving_compiles_total {s['compiles_total']}",
            f"photon_serving_shed_total {s['shed_total']}",
            f"photon_serving_deadline_exceeded_total "
            f"{s['deadline_exceeded_total']}",
            f"photon_serving_flush_errors_total {s['flush_errors_total']}",
            f"photon_serving_recoveries_total {s['recoveries_total']}",
        ]
        lines.append(f"photon_serving_queue_depth {s['queue_depth']:g}")
        lines.append(
            f"photon_serving_queue_depth_peak {s['queue_depth_peak']:g}")
        for stage in STAGES:
            lines.append(
                f"photon_serving_stage_seconds_total{{stage=\"{stage}\"}} "
                f"{s['stage_seconds_total'][stage]:.6f}")
        for code, n in sorted(s["http_errors_total"].items()):
            lines.append(
                f"photon_serving_http_errors_total{{code=\"{code}\"}} {n}")
        slo = self.slo.snapshot()
        lines.append(f"photon_serving_slo_window_seconds "
                     f"{slo['window_seconds']:g}")
        lines.append(f"photon_serving_slo_availability_objective "
                     f"{slo['availability_objective']:g}")
        lines.append(f"photon_serving_slo_requests_in_window "
                     f"{slo['requests_in_window']}")
        lines.append(f"photon_serving_slo_bad_in_window "
                     f"{slo['bad_in_window']}")
        for kind, n in sorted(slo["bad_by_kind"].items()):
            lines.append(f"photon_serving_slo_bad_in_window_by_kind"
                         f"{{kind=\"{kind}\"}} {n}")
        lines.append(f"photon_serving_slo_availability "
                     f"{slo['availability']:.6f}")
        lines.append(f"photon_serving_slo_budget_burn_rate "
                     f"{slo['budget_burn_rate']:.6f}")
        for q in ("p50", "p95", "p99"):
            lines.append(f"photon_serving_slo_latency_ms"
                         f"{{quantile=\"{q}\"}} {slo[q + '_ms']:.4f}")
        for name, h in (("request", s["request_latency"]),
                        ("batch", s["batch_latency"])):
            lines.append(f"photon_serving_{name}_latency_count {h['count']}")
            for q in ("p50", "p95", "p99"):
                lines.append(f"photon_serving_{name}_latency_ms"
                             f"{{quantile=\"{q}\"}} {h[q + '_ms']:.4f}")
        for cid, c in s["re_cache"].items():
            for k in ("hits", "misses", "unseen", "evictions"):
                lines.append(
                    f"photon_serving_re_cache_{k}{{coordinate=\"{cid}\"}} "
                    f"{c[k]}")
            lines.append(
                f"photon_serving_re_cache_hit_rate{{coordinate=\"{cid}\"}} "
                f"{c['hit_rate']:.6f}")
        return "\n".join(lines) + "\n"
