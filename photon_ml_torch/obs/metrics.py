"""Metric primitives: histogram, counter, gauge (the port's own copy of
the ones in ``photon_ml_tpu/obs/metrics.py``).

Every update takes the metric's own lock: the HTTP front end and the
batcher worker record concurrently.
"""

from __future__ import annotations

import threading

import numpy as np

# Ring size for histogram reservoirs: large enough that p99 over recent
# observations is stable, small enough that percentile() stays trivial.
RING = 8192


class Histogram:
    """Percentiles over the most recent ``size`` observations."""

    def __init__(self, size: int = RING):
        self._lock = threading.Lock()
        self._buf = np.zeros(size, np.float64)
        self._n = 0  # total ever recorded
        self._sum = 0.0

    def record(self, value: float) -> None:
        with self._lock:
            self._buf[self._n % self._buf.shape[0]] = value
            self._n += 1
            self._sum += value

    observe = record

    @property
    def count(self) -> int:
        return self._n

    def percentile(self, p: float) -> float:
        with self._lock:
            k = min(self._n, self._buf.shape[0])
            if k == 0:
                return 0.0
            return float(np.percentile(self._buf[:k], p))

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._n if self._n else 0.0

    def summary(self) -> dict:
        return {"count": self._n, "mean_ms": self.mean() * 1e3,
                "p50_ms": self.percentile(50) * 1e3,
                "p95_ms": self.percentile(95) * 1e3,
                "p99_ms": self.percentile(99) * 1e3}

    def values(self) -> dict:
        """count/sum + quantiles in native units."""
        return {"count": self._n, "sum": self._sum,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class Counter:
    """Monotonic float counter."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        with self._lock:
            self.value += v


class Gauge:
    """Set/inc/dec gauge that also tracks its high-water mark."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            if v > self.peak:
                self.peak = v

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v
            if self.value > self.peak:
                self.peak = self.value

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self.value -= v
