"""Process-wide metrics registry: counters, gauges, histograms.

Port of ``photon_ml_tpu/obs/metrics.py``. One registry the whole stack
feeds (docs/OBSERVABILITY.md has the metric catalog): the streamed
chunk-transfer accounting (``photon_transfer_bytes_total`` /
``photon_transfer_seconds_total`` from ``ops/streaming_sparse.py``), the
in-flight chunk gauge, checkpoint writes, random-effect lanes, and the
counters the event bridge feeds. Exported as Prometheus text, byte for
byte the reference's rendering of the same contents: the serving
``/metrics`` endpoint appends the active registry, and ``cli/serve.py
--metrics-dump`` writes the same text.

All mutation is thread-safe: one registry lock guards metric CREATION,
one lock per metric guards its updates (the HTTP front end, the batcher
worker and the fit record concurrently).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

# Ring size for histogram reservoirs: large enough that p99 over recent
# observations is stable, small enough that percentile() stays trivial.
RING = 8192


class Histogram:
    """Percentiles over the most recent ``size`` observations.

    This IS serving's latency reservoir (serving/metrics.py re-exports it
    as ``LatencyHistogram``); ``observe`` is the registry-style alias of
    ``record``.
    """

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
        """Registry exposition: count/sum + quantiles in native units."""
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
    """Set/inc/dec gauge that also tracks its high-water mark (the
    in-flight chunk peak of a streamed pass is read from it)."""

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


def _key(name: str, labels: dict) -> tuple:
    return (name,) + tuple(sorted(labels.items()))


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class MetricsRegistry:
    """Name+labels → metric. One instance per process is the norm
    (``obs.enable()`` installs it; ``obs.metrics()`` hands it out behind
    the one-None-check discipline)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls()
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{labels} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat dict view: ``name{label="v"}`` → value(s)."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, object] = {}
        for key, m in items:
            name, labels = key[0], key[1:]
            base = name + _render_labels(labels)
            if isinstance(m, Counter):
                out[base] = m.value
            elif isinstance(m, Gauge):
                out[base] = m.value
                out[name + "_peak" + _render_labels(labels)] = m.peak
            else:
                for k, v in m.values().items():
                    out[f"{name}_{k}" + _render_labels(labels)] = v
        return out

    def render_text(self) -> str:
        """Prometheus text exposition of every registered metric."""
        lines = []
        for k in sorted(self.snapshot().items()):
            name, v = k
            lines.append(f"{name} {v:.10g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str) -> None:
        import os

        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render_text())
        os.replace(tmp, path)


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Inverse of :meth:`MetricsRegistry.render_text` (also accepts the
    serving endpoint's body): ``name{labels}`` → float value. Comment
    and malformed lines are skipped — the parser reads dumps produced by
    THIS repo, but tolerates hand edits."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


def metric_value(parsed: dict[str, float], name: str,
                 default: Optional[float] = None) -> Optional[float]:
    """Sum of ``name``'s series across label sets in a parsed dump (a
    bare counter matches itself; a labeled family sums its children)."""
    if name in parsed:
        return parsed[name]
    total = None
    for k, v in parsed.items():
        if k.startswith(name + "{"):
            total = (total or 0.0) + v
    return default if total is None else total
