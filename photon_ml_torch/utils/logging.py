"""Logging and timing utilities.

Port of ``photon_ml_tpu/utils/logging.py``. Reference parity: photon-lib
``util/PhotonLogger.scala`` (a logger whose output is also persisted next
to the job output) and ``util/Timer.scala`` (wall-clock scopes).

The profiler scope is ``torch.profiler``: CPU and CUDA activity, exported
as a Chrome trace that Perfetto opens.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def setup_logging(
    level: int = logging.INFO,
    log_file: Optional[str] = None,
) -> logging.Logger:
    """Configure the package logger; optionally tee to a file beside the
    job output (PhotonLogger behavior)."""
    logger = logging.getLogger("photon_ml_torch")
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


class Timer:
    """Wall-clock scope timer (reference: util/Timer.scala)."""

    def __init__(self):
        self.durations: dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + (
                time.monotonic() - t0)


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Profiler scope: when ``trace_dir`` is set, everything inside the
    scope is captured with ``torch.profiler`` (CPU ops, and CUDA kernels
    where a card is present) and written to ``trace_dir/trace.json``, a
    Chrome trace that Perfetto opens; a no-op when None."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def annotate(name: str):
    """Named sub-scope inside a profiler trace."""
    return torch.profiler.record_function(name)
