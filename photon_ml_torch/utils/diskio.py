"""Atomic file writes (the port's own copy of
``photon_ml_tpu/utils/diskio.atomic_write``).

Writes go through a temp file + ``os.replace``, so a reader never sees a
half-written file.
"""

from __future__ import annotations

import os
import tempfile


def atomic_write(path: str, write_fn) -> None:
    """Write via a temp file + os.replace (atomic on one filesystem)."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
