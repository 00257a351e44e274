"""Atomic file writes and content checksums (the port's own copy of
``photon_ml_tpu/utils/diskio.py``).

Writes go through a temp file + ``os.replace``, so a reader never sees a
half-written file; commit markers carry each artifact's CRC32, so silent
corruption degrades to a per-artifact miss instead of wrong bytes.
"""

from __future__ import annotations

import os
import tempfile
import zlib


def file_crc32(path: str) -> int:
    """CRC32 of a file's bytes (chunked; the integrity check of the
    streamed chunk store)."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


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
