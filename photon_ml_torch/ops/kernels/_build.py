"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library file is keyed by a hash of its source and the flags, and built
at first use into ``photon_ml_torch/_build/`` (listed in ``.gitignore``),
so a fresh checkout builds what it runs and a changed source never loads
a stale library. A failed build raises with nvcc's stderr.

Nothing here runs at import: the CPU-only test machines have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    with open(os.path.join(SRC_DIR, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc into a temp file; returns (process, tmp, final)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    final = library_path(name)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(SRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, final


def _finish(name: str, proc, tmp: str, final: str) -> str:
    """Wait for one nvcc; install its library, or return its error."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return (f"nvcc failed to build csrc/{name}.cu "
                f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, final)
    return ""


def build(names=None) -> list[str]:
    """Build every named kernel library that is not built yet, all nvcc
    processes at once; returns the names it built. Every nvcc is waited
    for before a failure raises."""
    names = sources() if names is None else list(names)
    with _lock:
        todo = [n for n in names if not os.path.exists(library_path(n))]
        started = [(n, *_start(n)) for n in todo]
        errors = [e for e in (_finish(*s) for s in started) if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
    return lib
