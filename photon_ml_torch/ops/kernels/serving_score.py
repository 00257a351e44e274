"""Serving score: gather → dequantise → row-dot → per-row scale.

One random-effect coordinate's contribution to a serving flush
(serving/service.py):

    out[i] = scale[s_i] · Σ_d mat[i, d] · f32(cache[s_i, d]),
    s_i    = clamp(slots[i], 0, E − 1)

over an int8 cache with a per-row f32 scale, or an f32 cache with no
scale (a unit scale). The hand-written Hopper kernel is
``csrc/serving_score.cu``; it replaces the TPU kernel
``photon_ml_tpu/ops/kernels/serving_score.py::score_rows_pallas``. Its
source note gives its bound and design.

:func:`score_rows` takes CPU tensors to :func:`score_rows_reference`, the
plain PyTorch version, and CUDA tensors to the kernel, or raises. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "serving_score"


def score_rows_reference(mat: Tensor, slots: Tensor, cache: Tensor,
                         scale: Optional[Tensor]) -> Tensor:
    """Plain PyTorch version: gather, upcast, multiply, sum, scale."""
    s = torch.clamp(slots.long(), 0, cache.shape[0] - 1)
    out = torch.sum(mat * cache[s].to(torch.float32), dim=1)
    if scale is not None:
        out = out * scale[s]
    return out


def _check(mat: Tensor, slots: Tensor, cache: Tensor,
           scale: Optional[Tensor]) -> None:
    if mat.dtype != torch.float32 or mat.dim() != 2:
        raise ValueError(f"mat must be (n, d) float32, got {mat.dtype} "
                         f"{tuple(mat.shape)}")
    n, d = mat.shape
    if slots.dtype != torch.int32 or tuple(slots.shape) != (n,):
        raise ValueError(f"slots must be ({n},) int32, got {slots.dtype} "
                         f"{tuple(slots.shape)}")
    if cache.dtype not in (torch.int8, torch.float32) or cache.dim() != 2 \
            or cache.shape[1] != d or cache.shape[0] < 1:
        raise ValueError(f"cache must be (E >= 1, {d}) int8 or float32, got "
                         f"{cache.dtype} {tuple(cache.shape)}")
    if cache.dtype == torch.int8 and scale is None:
        raise ValueError("an int8 cache needs its (E,) float32 scale")
    if scale is not None and (scale.dtype != torch.float32
                              or tuple(scale.shape) != (cache.shape[0],)):
        raise ValueError(f"scale must be ({cache.shape[0]},) float32, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    tensors = [mat, slots, cache] + ([scale] if scale is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("serving_score needs contiguous tensors")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"serving_score tensors lie on several devices: "
                         f"{sorted(str(x) for x in devices)}")


# The two launchers, by cache dtype, bound once when the library loads.
_launchers: dict = {}


def load() -> None:
    """Build and load the kernel library now (a service calls this at
    start-up, so a build failure surfaces before the first request)."""
    global _launchers
    if _launchers:
        return
    lib = _build.load(NAME)
    bound = {torch.int8: lib.serving_score_i8,
             torch.float32: lib.serving_score_f32}
    for fn in bound.values():
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _launchers = bound


def score_rows(mat: Tensor, slots: Tensor, cache: Tensor,
               scale: Optional[Tensor] = None) -> Tensor:
    """(n,) scores of one random-effect coordinate.

    ``mat`` (n, d) f32 features; ``slots`` (n,) int32 cache rows, clamped
    into [0, E − 1]; ``cache`` (E, d) int8 codes or f32 rows; ``scale``
    (E,) f32 per-row dequantisation scales, required for int8 and None
    (a unit scale) or given for f32. All on the CPU: the plain version.
    All on one CUDA device: the kernel, on the current stream.
    """
    _check(mat, slots, cache, scale)
    if mat.device.type == "cpu":
        return score_rows_reference(mat, slots, cache, scale)
    if mat.device.type != "cuda":
        raise ValueError(f"serving_score runs on cpu or cuda, not "
                         f"{mat.device}")
    n, d = mat.shape
    out = torch.empty(n, dtype=torch.float32, device=mat.device)
    if n == 0:
        return out
    load()
    fn = _launchers[cache.dtype]
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = fn(mat.data_ptr(), slots.data_ptr(), cache.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 out.data_ptr(), n, d, int(cache.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"serving_score kernel launch failed: CUDA "
                           f"error {err}")
    score_rows.launches += 1
    return out


# Kernel launches in this process: a run shows through it that a path
# went through the kernel. The plain version never moves it.
score_rows.launches = 0
