"""The hot tier of a streamed chunk: margins and the transposed product.

A row-streamed sparse chunk (``ops/streaming_sparse.py``) keeps its Zipf
head as a dense (n, H) block ``X_hot`` of int8 codes, bfloat16 or
float32. Two functions read it:

    hot_margins:  out[i] = base[i] + Σ_h f32(X_hot[i, h]) · w_hot[h]
    hot_rmatvec:  out[h] = Σ_i f32(X_hot[i, h]) · r[i]      (unscaled)

``base`` carries the offsets and the cold tier's contribution, and an
int8 caller folds the per-column dequantisation scales into ``w_hot``
(w·(s·q) = (w·s)·q) and multiplies the rmatvec result by them once. The
hand-written Hopper kernels are ``csrc/stream_fused.cu``; they replace
the TPU kernels ``hot_margins_pallas`` and ``hot_rmatvec_pallas`` of
``photon_ml_tpu/ops/kernels/stream_fused.py``, and the source note gives
their bound and design. Like the Pallas programs, they upcast the codes
in registers, so no (n, H) float32 copy of the block exists.

The kernels take float32 ``w_hot`` and ``r`` as given, as the Pallas
kernels do. Over a bfloat16 block the routes that call them
(``ops/streaming_sparse.py``, ``ops/hybrid_sparse.py``) pass them
already rounded to bfloat16 (:func:`rounded_like`), as the reference's
default (unfused) route rounds them
(``photon_ml_tpu/ops/hybrid_sparse._hot_matvec`` and ``_hot_rmatvec``);
each product is then exact in float32.

The wrappers take CPU tensors to the plain versions and CUDA tensors to
the kernels, or raise. There is no fallback from one to the other. The
kernels sum in a fixed order (no atomics), so two launches give the same
bits; the plain versions sum in another order, so the two agree within
float32 rounding, and bit for bit where every partial sum is exact.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "stream_fused"

# Rows per hot_rmatvec tile; the kernel's kRowTile.
ROW_TILE = 512

_SUFFIX = {torch.int8: "i8", torch.bfloat16: "bf16", torch.float32: "f32"}


def rounded_like(X_hot: Tensor, v: Tensor) -> Tensor:
    """``v`` rounded to bfloat16 (to nearest even) and back to float32
    where ``X_hot`` is bfloat16, as the reference's default route rounds
    the small operand of a bfloat16 product; else ``v``."""
    if X_hot.dtype == torch.bfloat16:
        return v.to(torch.bfloat16).to(torch.float32)
    return v


def hot_margins_reference(X_hot: Tensor, w_hot: Tensor, base: Tensor
                          ) -> Tensor:
    """Plain PyTorch version: upcast, matrix-vector product, add base."""
    return X_hot.to(torch.float32) @ w_hot + base


def hot_rmatvec_reference(X_hot: Tensor, r: Tensor) -> Tensor:
    """Plain PyTorch version: upcast, transposed matrix-vector product."""
    return r @ X_hot.to(torch.float32)


def _check_block(X_hot: Tensor, vectors: dict, what: str) -> None:
    if X_hot.dim() != 2 or X_hot.dtype not in _SUFFIX:
        raise ValueError(f"{what}: X_hot must be (n, H) int8, bfloat16 or "
                         f"float32, got {X_hot.dtype} {tuple(X_hot.shape)}")
    for name, (t, size) in vectors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{what}: {name} must be ({size},) float32, "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = [X_hot] + [t for t, _ in vectors.values()]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} tensors lie on several devices: "
                         f"{sorted(str(x) for x in devices)}")
    if X_hot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {X_hot.device}")


_launchers: dict = {}


def load() -> None:
    """Build and load the kernel library now."""
    global _launchers
    if _launchers:
        return
    lib = _build.load(NAME)
    bound = {}
    for dtype, suffix in _SUFFIX.items():
        m = getattr(lib, f"hot_margins_{suffix}")
        m.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_void_p]
        m.restype = ctypes.c_int
        r = getattr(lib, f"hot_rmatvec_{suffix}")
        r.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p]
        r.restype = ctypes.c_int
        bound[dtype] = (m, r)
    _launchers = bound


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def hot_margins(X_hot: Tensor, w_hot: Tensor, base: Tensor) -> Tensor:
    """(n,) ``base + f32(X_hot) @ w_hot``.

    ``X_hot`` (n, H) int8, bfloat16 or float32; ``w_hot`` (H,) float32
    (already folded with any dequantisation scales); ``base`` (n,)
    float32. CPU tensors: the plain version. CUDA tensors: the kernel, on
    the current stream.
    """
    n, h = X_hot.shape if X_hot.dim() == 2 else (-1, -1)
    _check_block(X_hot, {"w_hot": (w_hot, h), "base": (base, n)},
                 "hot_margins")
    if X_hot.device.type == "cpu":
        return hot_margins_reference(X_hot, w_hot, base)
    X, w, b = X_hot.contiguous(), w_hot.contiguous(), base.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    load()
    fn = _launchers[X.dtype][0]
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n, h, _stream(X))
    if err != 0:
        raise RuntimeError(f"hot_margins kernel launch failed: CUDA error "
                           f"{err}")
    hot_margins.launches += 1
    return out


def hot_rmatvec(X_hot: Tensor, r: Tensor) -> Tensor:
    """(H,) ``f32(X_hot)ᵀ @ r``, unscaled.

    ``X_hot`` (n, H) int8, bfloat16 or float32; ``r`` (n,) float32. CPU
    tensors: the plain version. CUDA tensors: the kernel (two launches:
    the per-tile partial sums, then their sum in tile order), on the
    current stream.
    """
    n, h = X_hot.shape if X_hot.dim() == 2 else (-1, -1)
    _check_block(X_hot, {"r": (r, n)}, "hot_rmatvec")
    if X_hot.device.type == "cpu":
        return hot_rmatvec_reference(X_hot, r)
    X, rr = X_hot.contiguous(), r.contiguous()
    if n == 0 or h == 0:
        return torch.zeros(h, dtype=torch.float32, device=X.device)
    out = torch.empty(h, dtype=torch.float32, device=X.device)
    tiles = (n + ROW_TILE - 1) // ROW_TILE
    partial = torch.empty((tiles, h), dtype=torch.float32, device=X.device)
    load()
    fn = _launchers[X.dtype][1]
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), rr.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), n, h, tiles, _stream(X))
    if err != 0:
        raise RuntimeError(f"hot_rmatvec kernel launch failed: CUDA error "
                           f"{err}")
    hot_rmatvec.launches += 1
    return out


# Kernel launches in this process: a run shows through them that a path
# went through the kernels. The plain versions never move them.
hot_margins.launches = 0
hot_rmatvec.launches = 0
