"""Cold-class gradient of the hybrid layout: a gather, a product, a row sum.

    out[c] = Σ_l r_pad[rows[c, l]] · vals[c, l],   r_pad = [r, 0]

One count class of the hybrid hot/cold layout (``ops/hybrid_sparse.py``)
holds C cold columns padded to L entries each: their row ids (padding
id ``n``, which reads the zero slot) and values. The class's slice of
the gradient, of the H·v row term and (with ``vals²``) of the Hessian
diagonal is this function of the row terms ``r``. The hand-written
Hopper kernel is ``csrc/cold_grad.cu``; it replaces the TPU kernel
``fused_cold_grad`` of ``dev-scripts/exp_cold_gather.py``, which fuses
the JAX package's two XLA passes (``photon_ml_tpu/ops/hybrid_sparse.py``
``_cold_grad``: the gather ``r[rowids]``, then padded row sums), and its
source note gives the bound and the design. No (C, L) gathered temporary
exists on the card.

The kernel sums each column in a fixed order with no atomics, so two
launches give the same bits; the plain version sums in another order,
so the two agree within float32 rounding, and bit for bit where every
partial sum is exact (integer-valued inputs).

The wrapper takes CPU tensors to the plain version and CUDA tensors to
the kernel, or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "cold_grad"

# The kernel's row ids and r's length are int32.
MAX_ROWS = 2 ** 31 - 1


def cold_grad_reference(r: Tensor, rows: Tensor, vals: Tensor) -> Tensor:
    """Plain PyTorch version: ``(cat(r, 0)[rows] * vals).sum(1)``; every
    id outside [0, n) reads the zero slot."""
    n = r.shape[0]
    ids = rows.long()
    ids = ids.masked_fill((ids < 0) | (ids > n), n)
    return (torch.cat([r, r.new_zeros(1)])[ids] * vals).sum(dim=1)


def _check(r: Tensor, rows: Tensor, vals: Tensor) -> None:
    if r.dtype != torch.float32 or r.dim() != 1:
        raise ValueError(f"cold_grad: r must be (n,) float32, got {r.dtype} "
                         f"{tuple(r.shape)}")
    if r.shape[0] > MAX_ROWS:
        raise ValueError(f"cold_grad: {r.shape[0]} rows exceed the "
                         f"kernel's int32 row ids ({MAX_ROWS})")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"cold_grad: rows must be (C, L) int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if vals.dtype != torch.float32 or vals.shape != rows.shape:
        raise ValueError(f"cold_grad: vals must be {tuple(rows.shape)} "
                         f"float32, got {vals.dtype} {tuple(vals.shape)}")
    devices = {r.device, rows.device, vals.device}
    if len(devices) != 1:
        raise ValueError(f"cold_grad tensors lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cold_grad runs on cpu or cuda, not {r.device}")


_launcher = None


def load() -> None:
    """Build and load the kernel library now."""
    global _launcher
    if _launcher is not None:
        return
    fn = _build.load(NAME).cold_grad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launcher = fn


def cold_grad(r: Tensor, rows: Tensor, vals: Tensor) -> Tensor:
    """(C,) float32: ``Σ_l r_pad[rows[c, l]] · vals[c, l]`` for one class.

    ``r`` (n,) float32 row terms; ``rows`` (C, L) int32 row ids, padding
    ``n`` (any id outside [0, n) reads 0); ``vals`` (C, L) float32. CPU
    tensors: the plain version. CUDA tensors: the kernel, one launch on
    the current stream.
    """
    _check(r, rows, vals)
    if r.device.type == "cpu":
        return cold_grad_reference(r, rows, vals)
    rr, ids, v = r.contiguous(), rows.contiguous(), vals.contiguous()
    C, L = (int(x) for x in ids.shape)
    out = torch.empty(C, dtype=torch.float32, device=rr.device)
    if C == 0:
        return out
    load()
    with torch.cuda.device(rr.device):
        stream = torch.cuda.current_stream(rr.device).cuda_stream
        err = _launcher(rr.data_ptr(), ids.data_ptr(), v.data_ptr(),
                        out.data_ptr(), C, L, int(rr.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"cold_grad kernel launch failed: CUDA error "
                           f"{err}")
    cold_grad.launches += 1
    return out


# Kernel launches in this process: a run shows through it that a path went
# through the kernel. The plain version never moves it.
cold_grad.launches = 0
