"""Random-effect bucket row moves: warm-start gather, fitted-row scatter.

A random-effect bucket wave (game/coordinates/random_effect.py) brackets
its lane-batched per-entity solves with two row moves over the (E, d)
float32 coefficient table:

    w0 = W[max(rows, 0)]                 # gather_rows
    W[rows[b]] = w_fit[b], rows[b] >= 0  # scatter_rows_, in place

The hand-written Hopper kernels are ``csrc/re_rows.cu``; they replace
the TPU kernels ``gather_rows_pallas`` and ``scatter_rows_pallas`` of
``photon_ml_tpu/ops/kernels/re_rows.py``. Its source note gives their
bound and design. Both are pure data movement, so kernel and plain
version agree bit for bit.

Each wrapper takes CPU tensors to the plain version and CUDA tensors to
the kernel, or raises. There is no fallback from one to the other.
Row ids must lie in [-1, E): −1 marks a padding lane. The wrappers check
this with one device→host read per call, skipped while a CUDA graph is
being captured (a capture cannot read the device).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "re_rows"


def gather_rows_reference(W: Tensor, rows: Tensor) -> Tensor:
    """Plain PyTorch version: padding lanes (−1) read row 0."""
    return W[rows.clamp(min=0).long()]


def scatter_rows_reference(W: Tensor, rows: Tensor, vals: Tensor) -> Tensor:
    """Plain PyTorch version: an ``index_copy_`` of the valid lanes, in
    place; returns ``W``."""
    valid = rows >= 0
    W.index_copy_(0, rows[valid].long(), vals[valid])
    return W


def _check(W: Tensor, rows: Tensor, vals: Optional[Tensor] = None) -> None:
    if W.dtype != torch.float32 or W.dim() != 2:
        raise ValueError(f"W must be (E, d) float32, got {W.dtype} "
                         f"{tuple(W.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError(f"rows must be (B,) int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    tensors = [W, rows]
    if vals is not None:
        want = (rows.shape[0], W.shape[1])
        if vals.dtype != torch.float32 or tuple(vals.shape) != want:
            raise ValueError(f"vals must be {want} float32, got "
                             f"{vals.dtype} {tuple(vals.shape)}")
        tensors.append(vals)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("re_rows needs contiguous tensors")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"re_rows tensors lie on several devices: "
                         f"{sorted(str(x) for x in devices)}")
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"re_rows runs on cpu or cuda, not {W.device}")
    if rows.numel() and not (W.device.type == "cuda"
                             and torch.cuda.is_current_stream_capturing()):
        lo, hi = (int(v) for v in torch.aminmax(rows))
        if lo < -1 or hi >= W.shape[0]:
            raise ValueError(f"row ids must lie in [-1, {W.shape[0]}), got "
                             f"[{lo}, {hi}]")


_launchers: dict = {}


def load() -> None:
    """Build and load the kernel library now."""
    global _launchers
    if _launchers:
        return
    lib = _build.load(NAME)
    lib.re_gather_rows.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.re_scatter_rows.argtypes = lib.re_gather_rows.argtypes
    for fn in (lib.re_gather_rows, lib.re_scatter_rows):
        fn.restype = ctypes.c_int
    _launchers = {"gather": lib.re_gather_rows,
                  "scatter": lib.re_scatter_rows}


def _launch(kind: str, a: Tensor, rows: Tensor, b: Tensor) -> None:
    load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launchers[kind](a.data_ptr(), rows.data_ptr(), b.data_ptr(),
                               int(rows.shape[0]), int(a.shape[1]), stream)
    if err != 0:
        raise RuntimeError(f"re_rows {kind} kernel launch failed: CUDA "
                           f"error {err}")


def gather_rows(W: Tensor, rows: Tensor) -> Tensor:
    """(B, d) rows ``W[max(rows, 0)]``: ``W`` (E, d) float32, ``rows``
    (B,) int32 in [-1, E). CPU tensors: the plain version. CUDA tensors:
    the kernel, on the current stream."""
    _check(W, rows)
    if W.device.type == "cpu":
        return gather_rows_reference(W, rows)
    out = torch.empty((rows.shape[0], W.shape[1]), dtype=W.dtype,
                      device=W.device)
    if out.numel() == 0:
        return out
    _launch("gather", W, rows, out)
    gather_rows.launches += 1
    return out


def scatter_rows_(W: Tensor, rows: Tensor, vals: Tensor) -> Tensor:
    """Write ``vals[b]`` into row ``rows[b]`` of ``W`` for every valid
    lane (``rows[b] >= 0``; −1 lanes write nothing), IN PLACE, and return
    ``W`` itself (the same tensor, same ``data_ptr``). Valid row ids must
    be unique within the call. CPU tensors: the plain version. CUDA
    tensors: the kernel, on the current stream."""
    _check(W, rows, vals)
    if W.device.type == "cpu":
        return scatter_rows_reference(W, rows, vals)
    if vals.numel() == 0:
        return W
    _launch("scatter", W, rows, vals)
    scatter_rows_.launches += 1
    return W


# Kernel launches in this process: a run shows through them that a path
# went through the kernels. The plain versions never move them.
gather_rows.launches = 0
scatter_rows_.launches = 0
