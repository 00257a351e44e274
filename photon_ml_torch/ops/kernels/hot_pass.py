"""One pass over the hybrid layout's hot block per evaluation.

The hybrid objective (``ops/hybrid_sparse.py``) reads its dense (n, H)
hot block for the margins and again for the gradient. Row i's residual
depends only on row i's margin, so one pass can do both:

    hot_value_and_gradient:
        z    = (f32(X_hot) · w_hot + offsets) + cold_z
        r    = where(weights > 0, weights · dl(z, y), 0)
        g    = f32(X_hot)ᵀ · ρ(r)
    hot_hessian_vector (TRON's H·v), besides z:
        xv   = ((f32(X_hot) · v_hot + offsets) + cold_zv) − offsets
        r    = where(weights > 0, weights · d2(z, y), 0) · xv
        g    = f32(X_hot)ᵀ · ρ(r)

X_hot is float32 or bfloat16. ρ is the identity over a float32 block and
the rounding to bfloat16 (to nearest even) over a bfloat16 one: the
reference's ``_hot_rmatvec`` rounds r so, and each product of two
bfloat16 numbers is then exact in float32. ``w_hot`` and ``v_hot`` come
already rounded from the route (``hybrid_sparse._hot_weights``); the
pass takes float32 vectors only.

``cold_z`` / ``cold_zv`` are the cold classes' margins (None without
cold classes). Each is written as ``hybrid_sparse`` wrote it with two
kernels, so the same operations run in the same order: the plain
versions are that composition (``stream_fused``'s plain margins, the
loss's torch functions, its plain transposed product), and every CPU
result keeps its bits. The hand-written Hopper kernel is
``csrc/hot_pass.cu``; it replaces, on the hybrid block, the TPU kernels
``hot_margins_pallas`` and ``hot_rmatvec_pallas`` of
``photon_ml_tpu/ops/kernels/stream_fused.py``, and its source note gives
the bound and the design. Its z and xv equal the two-kernel route's bit
for bit; g is summed in another fixed order (no atomics), so two
launches give the same bits and the plain version agrees within float32
rounding.

The wrappers take CPU tensors to the plain versions and CUDA tensors to
the kernel, or raise. There is no fallback from one to the other. X_hot
is float32 or bfloat16 with rows a multiple of 16 bytes long (4 or 8
columns: the hybrid block's ``hot_align``); the loss is one of
``LOSSES``, chosen by its name.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from photon_ml_torch.ops.kernels import _build, stream_fused
from photon_ml_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

NAME = "hot_pass"

# The kernel's loss policies, by id.
LOSSES = ("logistic", "squared", "poisson", "smoothed_hinge")
# csrc/hot_pass.cu: rows a partial row of g covers (kGroup), the widest
# block (8,192 columns of either dtype: each thread holds the sums of a few
# 16-byte column vectors), tile rows (kMaxRows) and ring depth
# (kMaxStages) at most, and the shared memory a block may hold. Rows are a
# multiple of ALIGN_BYTES long.
ROW_GROUP = 512
ALIGN_BYTES = 16
MAX_COLUMNS = 8192
MAX_ROWS = 8
MAX_STAGES = 8
MAX_SHARED = 232_448
# An SM's shared memory (228 KB) and what the runtime keeps of it a block.
SM_SHARED = 233_472
BLOCK_RESERVED = 1_024


# The block's element types, by the suffix of their C entry.
ENTRIES = {torch.float32: "hot_pass_f32", torch.bfloat16: "hot_pass_bf16"}


def shared_bytes(h: int, rows: int, stages: int, hessian: bool,
                 itemsize: int = 4) -> int:
    """The kernel's dynamic shared memory for rows of ``itemsize``-byte
    elements. Float32 (4): the ring, float32 w (and v), the tile's
    residuals and one mbarrier a slot. Bfloat16 (2): the ring, bfloat16 w
    (and v), each slot's residuals and three mbarriers a slot (tile
    landed, its residuals written, the slot read)."""
    vectors = 2 if hessian else 1
    if itemsize == 2:
        return (stages * rows * h * 2 + vectors * h * 2
                + stages * MAX_ROWS * 4 + 3 * stages * 8)
    return (stages * rows * h * itemsize + vectors * h * 4
            + MAX_ROWS * 4 + stages * 8)


def ring_shape(h: int, hessian: bool, itemsize: int = 4) -> tuple[int, int]:
    """(rows a tile, tiles in the ring) for an (n, h) block of
    ``itemsize``-byte elements: the most rows, up to one a warp, that
    leave room for two tiles, then as many tiles as fit. A bfloat16 block
    takes, at that row count, the most tiles that leave room for two
    blocks an SM where two tiles do: at h = 3,016 on an H100, 8 rows and
    2 tiles twice an SM beat 8 rows and 4 tiles once (18.50 against
    18.57 ms a value and gradient, 18.66 against 21.12 an H·v; PERF.md
    §6, dev-scripts/exp_hot_pass_bf16.py). At h = 1,772 float32: 8 rows,
    3 tiles."""
    for rows in (8, 4, 2, 1):
        fits = [s for s in range(2, MAX_STAGES + 1)
                if shared_bytes(h, rows, s, hessian, itemsize) <= MAX_SHARED]
        if not fits:
            continue
        if itemsize == 2:
            twice = [s for s in fits if 2 * (shared_bytes(
                h, rows, s, hessian, 2) + BLOCK_RESERVED) <= SM_SHARED]
            if twice:
                return rows, max(twice)
        return rows, max(fits)
    raise ValueError(f"hot_pass: rows of {h} columns do not fit two to a "
                     f"block's shared memory")


def _masked(weights: Tensor, term: Tensor) -> Tensor:
    return torch.where(weights > 0.0, weights * term,
                       torch.zeros_like(term))


def _plus(z: Tensor, cold: Optional[Tensor]) -> Tensor:
    return z if cold is None else z + cold


def hot_value_and_gradient_reference(
        X_hot: Tensor, w_hot: Tensor, offsets: Tensor,
        cold_z: Optional[Tensor], labels: Tensor, weights: Tensor,
        loss: PointwiseLoss) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version: the two-kernel route's composition."""
    z = _plus(stream_fused.hot_margins_reference(X_hot, w_hot, offsets),
              cold_z)
    _, dl = loss.loss_and_dz(z, labels)
    return z, stream_fused.hot_rmatvec_reference(
        X_hot, stream_fused.rounded_like(X_hot, _masked(weights, dl)))


def hot_hessian_vector_reference(
        X_hot: Tensor, w_hot: Tensor, v_hot: Tensor, offsets: Tensor,
        cold_z: Optional[Tensor], cold_zv: Optional[Tensor],
        labels: Tensor, weights: Tensor, loss: PointwiseLoss
        ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version: the three-kernel route's composition."""
    z = _plus(stream_fused.hot_margins_reference(X_hot, w_hot, offsets),
              cold_z)
    xv = _plus(stream_fused.hot_margins_reference(X_hot, v_hot, offsets),
               cold_zv) - offsets
    r = _masked(weights, loss.d2z(z, labels)) * xv
    return z, xv, stream_fused.hot_rmatvec_reference(
        X_hot, stream_fused.rounded_like(X_hot, r))


def _check(what: str, X_hot: Tensor, loss: PointwiseLoss, columns: dict,
           rows: dict) -> None:
    if X_hot.dim() != 2 or X_hot.dtype not in ENTRIES:
        raise ValueError(f"{what}: X_hot must be (n, H) float32 or "
                         f"bfloat16, got {X_hot.dtype} "
                         f"{tuple(X_hot.shape)}")
    n, h = X_hot.shape
    align = ALIGN_BYTES // X_hot.element_size()
    if h % align:
        raise ValueError(f"{what}: X_hot's width {h} is not a multiple of "
                         f"{align} ({X_hot.dtype} rows of 16 bytes)")
    if loss.name not in LOSSES:
        raise ValueError(f"{what}: no device policy for loss "
                         f"{loss.name!r}; have {LOSSES}")
    vectors = [(k, t, h) for k, t in columns.items()] + [
        (k, t, n) for k, t in rows.items() if t is not None]
    for name, t, size in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{what}: {name} must be ({size},) float32, "
                             f"got {t.dtype} {tuple(t.shape)}")
    devices = {X_hot.device} | {t.device for _, t, _ in vectors}
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
    for dtype, entry in ENTRIES.items():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bound[dtype] = fn
    _launchers = bound


def _launch(entry, X_hot: Tensor, w_hot: Tensor,
            v_hot: Optional[Tensor], offsets: Tensor,
            cold_z: Optional[Tensor], cold_zv: Optional[Tensor],
            labels: Tensor, weights: Tensor, loss: PointwiseLoss):
    """One pass on the current stream, counted on ``entry``: (z, xv or
    None, g)."""
    what = entry.__name__
    n, h = X_hot.shape
    if not 0 < h <= MAX_COLUMNS:
        raise ValueError(f"{what}: the kernel takes 1 to {MAX_COLUMNS} "
                         f"columns, got {h}")
    hessian = v_hot is not None
    X, w = X_hot.contiguous(), w_hot.contiguous()
    v = v_hot.contiguous() if hessian else None
    if any(t.data_ptr() % 16 for t in (X, w, v) if t is not None):
        raise ValueError(f"{what}: X_hot, w_hot and v_hot must start on "
                         f"16 bytes (the kernel reads them in 16-byte "
                         f"vectors)")
    device = X.device
    z = torch.empty(n, dtype=torch.float32, device=device)
    xv = torch.empty(n, dtype=torch.float32, device=device) \
        if hessian else None
    if n == 0:
        return z, xv, torch.zeros(h, dtype=torch.float32, device=device)
    vecs = [t.contiguous() if t is not None else None
            for t in (offsets, cold_z, cold_zv, labels, weights)]
    groups = -(-n // ROW_GROUP)
    partial = torch.empty((groups, h), dtype=torch.float32, device=device)
    out = torch.empty(h, dtype=torch.float32, device=device)
    rows, stages = ring_shape(h, hessian, X.element_size())

    def ptr(t):
        return None if t is None else t.data_ptr()

    load()
    with torch.cuda.device(device):
        err = _launchers[X.dtype](
            X.data_ptr(), w.data_ptr(), ptr(v), *(ptr(t) for t in vecs),
            z.data_ptr(), ptr(xv), partial.data_ptr(), out.data_ptr(), n, h,
            rows, stages, groups, LOSSES.index(loss.name),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    entry.launches += 1
    return z, xv, out


def hot_value_and_gradient(X_hot: Tensor, w_hot: Tensor, offsets: Tensor,
                           cold_z: Optional[Tensor], labels: Tensor,
                           weights: Tensor, loss: PointwiseLoss
                           ) -> tuple[Tensor, Tensor]:
    """(z (n,), g_hot (H,)): the margins with the cold term, and
    ``f32(X_hot)ᵀ · ρ(r)`` for the loss's weighted first derivative r at
    z.

    ``X_hot`` (n, H) float32 or bfloat16; ``w_hot`` (H,) (rounded to
    bfloat16 by the caller over a bfloat16 block); ``offsets``,
    ``labels``, ``weights`` and ``cold_z`` (or None) (n,), all float32.
    CPU tensors: the plain version. CUDA tensors: the kernel (two
    launches: the pass, then the sum of its partial rows in order), on
    the current stream.
    """
    _check("hot_value_and_gradient", X_hot, loss, {"w_hot": w_hot},
           {"offsets": offsets, "cold_z": cold_z, "labels": labels,
            "weights": weights})
    if X_hot.device.type == "cpu":
        return hot_value_and_gradient_reference(
            X_hot, w_hot, offsets, cold_z, labels, weights, loss)
    z, _, g = _launch(hot_value_and_gradient, X_hot, w_hot, None, offsets,
                      cold_z, None, labels, weights, loss)
    return z, g


def hot_hessian_vector(X_hot: Tensor, w_hot: Tensor, v_hot: Tensor,
                       offsets: Tensor, cold_z: Optional[Tensor],
                       cold_zv: Optional[Tensor], labels: Tensor,
                       weights: Tensor, loss: PointwiseLoss
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """(z, xv (n,), g_hot (H,)): the margins at w, the direction's row
    products x·v, and ``f32(X_hot)ᵀ · ρ(r)`` for the H·v row terms r.

    As :func:`hot_value_and_gradient`, with ``v_hot`` (H,) and
    ``cold_zv`` (n,) or None, the direction's hot and cold parts.
    """
    _check("hot_hessian_vector", X_hot, loss,
           {"w_hot": w_hot, "v_hot": v_hot},
           {"offsets": offsets, "cold_z": cold_z, "cold_zv": cold_zv,
            "labels": labels, "weights": weights})
    if X_hot.device.type == "cpu":
        return hot_hessian_vector_reference(
            X_hot, w_hot, v_hot, offsets, cold_z, cold_zv, labels, weights,
            loss)
    return _launch(hot_hessian_vector, X_hot, w_hot, v_hot, offsets,
                   cold_z, cold_zv, labels, weights, loss)


# Kernel launches in this process, one a pass: a run shows through them
# that a path went through the kernel. The plain versions never move them.
hot_value_and_gradient.launches = 0
hot_hessian_vector.launches = 0
