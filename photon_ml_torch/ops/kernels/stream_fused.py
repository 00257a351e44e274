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

On the card a block takes one of two routes, picked by :func:`route`
from its dtype, width and alignment before any launch, never by a
failure. The ring route takes float32 blocks whose rows are a whole
number of 16-byte vectors (H a multiple of 4, at most ``MAX_COLUMNS``)
from a 16-byte aligned base: a persistent grid streams their rows into a
ring of shared-memory tiles by bulk copies (the ring's geometry from
:func:`ring_shape`). Every other block (int8, bfloat16, a ragged or
misaligned or wider float32 block) takes the direct route, whose kernels
read the rows with plain loads. ``hot_margins`` gives the same bits on
either route; ``hot_rmatvec``'s routes sum in different fixed orders.

The wrappers take CPU tensors to the plain versions and CUDA tensors to
the kernels, or raise. There is no fallback from one to the other, nor
from one route to the other. The kernels sum in a fixed order (no
atomics), so two launches give the same bits; the plain versions sum in
another order, so the two agree within float32 rounding, and bit for bit
where every partial sum is exact.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "stream_fused"

# Rows a partial row of hot_rmatvec covers on either route (the kernels'
# kRowTile / kRowGroup): 512 consecutive rows on the direct route, every
# G-th tile of rows on the ring route (G = the partial rows).
ROW_GROUP = 512
# The ring route (csrc/stream_fused.cu): rows of ALIGN_BYTES-byte vectors,
# at most MAX_COLUMNS columns (16 float4 column vectors a thread), tile
# rows (kMaxRows) and ring depth (kMaxStages) at most, and the shared
# memory a block may hold.
ALIGN_BYTES = 16
MAX_COLUMNS = 8192
MAX_ROWS = 8
MAX_STAGES = 8
MAX_SHARED = 232_448
# Tiles in each ring kernel's ring: the fastest at the streamed chunk and
# the hybrid block on the H100 (PERF.md §6).
MARGINS_STAGES = 3
RMATVEC_STAGES = 2

_SUFFIX = {torch.int8: "i8", torch.bfloat16: "bf16", torch.float32: "f32"}


def route(X_hot: Tensor) -> str:
    """``"ring"`` or ``"direct"``: the route the kernels take for
    ``X_hot`` as they read it (contiguous). The ring takes float32 rows
    of whole 16-byte vectors (H a multiple of 4, 4 to ``MAX_COLUMNS``)
    from a 16-byte aligned base; every other block goes direct."""
    h = X_hot.shape[-1]
    if (X_hot.dtype == torch.float32 and 0 < h <= MAX_COLUMNS
            and h * 4 % ALIGN_BYTES == 0
            and X_hot.data_ptr() % ALIGN_BYTES == 0):
        return "ring"
    return "direct"


def shared_bytes(h: int, rows: int, stages: int) -> int:
    """The ring kernels' dynamic shared memory: ``stages`` tiles of
    ``rows`` float32 rows, a scratch of max(h, 1024) floats (w, or the
    splits' sums) and one mbarrier a slot."""
    return stages * rows * h * 4 + max(h, 1024) * 4 + stages * 8


def ring_shape(h: int, stages: int) -> tuple[int, int]:
    """(rows a tile, tiles in the ring) for the ring route at width
    ``h``: ``stages`` tiles of the most rows, up to 8, that fit, so that
    several blocks share an SM. hot_margins reads MARGINS_STAGES tiles
    ((8, 3) at h = 512 and 1,772, (2, 3) at 8,192), hot_rmatvec
    RMATVEC_STAGES ((8, 2) there, (2, 2) at 8,192)."""
    for rows in (8, 4, 2, 1):
        if shared_bytes(h, rows, stages) <= MAX_SHARED:
            return rows, stages
    raise ValueError(f"stream_fused: rows of {h} columns do not fit "
                     f"{stages} to a block's shared memory")


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


def partial_rows(n: int) -> int:
    """Rows of hot_rmatvec's (rows, H) partial sums over n rows: one a
    fixed group of ``ROW_GROUP`` rows, on either route."""
    return -(-n // ROW_GROUP)


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
    m = lib.hot_margins_f32_ring
    m.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]
    m.restype = ctypes.c_int
    r = lib.hot_rmatvec_f32_ring
    r.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    r.restype = ctypes.c_int
    bound["ring"] = (m, r)
    _launchers = bound


def _ring(h: int, stages: int) -> tuple[int, int, int]:
    """(rows, stages, shared bytes) of the ring at width ``h``."""
    rows, stages = ring_shape(h, stages)
    return rows, stages, shared_bytes(h, rows, stages)


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def hot_margins(X_hot: Tensor, w_hot: Tensor, base: Tensor) -> Tensor:
    """(n,) ``base + f32(X_hot) @ w_hot``.

    ``X_hot`` (n, H) int8, bfloat16 or float32; ``w_hot`` (H,) float32
    (already folded with any dequantisation scales); ``base`` (n,)
    float32. CPU tensors: the plain version. CUDA tensors: the kernel, on
    the current stream, by :func:`route`'s route.
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
    ptrs = (X.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, h)
    with torch.cuda.device(X.device):
        if route(X) == "ring":
            err = _launchers["ring"][0](*ptrs, *_ring(h, MARGINS_STAGES),
                                        _stream(X))
        else:
            err = _launchers[X.dtype][0](*ptrs, _stream(X))
    if err != 0:
        raise RuntimeError(f"hot_margins kernel launch failed: CUDA error "
                           f"{err}")
    hot_margins.launches += 1
    return out


def hot_rmatvec(X_hot: Tensor, r: Tensor) -> Tensor:
    """(H,) ``f32(X_hot)ᵀ @ r``, unscaled.

    ``X_hot`` (n, H) int8, bfloat16 or float32; ``r`` (n,) float32. CPU
    tensors: the plain version. CUDA tensors: the kernel (two launches:
    the partial sums of each 512-row group, then their sum in group
    order), on the current stream, by :func:`route`'s route.
    """
    n, h = X_hot.shape if X_hot.dim() == 2 else (-1, -1)
    _check_block(X_hot, {"r": (r, n)}, "hot_rmatvec")
    if X_hot.device.type == "cpu":
        return hot_rmatvec_reference(X_hot, r)
    X, rr = X_hot.contiguous(), r.contiguous()
    if n == 0 or h == 0:
        return torch.zeros(h, dtype=torch.float32, device=X.device)
    out = torch.empty(h, dtype=torch.float32, device=X.device)
    groups = partial_rows(n)
    partial = torch.empty((groups, h), dtype=torch.float32, device=X.device)
    load()
    ptrs = (X.data_ptr(), rr.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h)
    with torch.cuda.device(X.device):
        if route(X) == "ring":
            err = _launchers["ring"][1](*ptrs, *_ring(h, RMATVEC_STAGES),
                                        groups, _stream(X))
        else:
            err = _launchers[X.dtype][1](*ptrs, groups, _stream(X))
    if err != 0:
        raise RuntimeError(f"hot_rmatvec kernel launch failed: CUDA error "
                           f"{err}")
    hot_rmatvec.launches += 1
    return out


# Kernel launches in this process: a run shows through them that a path
# went through the kernels. The plain versions never move them.
hot_margins.launches = 0
hot_rmatvec.launches = 0
