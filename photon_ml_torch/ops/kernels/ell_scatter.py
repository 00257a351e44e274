"""ELL scatter-add: ``out[c] = Σ_{i,k} rv[i, k] · [indices[i, k] == c]``.

The gradient, H·v and Hessian-diagonal reduction of the sparse ELL
objective (``ops/sparse_aggregators.py``): every slot's row term lands
on its feature column, and padding ids (``>= dim``; the ELL contract
puts them at ``dim``) add nothing. The hand-written Hopper kernel is
``csrc/ell_scatter.cu``; it replaces the TPU kernel
``scatter_rowterm_pallas`` of ``photon_ml_tpu/ops/kernels/ell_scatter.py``
and its source note gives the bound and the design.

The kernel does not compare every slot with every column, as the Pallas
program does (O(d·nnz)): it reads a column-sorted layout of the index
pattern, built once per staged batch by :func:`build_layout` (one stable
sort of the flat ids, so entries keep row order within a column), and
sums each column's segment in a fixed order. Columns of at most
``SHORT_COLUMN`` entries are summed by one thread; longer ones are cut
into pieces of at most ``PIECE`` entries, each summed by a warp, and the
pieces are then added in order. No atomics: two launches on the same
inputs give the same bits. The order differs from the plain version's
sequential ``index_add_``, so the two agree within float32 rounding, and
bit for bit where every partial sum is exact (integer-valued inputs).

The wrapper takes CPU tensors to the plain version and CUDA tensors to
the kernel, or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "ell_scatter"

# A column with at most this many entries is summed by one thread.
SHORT_COLUMN = 32
# Longer columns are cut into pieces of at most this many entries; a warp
# sums each piece (PIECE / 32 entries per lane).
PIECE = 4096
# Flat positions and segment offsets are int32 on the card.
MAX_ENTRIES = 2 ** 31 - 1


def scatter_rowterm_reference(indices: Tensor, rowterm_values: Tensor,
                              dim: int) -> Tensor:
    """Plain PyTorch version: a sequential ``index_add_`` into a (dim+1,)
    table whose last slot absorbs every padding id (all ids ``>= dim``
    clamp onto it), sliced off."""
    idx = indices.reshape(-1).long().clamp(max=dim)
    out = torch.zeros(dim + 1, dtype=torch.float32, device=indices.device)
    out.index_add_(0, idx, rowterm_values.reshape(-1).to(torch.float32))
    return out[:dim]


@dataclasses.dataclass(frozen=True)
class ColumnLayout:
    """Column-sorted view of an (n, k) ELL index pattern over ``dim``
    columns: what the kernel reads in place of the indices.

    Column c's entries are the flat slots ``perm[col_ptr[c]:col_ptr[c+1]]``
    in row order; padding slots (id >= dim) are not in ``perm``. Columns
    of more than ``SHORT_COLUMN`` entries own the pieces
    ``piece_ptr[c]:piece_ptr[c+1]``, each the range
    ``[piece_start[p], piece_end[p])`` of ``perm``.
    """

    perm: Tensor  # (nnz,) int32 flat slot positions, column-major
    col_ptr: Tensor  # (dim+1,) int32
    piece_ptr: Tensor  # (dim+1,) int32
    piece_start: Tensor  # (num_pieces,) int32
    piece_end: Tensor  # (num_pieces,) int32
    dim: int
    numel: int  # n·k of the pattern the layout was built from

    @property
    def nnz(self) -> int:
        return int(self.perm.shape[0])

    @property
    def num_pieces(self) -> int:
        return int(self.piece_start.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col_ptr.device


def build_pieces(col_ptr: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(piece_ptr, piece_start, piece_end) for a (dim+1,) column pointer:
    a column of L > ``SHORT_COLUMN`` entries gets ceil(L / ``PIECE``)
    consecutive pieces of ``PIECE`` entries (the last one shorter); a
    shorter column gets none. Offsets are computed in int64 and stored
    as int32."""
    ptr = col_ptr.to(torch.int64)
    counts = ptr[1:] - ptr[:-1]
    pieces = torch.where(counts > SHORT_COLUMN,
                         torch.div(counts + PIECE - 1, PIECE,
                                   rounding_mode="floor"),
                         torch.zeros_like(counts))
    piece_ptr = torch.cat([pieces.new_zeros(1), torch.cumsum(pieces, 0)])
    dim = counts.shape[0]
    col = torch.repeat_interleave(
        torch.arange(dim, device=ptr.device), pieces)
    j = torch.arange(col.shape[0], device=ptr.device) - piece_ptr[col]
    start = ptr[col] + j * PIECE
    end = torch.minimum(start + PIECE, ptr[col + 1])
    return (piece_ptr.to(torch.int32), start.to(torch.int32),
            end.to(torch.int32))


def build_layout(indices: Tensor, dim: int) -> ColumnLayout:
    """The column-sorted layout of ``indices`` (n, k) over ``dim``
    columns, on ``indices``' device: one stable sort of the flat ids
    (padding clamped to ``dim`` sorts last), then the column pointer by
    binary search. Built once per staged batch."""
    if indices.dim() != 2:
        raise ValueError(f"indices must be (n, k), got "
                         f"{tuple(indices.shape)}")
    numel = indices.numel()
    if numel > MAX_ENTRIES:
        raise ValueError(f"{numel} ELL slots exceed the kernel's int32 "
                         f"offsets ({MAX_ENTRIES})")
    flat = indices.reshape(-1).to(torch.int32).clamp(max=dim)
    if numel and int(flat.min()) < 0:
        raise ValueError("ELL indices must be >= 0")
    ids, order = torch.sort(flat, stable=True)
    col_ptr = torch.searchsorted(
        ids, torch.arange(dim + 1, dtype=torch.int32, device=ids.device))
    nnz = int(col_ptr[dim])
    perm = order[:nnz].to(torch.int32)
    del ids, order
    col_ptr = col_ptr.to(torch.int32)
    piece_ptr, start, end = build_pieces(col_ptr)
    return ColumnLayout(perm=perm, col_ptr=col_ptr, piece_ptr=piece_ptr,
                        piece_start=start, piece_end=end, dim=int(dim),
                        numel=int(numel))


def _check(indices: Tensor, rv: Tensor, dim: int) -> None:
    if indices.dtype != torch.int32 or indices.dim() != 2:
        raise ValueError(f"indices must be (n, k) int32, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    if rv.dtype != torch.float32 or rv.shape != indices.shape:
        raise ValueError(f"rowterm_values must be {tuple(indices.shape)} "
                         f"float32, got {rv.dtype} {tuple(rv.shape)}")
    if dim < 0:
        raise ValueError(f"dim must be >= 0, got {dim}")
    if indices.device != rv.device:
        raise ValueError(f"ell_scatter tensors lie on several devices: "
                         f"{indices.device}, {rv.device}")
    if indices.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_scatter runs on cpu or cuda, not "
                         f"{indices.device}")


_launcher = None


def load() -> None:
    """Build and load the kernel library now."""
    global _launcher
    if _launcher is not None:
        return
    lib = _build.load(NAME)
    fn = lib.ell_scatter
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launcher = fn


def scatter_rowterm(indices: Tensor, rowterm_values: Tensor, dim: int,
                    layout: Optional[ColumnLayout] = None) -> Tensor:
    """Σᵢ Σₖ rv[i,k] · e(indices[i,k]) into shape (dim,) float32.

    ``indices`` (n, k) int32 ELL ids (padding == any id >= dim),
    ``rowterm_values`` (n, k) float32, typically ``r[:, None] * values``.
    CPU tensors: the plain version. CUDA tensors: the kernel, on the
    current stream, over ``layout``, which is required there: built from
    ``indices`` by :func:`build_layout`, once per staged batch
    (``SparseBatch.to`` does it). The layout is not checked against the
    ids: it must have been built from these indices.
    """
    _check(indices, rowterm_values, dim)
    if indices.device.type == "cpu":
        return scatter_rowterm_reference(indices, rowterm_values, dim)
    if layout is None:
        raise ValueError("ell_scatter on a CUDA tensor needs the column "
                         "layout of its indices (build_layout, or a "
                         "SparseBatch staged with .to())")
    if layout.dim != dim or layout.numel != indices.numel() \
            or layout.device != indices.device:
        raise ValueError(
            f"layout (dim {layout.dim}, {layout.numel} slots, "
            f"{layout.device}) does not fit indices (dim {dim}, "
            f"{indices.numel()} slots, {indices.device})")
    rv = rowterm_values.contiguous()
    out = torch.empty(dim, dtype=torch.float32, device=rv.device)
    if dim == 0:
        return out
    partial = torch.empty(max(layout.num_pieces, 1), dtype=torch.float32,
                          device=rv.device)
    load()
    with torch.cuda.device(rv.device):
        stream = torch.cuda.current_stream(rv.device).cuda_stream
        err = _launcher(rv.data_ptr(), layout.perm.data_ptr(),
                        layout.col_ptr.data_ptr(),
                        layout.piece_ptr.data_ptr(),
                        layout.piece_start.data_ptr(),
                        layout.piece_end.data_ptr(), partial.data_ptr(),
                        out.data_ptr(), int(dim), layout.num_pieces, stream)
    if err != 0:
        raise RuntimeError(f"ell_scatter kernel launch failed: CUDA error "
                           f"{err}")
    scatter_rowterm.launches += 1
    return out


# Kernel launches in this process: a run shows through it that a path
# went through the kernel. The plain version never moves it.
scatter_rowterm.launches = 0
