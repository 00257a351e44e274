"""ELL scatter-add: ``out[c] = Σ_{i,k} rv[i, k] · [indices[i, k] == c]``.

The gradient, H·v and Hessian-diagonal reduction of the sparse ELL
objective (``ops/sparse_aggregators.py``): every slot's row term lands
on its feature column, and padding ids (``>= dim``; the ELL contract
puts them at ``dim``) add nothing. The hand-written Hopper kernels are
in ``csrc/ell_scatter.cu``; they replace the TPU kernel
``scatter_rowterm_pallas`` of ``photon_ml_tpu/ops/kernels/ell_scatter.py``
and its source note gives the bound and the design.

Two entry points share one summation order:

- :func:`scatter_rowterm` takes the (n, k) row terms as the caller formed
  them. The hybrid layout's cold margins and each streamed chunk's cold
  tier call it.
- :func:`ell_rmatvec` takes ``r`` (n,) and the values and forms each
  term ``r[row] · value`` (or ``r[row] · value²``) itself, so no (n, k)
  row-term tensor exists on the card. It is Xᵀr over the ELL pattern, and
  the ELL objective calls it for every gradient, H·v and diagonal.

Neither compares every slot with every column, as the Pallas program
does (O(d·nnz)). Both read a column-sorted layout of the index pattern,
built once per staged batch by :func:`build_layout` (one stable sort of
the flat ids, so entries keep row order within a column), and sum each
column's segment in a fixed order. Columns of at most ``SHORT_COLUMN``
entries are summed by one thread. Longer ones are cut into pieces of at
most ``PIECE`` entries, each summed by a warp, and the pieces are then
added in order. The generic route's layout carries ``perm``, the flat
slot of each entry, and gathers the caller's row terms through it. The
fused route's layout carries each entry's row and value in column order
instead (``rows``, ``sorted_values``), so it reads them sequentially and
gathers only ``r[row]``. Each term is one float32 product, and the sums
run in the same order, so :func:`ell_rmatvec` gives the same bits as
:func:`scatter_rowterm` over ``r[:, None] * values``. No atomics: two
launches on the same inputs give the same bits. The order differs from
the plain version's sequential ``index_add_``, so kernel and plain
version agree within float32 rounding, and bit for bit where every
partial sum is exact (integer-valued inputs).

The wrappers take CPU tensors to the plain version and CUDA tensors to
the kernel, or raise. There is no fallback from one to the other.
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
    columns: what the kernels read in place of the indices.

    Column c's entries are the positions ``col_ptr[c]:col_ptr[c+1]`` of
    the column order, in row order; padding slots (id >= dim) are not in
    it. Columns of more than ``SHORT_COLUMN`` entries own the pieces
    ``piece_ptr[c]:piece_ptr[c+1]``, each the range
    ``[piece_start[p], piece_end[p])`` of that order.

    A layout built from the ids alone carries ``perm``, the flat slot of
    each entry, which :func:`scatter_rowterm` reads. One built with the
    values carries ``rows`` and ``sorted_values`` instead, which
    :func:`ell_rmatvec` reads: it is tied to those values, and a batch
    whose values change needs a new one.
    """

    col_ptr: Tensor  # (dim+1,) int32
    piece_ptr: Tensor  # (dim+1,) int32
    piece_start: Tensor  # (num_pieces,) int32
    piece_end: Tensor  # (num_pieces,) int32
    dim: int
    numel: int  # n·k of the pattern the layout was built from
    nnz: int  # valid slots: entries of the column order
    perm: Optional[Tensor] = None  # (nnz,) int32 flat slot positions
    rows: Optional[Tensor] = None  # (nnz,) int32 row of each entry
    sorted_values: Optional[Tensor] = None  # (nnz,) float32 its value

    @property
    def num_pieces(self) -> int:
        return int(self.piece_start.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col_ptr.device

    @property
    def nbytes(self) -> int:
        """Bytes the layout holds on its device."""
        return sum(t.numel() * t.element_size() for t in (
            self.col_ptr, self.piece_ptr, self.piece_start, self.piece_end,
            self.perm, self.rows, self.sorted_values) if t is not None)


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


def build_layout(indices: Tensor, dim: int,
                 values: Optional[Tensor] = None) -> ColumnLayout:
    """The column-sorted layout of ``indices`` (n, k) over ``dim``
    columns, on ``indices``' device: one stable sort of the flat ids
    (padding clamped to ``dim`` sorts last), then the column pointer by
    binary search. Built once per staged batch.

    Without ``values`` it carries ``perm``, for :func:`scatter_rowterm`.
    With ``values`` (n, k) float32 it carries, for :func:`ell_rmatvec`,
    each entry's row (``perm // k``) and value (``values.reshape(-1)[perm]``)
    in column order, and no ``perm``: nothing on the card reads it once
    the terms are formed from rows and values."""
    if indices.dim() != 2:
        raise ValueError(f"indices must be (n, k), got "
                         f"{tuple(indices.shape)}")
    if values is not None and (values.shape != indices.shape
                               or values.dtype != torch.float32
                               or values.device != indices.device):
        raise ValueError(f"values must be {tuple(indices.shape)} float32 "
                         f"on {indices.device}, got {values.dtype} "
                         f"{tuple(values.shape)} on {values.device}")
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
    rows = sorted_values = None
    if values is not None:
        k = max(int(indices.shape[1]), 1)
        rows = torch.div(perm, k, rounding_mode="floor")
        sorted_values = torch.index_select(values.reshape(-1), 0, perm)
        perm = None
    return ColumnLayout(col_ptr=col_ptr, piece_ptr=piece_ptr,
                        piece_start=start, piece_end=end, dim=int(dim),
                        numel=int(numel), nnz=nnz, perm=perm, rows=rows,
                        sorted_values=sorted_values)


def _check(indices: Tensor, dim: int, **floats: tuple) -> None:
    """``indices`` (n, k) int32, ``dim`` >= 0, each of ``floats`` (name:
    (tensor, shape)) float32 of its shape, all on one device, cpu or
    cuda."""
    if indices.dtype != torch.int32 or indices.dim() != 2:
        raise ValueError(f"indices must be (n, k) int32, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    for name, (t, shape) in floats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)} float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dim < 0:
        raise ValueError(f"dim must be >= 0, got {dim}")
    devices = {t.device for t, _ in floats.values()} | {indices.device}
    if len(devices) > 1:
        raise ValueError(f"ell_scatter tensors lie on several devices: "
                         f"{sorted(map(str, devices))}")
    if indices.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_scatter runs on cpu or cuda, not "
                         f"{indices.device}")


def _fit(layout: Optional[ColumnLayout], indices: Tensor, dim: int,
         field: str) -> None:
    """Raise unless ``layout`` is a layout of ``indices``' shape over
    ``dim`` on their device that carries ``field``; a CUDA call needs
    one."""
    if layout is None:
        if indices.device.type == "cuda":
            raise ValueError("ell_scatter on a CUDA tensor needs the column "
                             "layout of its indices (build_layout, or a "
                             "SparseBatch staged with .to())")
        return
    if layout.dim != dim or layout.numel != indices.numel() \
            or layout.device != indices.device:
        raise ValueError(
            f"layout (dim {layout.dim}, {layout.numel} slots, "
            f"{layout.device}) does not fit indices (dim {dim}, "
            f"{indices.numel()} slots, {indices.device})")
    if getattr(layout, field) is None:
        raise ValueError(
            f"the layout carries no {field}: scatter_rowterm reads a layout "
            f"built from the ids alone, ell_rmatvec one built with the "
            f"values (build_layout(indices, dim, values))")


_launchers: Optional[dict] = None


def load() -> None:
    """Build and load the kernel library now."""
    global _launchers
    if _launchers is not None:
        return
    lib = _build.load(NAME)
    generic = lib.ell_scatter
    generic.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    generic.restype = ctypes.c_int
    fused = lib.ell_rmatvec
    fused.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fused.restype = ctypes.c_int
    _launchers = {"scatter_rowterm": generic, "ell_rmatvec": fused}


def _launch(name: str, layout: ColumnLayout, dim: int,
            inputs: tuple, flags: tuple = ()) -> Tensor:
    """Run kernel ``name`` over ``layout`` on the current stream into a
    new (dim,) float32 tensor. The C call takes the ``inputs`` tensors'
    pointers, the layout's arrays, the scratch and the output, then
    ``dim``, the piece count, the ints ``flags`` and the stream."""
    device = layout.device
    out = torch.empty(dim, dtype=torch.float32, device=device)
    if dim == 0:
        return out
    partial = torch.empty(max(layout.num_pieces, 1), dtype=torch.float32,
                          device=device)
    load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launchers[name](
            *(t.data_ptr() for t in inputs), layout.col_ptr.data_ptr(),
            layout.piece_ptr.data_ptr(), layout.piece_start.data_ptr(),
            layout.piece_end.data_ptr(), partial.data_ptr(),
            out.data_ptr(), int(dim), layout.num_pieces, *flags, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def scatter_rowterm(indices: Tensor, rowterm_values: Tensor, dim: int,
                    layout: Optional[ColumnLayout] = None) -> Tensor:
    """Σᵢ Σₖ rv[i,k] · e(indices[i,k]) into shape (dim,) float32.

    ``indices`` (n, k) int32 ELL ids (padding == any id >= dim),
    ``rowterm_values`` (n, k) float32. CPU tensors: the plain version.
    CUDA tensors: the kernel, on the current stream, over ``layout``,
    which is required there: built from ``indices`` alone by
    :func:`build_layout`, once per staged batch. The layout is not
    checked against the ids: it must have been built from these indices.
    """
    _check(indices, dim, rowterm_values=(rowterm_values, indices.shape))
    _fit(layout, indices, dim, "perm")
    if indices.device.type == "cpu":
        return scatter_rowterm_reference(indices, rowterm_values, dim)
    out = _launch("scatter_rowterm", layout, dim,
                  (rowterm_values.contiguous(), layout.perm))
    if dim:
        scatter_rowterm.launches += 1
    return out


def ell_rmatvec_reference(indices: Tensor, values: Tensor, r: Tensor,
                          dim: int, square: bool = False) -> Tensor:
    """Plain PyTorch version of :func:`ell_rmatvec`: the row terms
    ``r[:, None] * values`` (``values * values`` under ``square``) formed
    whole, then :func:`scatter_rowterm_reference`."""
    v = values * values if square else values
    return scatter_rowterm_reference(indices, r[:, None] * v, dim)


def ell_rmatvec(indices: Tensor, values: Tensor, r: Tensor, dim: int,
                layout: Optional[ColumnLayout] = None,
                square: bool = False) -> Tensor:
    """Xᵀr over the ELL pattern: Σᵢ Σₖ r[i]·values[i,k] · e(indices[i,k])
    into shape (dim,) float32, with ``values[i,k]²`` under ``square``.

    ``indices`` (n, k) int32 ELL ids (padding == any id >= dim),
    ``values`` (n, k) float32, ``r`` (n,) float32. CPU tensors: the plain
    version. CUDA tensors: the kernel, on the current stream, over
    ``layout``, which is required there: built by :func:`build_layout`
    from ``indices`` and ``values`` (``SparseBatch.to`` does it). The
    kernel forms each term from ``r`` and the layout's rows and values,
    and gives the same bits as :func:`scatter_rowterm` over the
    materialised ``r[:, None] * values``. The layout is not checked
    against the ids or values: it must have been built from these.
    """
    _check(indices, dim, values=(values, indices.shape),
           r=(r, indices.shape[:1]))
    _fit(layout, indices, dim, "sorted_values")
    if indices.device.type == "cpu":
        return ell_rmatvec_reference(indices, values, r, dim, square)
    out = _launch("ell_rmatvec", layout, dim,
                  (r.contiguous(), layout.rows, layout.sorted_values),
                  (int(bool(square)),))
    if dim:
        ell_rmatvec.launches += 1
    return out


# Kernel launches in this process: a run shows through them that a path
# went through a kernel. The plain versions never move them.
scatter_rowterm.launches = 0
ell_rmatvec.launches = 0
