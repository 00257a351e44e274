"""Cold-class gradient of the hybrid layout: a gather, a product, a row sum.

    out[c] = Σ_l r_pad[rows[c, l]] · vals[c, l],   r_pad = [r, 0]

The hybrid hot/cold layout (``ops/hybrid_sparse.py``) holds its cold
columns in count classes: class k is C_k columns padded to L_k entries
each, their row ids (padding id ``n``, which reads the zero slot) and
values. Every class's ids and values lie in two flat arrays, class after
class; a :class:`ClassTable` says where each class lies, where its
outputs go and how the kernel covers it. The classes' slices of the
gradient, of the H·v row term and (with ``vals²``) of the Hessian
diagonal are this function of the row terms ``r``:
:func:`cold_grad_classes` computes every class of a pass in one launch,
:func:`cold_grad` one (C, L) class, the same kernel over a one-class
table. The hand-written Hopper kernel is ``csrc/cold_grad.cu``; it
replaces the TPU kernel ``fused_cold_grad`` of
``dev-scripts/exp_cold_gather.py``, which fuses the JAX package's two
XLA passes (``photon_ml_tpu/ops/hybrid_sparse.py`` ``_cold_grad``: the
gather ``r[rowids]``, then padded row sums), and its source note gives
the bound and the design. No (C, L) gathered temporary exists on the
card.

The kernel sums each column in an order fixed by its L, with no atomics,
so two launches give the same bits; the plain version sums in another
order, so the two agree within float32 rounding, and bit for bit where
every partial sum is exact (integer-valued inputs).

The wrappers take CPU tensors to the plain version and CUDA tensors to
the kernel, or raise. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from photon_ml_torch.ops.kernels import _build

Tensor = torch.Tensor

NAME = "cold_grad"

# The kernel's row ids and r's length are int32.
MAX_ROWS = 2 ** 31 - 1
# csrc/cold_grad.cu: threads a block (kThreads), classes a table
# (kMaxClasses; power-of-two classes of counts below 2^31 need at most 32),
# int64 fields a class in the launcher's table (kFields), and the grid's
# block limit.
BLOCK_THREADS = 256
MAX_CLASSES = 32
_FIELDS = 6
MAX_BLOCKS = 2 ** 31 - 1
# The policy for threads per column: each thread takes about this many
# slots of its column (one 16-byte load of ids and one of values, then
# their four gathers), up to a whole block per column; columns longer
# than a block's worth give each thread several such chunks.
# chip_smoke.py times the other policies of 2 to 64 slots beside it.
SLOTS_PER_THREAD = 4


def threads_per_column(length: int,
                       slots_per_thread: int = SLOTS_PER_THREAD) -> int:
    """Threads the kernel gives one column of ``length`` slots: the
    smallest power of two that leaves each at most ``slots_per_thread``
    slots, at most a block."""
    t = 1
    while t < BLOCK_THREADS and t * slots_per_thread < length:
        t *= 2
    return t


@dataclasses.dataclass(frozen=True)
class ClassTable:
    """Where each (C, L) class lies in a flat cold layout, in class
    order, and how one launch covers it: its first slot in the flat
    arrays, its first output, its threads per column and its first block
    (a block serves ``BLOCK_THREADS // threads`` columns of one class)."""

    shapes: tuple[tuple[int, int], ...]
    offsets: tuple[int, ...]
    out_offsets: tuple[int, ...]
    threads: tuple[int, ...]
    block_starts: tuple[int, ...]
    num_blocks: int
    num_slots: int
    num_columns: int
    # The same rows as the launcher reads them: _FIELDS int64 a class.
    packed: ctypes.Array = dataclasses.field(repr=False, compare=False)


def class_table(shapes: Sequence[Sequence[int]],
                slots_per_thread: int = SLOTS_PER_THREAD) -> ClassTable:
    """The table of classes of ``shapes`` [(C, L), ...] laid out one
    after another in the flat arrays and in the output, each column
    given ``threads_per_column(L, slots_per_thread)`` threads."""
    shapes = tuple((int(c), int(length)) for c, length in shapes)
    if len(shapes) > MAX_CLASSES:
        raise ValueError(f"cold_grad: {len(shapes)} classes exceed the "
                         f"kernel's table of {MAX_CLASSES}")
    offsets, outs, threads, starts = [], [], [], []
    slot = out = block = 0
    for c, length in shapes:
        if c < 0 or length < 0:
            raise ValueError(f"cold_grad: class shape {(c, length)}")
        t = threads_per_column(length, slots_per_thread)
        offsets.append(slot)
        outs.append(out)
        threads.append(t)
        starts.append(block)
        slot += c * length
        out += c
        block += -(-c * t // BLOCK_THREADS)
    if block > MAX_BLOCKS:
        raise ValueError(f"cold_grad: {block} blocks exceed the grid's "
                         f"{MAX_BLOCKS}")
    packed = (ctypes.c_longlong * (_FIELDS * len(shapes)))(*(
        x for k, (c, length) in enumerate(shapes)
        for x in (offsets[k], c, length, threads[k], outs[k], starts[k])))
    return ClassTable(shapes=shapes, offsets=tuple(offsets),
                      out_offsets=tuple(outs), threads=tuple(threads),
                      block_starts=tuple(starts), num_blocks=block,
                      num_slots=slot, num_columns=out, packed=packed)


def class_views(flat: Tensor, table: ClassTable) -> tuple[Tensor, ...]:
    """Each class of ``table`` as a (C, L) view into the flat ``flat``."""
    return tuple(flat[off:off + c * length].view(c, length)
                 for off, (c, length) in zip(table.offsets, table.shapes))


def cold_grad_reference(r: Tensor, rows: Tensor, vals: Tensor) -> Tensor:
    """Plain PyTorch version: ``(cat(r, 0)[rows] * vals).sum(1)``; every
    id outside [0, n) reads the zero slot."""
    n = r.shape[0]
    ids = rows.long()
    ids = ids.masked_fill((ids < 0) | (ids > n), n)
    return (torch.cat([r, r.new_zeros(1)])[ids] * vals).sum(dim=1)


def cold_grad_classes_reference(r: Tensor, rows: Tensor, vals: Tensor,
                                table: ClassTable) -> Tensor:
    """Plain version of :func:`cold_grad_classes`: each class's
    :func:`cold_grad_reference`, concatenated."""
    parts = [cold_grad_reference(r, a, b) for a, b in zip(
        class_views(rows, table), class_views(vals, table))]
    return torch.cat(parts) if parts else r.new_zeros(0)


def _check_r(r: Tensor) -> None:
    if r.dtype != torch.float32 or r.dim() != 1:
        raise ValueError(f"cold_grad: r must be (n,) float32, got {r.dtype} "
                         f"{tuple(r.shape)}")
    if r.shape[0] > MAX_ROWS:
        raise ValueError(f"cold_grad: {r.shape[0]} rows exceed the "
                         f"kernel's int32 row ids ({MAX_ROWS})")


def _check_devices(*tensors: Tensor) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"cold_grad tensors lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"cold_grad runs on cpu or cuda, not {device}")


def _check(r: Tensor, rows: Tensor, vals: Tensor) -> None:
    _check_r(r)
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"cold_grad: rows must be (C, L) int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if vals.dtype != torch.float32 or vals.shape != rows.shape:
        raise ValueError(f"cold_grad: vals must be {tuple(rows.shape)} "
                         f"float32, got {vals.dtype} {tuple(vals.shape)}")
    _check_devices(r, rows, vals)


def _check_flat(r: Tensor, rows: Tensor, vals: Tensor,
                table: ClassTable) -> None:
    _check_r(r)
    want = (table.num_slots,)
    if rows.dtype != torch.int32 or tuple(rows.shape) != want:
        raise ValueError(f"cold_grad: rows must be {want} int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if vals.dtype != torch.float32 or tuple(vals.shape) != want:
        raise ValueError(f"cold_grad: vals must be {want} float32, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    _check_devices(r, rows, vals)


_launcher = None


def load() -> None:
    """Build and load the kernel library now."""
    global _launcher
    if _launcher is not None:
        return
    fn = _build.load(NAME).cold_grad_classes
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launcher = fn


def _launch(r: Tensor, rows: Tensor, vals: Tensor,
            table: ClassTable) -> Tensor:
    """One launch over every class of ``table`` on the current stream."""
    rr, ids, v = r.contiguous(), rows.contiguous(), vals.contiguous()
    out = torch.empty(table.num_columns, dtype=torch.float32,
                      device=rr.device)
    if table.num_blocks == 0:
        return out
    load()
    with torch.cuda.device(rr.device):
        stream = torch.cuda.current_stream(rr.device).cuda_stream
        err = _launcher(rr.data_ptr(), ids.data_ptr(), v.data_ptr(),
                        out.data_ptr(), len(table.shapes),
                        ctypes.addressof(table.packed), table.num_blocks,
                        int(rr.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"cold_grad kernel launch failed: CUDA error "
                           f"{err}")
    cold_grad.launches += 1
    return out


def cold_grad_classes(r: Tensor, rows: Tensor, vals: Tensor,
                      table: ClassTable) -> Tensor:
    """(num_columns,) float32: every class's column sums, class after
    class, ``Σ_l r_pad[rows_k[c, l]] · vals_k[c, l]``.

    ``r`` (n,) float32 row terms; ``rows`` (num_slots,) int32 and
    ``vals`` (num_slots,) float32, the classes of ``table`` flat, one
    after another (padding id ``n``; any id outside [0, n) reads 0). CPU
    tensors: the plain version. CUDA tensors: the kernel, one launch on
    the current stream.
    """
    _check_flat(r, rows, vals, table)
    if r.device.type == "cpu":
        return cold_grad_classes_reference(r, rows, vals, table)
    return _launch(r, rows, vals, table)


def cold_grad(r: Tensor, rows: Tensor, vals: Tensor) -> Tensor:
    """(C,) float32: ``Σ_l r_pad[rows[c, l]] · vals[c, l]`` for one class.

    ``r`` (n,) float32 row terms; ``rows`` (C, L) int32 row ids, padding
    ``n`` (any id outside [0, n) reads 0); ``vals`` (C, L) float32. CPU
    tensors: the plain version. CUDA tensors: the kernel over a one-class
    table, one launch on the current stream.
    """
    _check(r, rows, vals)
    if r.device.type == "cpu":
        return cold_grad_reference(r, rows, vals)
    return _launch(r, rows.reshape(-1), vals.reshape(-1),
                   class_table([rows.shape]))


# Launches of the kernel in this process, through either entry: a run
# shows through it that a path went through the kernel. The plain
# versions never move it.
cold_grad.launches = 0
