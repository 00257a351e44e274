"""Row-streamed sparse GLM aggregates: the Criteo row axis on one device.

Port of ``photon_ml_tpu/ops/streaming_sparse.py`` on one device. Reference
parity: photon-api ``DistributedGLMLossFunction`` computes each
value/gradient as one pass over RDD partitions, so the row axis never has
to fit on one executor. Here the example rows live on the HOST in
fixed-size chunks, and every objective evaluation streams them through the
device, accumulating ``(value, gradient)`` in float32 there. The device
holds at most ``prefetch_depth`` streamed chunks (plus any pinned ones), so
the row count is bounded by host memory, not device memory.

**Chunk layout: hot-dense block + cold ELL.** Staging (host numpy, the
reference's own calls, so the staged arrays equal its bit for bit)
densifies each chunk's top-``num_hot`` columns into an (n, H) block, the
Zipf head that holds most of the entries, and keeps the rest in ELL with
their ORIGINAL column ids (hot entries become inert slots at column d).
Every chunk has the same shapes; a short final chunk is padded with
weight-0 rows.

**int8 storage.** ``feature_dtype="int8"`` stores ``X_hot`` and
``cold_vals`` as symmetric int8 codes (q = round(x / s), s = max|col| /
127, zero-point 0, so zeros stay exact) with float32 scales beside them:
``hot_scale`` per hot column, ``cold_scale`` per original column (d + 1,
the sentinel's 0). The margins fold the scales into the coefficients
(w·(s·q) = (w·s)·q); the gradient sums raw r·q and scales the result
once per column. No (n, H) float32 copy of the block is made: the hot
tier runs through ``ops/kernels/stream_fused.py`` (hand-written Hopper
kernels on a card), and the cold tier's gradient through
``ops/kernels/ell_scatter.py`` over a column layout that the gradient
pass builds on the device after each chunk's transfer (cached for pinned
chunks). Both kernels sum in a fixed order, so a pass gives the same bits
every time.

**bfloat16 storage.** ``feature_dtype="bfloat16"`` stores ``X_hot`` and
``cold_vals`` in bfloat16, rounded once (to nearest even), as the
reference does: half the bytes of every transfer. The chunk routes round
what the reference's default (unfused) route rounds and nothing else:
the hot coefficients before ``hot_margins`` and the residual r before
``hot_rmatvec``; the cold tier multiplies float32 coefficients and
residuals by its values upcast to float32. Every product then
accumulates in float32. A bfloat16 chunk store keeps the bits as 2-byte
void fields, as the reference's ``ml_dtypes`` arrays are saved.

**Host→device.** :class:`ChunkStream` pins nothing itself: the coordinate
pins the staged chunks' host memory once (:func:`pin_host_memory`). Each
pass copies the streamed chunks with ``non_blocking`` copies on a copy
stream of its own into a ring of ``prefetch_depth`` device buffers; the
compute stream waits on each copy's event, and a buffer is refilled only
after the compute stream has passed an event recorded behind its last
reader. ``bytes_moved`` and ``chunks_moved`` count what the stream
delivered.

**Observability.** With a tracer or a metrics registry active
(``photon_ml_torch.obs``), every pass is a ``stream.pass`` span and every
streamed chunk a ``stream.chunk_transfer`` span (cat ``transfer``) with
``photon_transfer_{bytes,seconds,chunks}_total{kind="stream",dtype=}``
and the ``photon_stream_inflight_chunks`` gauge; off, each site is one
``None`` check. The bytes and chunks counted equal ``bytes_moved`` and
``chunks_moved``. On the CPU a chunk is read in place and its span times
that read on the host. On a card the copy is asynchronous, so its span
times the copy's enqueue on the host, as the reference's times its
``device_put``, and nests in its pass by construction. The copy itself
is timed by a pair of CUDA events around it on the copy stream (and each
pass by a pair on the compute stream), read only once the events have
completed — at the next pass, whose caller has read the previous pass's
value by then, or at :meth:`ChunkStream.flush_timings` — and set then on
the span as ``device_seconds`` (and on the pass's). Reading them never
waits on the card. (A device-timed span placed at its enqueue would end
after its pass whenever the host finishes enqueueing a pass before the
card finishes its copies.)

Not ported here: the sharded stream and mesh helpers (slice 9), fault
sites and the transfer retry ladder (slices 9–10), the compile-cache
counters (a torch program has no compile cache to count).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from photon_ml_torch import obs
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.ops.kernels import ell_scatter, stream_fused
from photon_ml_torch.ops.kernels.ell_scatter import ColumnLayout
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.utils.diskio import atomic_write, file_crc32

Tensor = torch.Tensor

logger = logging.getLogger("photon_ml_torch.ops")

_CHUNK_FIELDS = ("X_hot", "hot_cols", "cold_cols", "cold_vals", "labels",
                 "weights", "offsets", "hot_scale", "cold_scale")


@dataclasses.dataclass(frozen=True)
class CanonicalChunk:
    """One chunk: hot-dense block + cold ELL, as CPU tensors after
    staging and device tensors while a pass reads it.

    Under int8 storage ``X_hot``/``cold_vals`` hold the codes and the two
    scale vectors are present; under bfloat16 both are bfloat16.
    ``layout`` is the column layout of ``cold_cols`` that the
    ``ell_scatter`` kernel reads, built on a CUDA device only."""

    X_hot: Tensor  # (n, H) — the chunk's top-H columns, densified
    hot_cols: Tensor  # (H,) int32 original column ids (pad == d)
    cold_cols: Tensor  # (n, k) int32 original ids; hot/pad entries == d
    cold_vals: Tensor  # (n, k); hot/pad entries == 0
    labels: Tensor  # (n,)
    weights: Tensor  # (n,); 0 marks pad rows of a short final chunk
    offsets: Tensor  # (n,)
    num_features: int
    hot_scale: Optional[Tensor] = None  # (H,), int8 only
    cold_scale: Optional[Tensor] = None  # (d + 1,), int8 only
    layout: Optional[ColumnLayout] = dataclasses.field(
        default=None, repr=False, compare=False)

    def tensors(self) -> dict[str, Tensor]:
        """The chunk's payload by field name (absent scales left out)."""
        return {name: getattr(self, name) for name in _CHUNK_FIELDS
                if getattr(self, name) is not None}

    def structure(self):
        """Shape signature; identical across the chunks of one stream."""
        return (tuple(self.X_hot.shape), tuple(self.cold_cols.shape),
                self.num_features, chunk_dtype(self))


@dataclasses.dataclass(frozen=True)
class ChunkedHybrid:
    """Host-resident chunked layout of one logical (n, d) batch.

    Equal row counts per chunk (a short final chunk padded with weight-0
    rows, inert in every aggregate; their margins are dropped by
    :func:`margins_chunked`). ``num_rows`` is the REAL row count."""

    chunks: tuple[CanonicalChunk, ...]
    num_rows: int
    chunk_rows: int

    @property
    def dim(self) -> int:
        return self.chunks[0].num_features

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)


FEATURE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
_SCALE_BYTES_PER_COLUMN = {"float32": 0, "bfloat16": 0, "int8": 4}
INT8_QMAX = 127.0  # symmetric: codes span [-127, 127], zero-point 0


def feature_dtype_name(feature_dtype) -> str:
    """Canonical name of a chunk-storage dtype spec (string, numpy or
    torch dtype, or None = float32). Unknown dtypes raise."""
    if feature_dtype is None:
        return "float32"
    if isinstance(feature_dtype, str):
        name = feature_dtype.lower()
    elif isinstance(feature_dtype, torch.dtype):
        name = str(feature_dtype).replace("torch.", "")
    else:
        try:
            name = np.dtype(feature_dtype).name
        except TypeError:
            name = str(feature_dtype)
    if name not in FEATURE_ITEMSIZE:
        raise ValueError(
            f"unsupported streaming feature_dtype {feature_dtype!r}; "
            f"expected one of {sorted(FEATURE_ITEMSIZE)}")
    return name


def chunk_dtype(ch: CanonicalChunk) -> str:
    """The storage dtype a staged chunk actually carries."""
    if ch.cold_scale is not None:
        return "int8"
    if ch.X_hot.dtype == torch.bfloat16:
        return "bfloat16"
    return "float32"


def plan_num_hot(chunk_rows: int, hot_block_bytes: int,
                 feature_dtype) -> int:
    """Hot-block width that fits the byte budget (block bytes =
    chunk_rows × H × itemsize, plus the per-column scale under int8)."""
    name = feature_dtype_name(feature_dtype)
    per_column = (chunk_rows * FEATURE_ITEMSIZE[name]
                  + _SCALE_BYTES_PER_COLUMN[name])
    return max(8, int(hot_block_bytes) // per_column)


def quantize_rows_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-ROW int8 quantization: q = round(x / s) with
    s = max|row| / 127 (all-zero rows keep scale 0 and code 0, so
    dequantization is exact for them). Shared by the chunk hot block
    (transposed) and the serving model store's int8 cache."""
    x = np.asarray(x, np.float32)
    scale = np.abs(x).max(axis=-1) / INT8_QMAX if x.size else \
        np.zeros(x.shape[:-1], np.float32)
    scale = np.asarray(scale, np.float32)
    denom = np.where(scale > 0.0, scale, 1.0)
    q = np.clip(np.rint(x / denom[..., None]), -INT8_QMAX,
                INT8_QMAX).astype(np.int8)
    return q, scale


def _quantize_cold_int8(cold_vals: np.ndarray, cold_cols: np.ndarray,
                        d: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-ORIGINAL-column symmetric int8 over a chunk's cold ELL: the
    scale table is (d + 1,), gathered like the padded coefficient vector.
    Inert entries all point at the sentinel column d, whose scale stays
    0 (their stored value is exactly 0)."""
    amax = np.zeros(d + 1, np.float32)
    np.maximum.at(amax, cold_cols.reshape(-1),
                  np.abs(cold_vals).reshape(-1))
    scale = amax / INT8_QMAX
    denom = np.where(scale > 0.0, scale, 1.0)
    q = np.clip(np.rint(cold_vals / denom[cold_cols]), -INT8_QMAX,
                INT8_QMAX).astype(np.int8)
    return q, scale


def _host(a) -> np.ndarray:
    return a.numpy() if isinstance(a, Tensor) else np.asarray(a)


def _tensor(a: Optional[np.ndarray]) -> Optional[Tensor]:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _build_canonical(raw, d: int, num_hot: int,
                     feature_dtype) -> CanonicalChunk:
    """Stage one ELL chunk into hot-dense + cold-ELL (host numpy)."""
    indices = _host(raw.indices)
    values = _host(raw.values)
    n = indices.shape[0]
    H = num_hot

    flat_col = indices.reshape(-1)
    flat_val = values.reshape(-1)
    live = (flat_col < d) & (flat_val != 0.0)
    counts = np.bincount(flat_col[live], minlength=d)
    # Top-H by count (ties at the hot boundary break as argpartition
    # breaks them; any split is the same objective). Columns with count
    # 0 may land in the tail of hot_cols on tiny chunks: their X_hot
    # columns stay zero and their id becomes the sentinel.
    order = np.argpartition(-counts, H - 1)[:H].astype(np.int32)
    order = order[np.argsort(-counts[order], kind="stable")]
    hot_live = counts[order] > 0
    hot_cols = np.where(hot_live, order, d).astype(np.int32)

    hot_slot = np.full(d + 1, -1, np.int64)
    hot_slot[hot_cols[hot_cols < d]] = np.flatnonzero(hot_cols < d)

    flat_row = np.repeat(np.arange(n, dtype=np.int32), indices.shape[1])
    slot = hot_slot[np.minimum(flat_col, d)]
    hot_sel = live & (slot >= 0)
    X_hot = np.zeros((n, H), np.float32)
    X_hot[flat_row[hot_sel], slot[hot_sel]] = flat_val[hot_sel]

    # Cold ELL: the original (n, k) arrays with hot entries inert.
    is_hot2d = (slot >= 0).reshape(indices.shape)
    dead = is_hot2d | ~live.reshape(indices.shape)
    cold_cols = np.where(dead, d, indices).astype(np.int32)
    cold_vals = np.where(dead, 0.0, values).astype(np.float32)

    hot_scale = cold_scale = None
    if feature_dtype_name(feature_dtype) == "int8":
        # Per hot column (transpose into the per-row helper) and per
        # original column for the cold ELL.
        q_hot, hot_scale = quantize_rows_int8(X_hot.T)
        X_hot = np.ascontiguousarray(q_hot.T)
        cold_vals, cold_scale = _quantize_cold_int8(cold_vals, cold_cols, d)
    X_hot, cold_vals = _tensor(X_hot), _tensor(cold_vals)
    if feature_dtype_name(feature_dtype) == "bfloat16":
        # Storage only: each value rounded once, to nearest even.
        X_hot = X_hot.to(torch.bfloat16)
        cold_vals = cold_vals.to(torch.bfloat16)
    return CanonicalChunk(
        X_hot=X_hot, hot_cols=_tensor(hot_cols),
        cold_cols=_tensor(cold_cols), cold_vals=cold_vals,
        labels=_tensor(np.asarray(_host(raw.labels), np.float32)),
        weights=_tensor(np.asarray(_host(raw.weights), np.float32)),
        offsets=_tensor(np.asarray(_host(raw.offsets), np.float32)),
        num_features=d, hot_scale=_tensor(hot_scale),
        cold_scale=_tensor(cold_scale))


def build_chunked(
    chunk_iter: Iterable,
    num_features: int,
    chunk_rows: int,
    num_hot: int = 512,
    feature_dtype="float32",
    log: Optional[Callable[[str], None]] = None,
    workers: int = 1,
) -> ChunkedHybrid:
    """Stage a stream of ELL chunks into host-resident canonical layouts.

    ``chunk_iter`` yields objects with ``indices / values / labels /
    weights / offsets`` host arrays or CPU tensors. Peak host memory
    beyond the staged output is ONE chunk serially; ``workers > 1`` fans
    the per-chunk canonicalization (GIL-releasing numpy) over a thread
    pool with a bounded window of ``workers + 2`` chunks, merged in plan
    order BIT-identically to the serial pass."""
    num_hot = min(num_hot, num_features)
    total = 0
    short_at = None
    rows_of: list[int] = []

    def _prepped():
        """Serial validation + tail padding ahead of the fan-out."""
        nonlocal total, short_at
        for i, raw in enumerate(chunk_iter):
            if short_at is not None:
                # Row bookkeeping (the margins' tail drop, the per-chunk
                # offset slices) assumes pad rows only at the STREAM tail.
                raise ValueError(
                    f"chunk {short_at} was short but chunk {i} follows — "
                    f"only the final chunk may have fewer than chunk_rows="
                    f"{chunk_rows} rows")
            n_i = int(_host(raw.labels).shape[0])
            if n_i > chunk_rows:
                raise ValueError(f"chunk {i} has {n_i} rows > chunk_rows="
                                 f"{chunk_rows}")
            total += n_i
            rows_of.append(n_i)
            if n_i < chunk_rows:
                short_at = i
                raw = _pad_chunk(raw, chunk_rows, num_features)
            yield i, raw

    chunks: list[CanonicalChunk] = []

    def _emit(i: int, ch: CanonicalChunk) -> None:
        chunks.append(ch)
        if log is not None:
            cold_live = int((ch.cold_cols < num_features).sum())
            log(f"staged chunk {i} ({rows_of[i]:,} rows, {num_hot} hot "
                f"cols, {cold_live:,} cold nnz)")

    if workers <= 1:
        for i, raw in _prepped():
            _emit(i, _build_canonical(raw, num_features, num_hot,
                                      feature_dtype))
    else:
        window: collections.deque = collections.deque()
        with cf.ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="pml-stream-stage") as pool:
            for i, raw in _prepped():
                window.append((i, pool.submit(
                    _build_canonical, raw, num_features, num_hot,
                    feature_dtype)))
                if len(window) > workers + 2:
                    j, fut = window.popleft()
                    _emit(j, fut.result())
            while window:
                j, fut = window.popleft()
                _emit(j, fut.result())
    if not chunks:
        raise ValueError("empty chunk stream")
    sigs = {ch.structure() for ch in chunks}
    if len(sigs) > 1:
        raise ValueError(
            f"chunks have {len(sigs)} distinct structures {sigs}; pad "
            "every chunk's ELL to one shared max_nnz")
    return ChunkedHybrid(chunks=tuple(chunks), num_rows=total,
                         chunk_rows=chunk_rows)


@dataclasses.dataclass(frozen=True)
class _RawChunk:
    """One ELL chunk of host arrays, as :func:`build_chunked` reads it."""

    indices: np.ndarray
    values: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    offsets: np.ndarray
    num_features: int


def iter_shard_chunks(shard, labels, weights, chunk_rows: int):
    """ELL chunks over a SparseShard's row ranges, staged with ZERO
    offsets (the streaming contract: in coordinate descent the residual
    arrives via ``train_model``'s offsets argument, never via the staged
    chunks). Slices are views (no copy)."""
    labels = _host(labels)
    weights = _host(weights)
    n = int(shard.indices.shape[0])
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        yield _RawChunk(
            indices=shard.indices[lo:hi], values=shard.values[lo:hi],
            labels=labels[lo:hi], weights=weights[lo:hi],
            offsets=np.zeros(hi - lo, np.float32),
            num_features=int(shard.num_features))


def _pad_chunk(raw, chunk_rows: int, d: int) -> _RawChunk:
    """Pad a short (final) chunk with weight-0 rows: every aggregate
    multiplies by weight before reducing, so pad rows add exactly 0."""
    idx = _host(raw.indices)
    n_i, nnz = idx.shape

    def pad0(a):
        a = _host(a)
        out = np.zeros((chunk_rows,) + a.shape[1:], a.dtype)
        out[:n_i] = a
        return out

    idx_p = np.full((chunk_rows, nnz), d, np.int32)
    idx_p[:n_i] = idx
    return _RawChunk(
        indices=idx_p, values=pad0(raw.values), labels=pad0(raw.labels),
        weights=pad0(raw.weights), offsets=pad0(raw.offsets),
        num_features=d)


# ----------------------------------------------------------- chunk passes


def _masked(weights: Tensor, term: Tensor) -> Tensor:
    return torch.where(weights > 0.0, weights * term,
                       torch.zeros_like(term))


def _chunk_margins_of(ch: CanonicalChunk, w_pad: Tensor,
                      offsets: Tensor) -> Tensor:
    """(n,) wᵀx + offset. The cold tier first, as the base: one gather of
    the (d + 1,) coefficient table over the (n, k) ELL and a row sum;
    then the hot tier through ``hot_margins``. Under int8 the scales fold
    into the coefficients (w·(s·q) = (w·s)·q); under bfloat16 the hot
    coefficients are rounded to bfloat16."""
    w_hot = stream_fused.rounded_like(
        ch.X_hot, torch.index_select(w_pad, 0, ch.hot_cols))
    w_cold = w_pad
    if ch.cold_scale is not None:
        w_cold = w_pad * ch.cold_scale
        w_hot = w_hot * ch.hot_scale
    n, k = ch.cold_cols.shape
    cold = torch.index_select(w_cold, 0, ch.cold_cols.reshape(-1)).reshape(
        n, k) * ch.cold_vals.to(torch.float32)
    return stream_fused.hot_margins(ch.X_hot, w_hot,
                                    offsets + cold.sum(dim=1))


def _chunk_rowterm_grad(ch: CanonicalChunk, r: Tensor) -> Tensor:
    """Σᵢ rᵢ·xᵢ in original space: the cold tier through ``ell_scatter``
    (row-term form; pad entries sit at column d and add nothing) over the
    chunk's column layout (built here on a card unless the chunk carries
    it, as a pinned chunk does), the
    hot tier through ``hot_rmatvec``, added onto ``hot_cols`` (unique but
    for the sentinel d, whose slot is dropped). Under int8 the raw r·q
    sums are scaled once per column; under bfloat16 the hot tier reads r
    rounded to bfloat16."""
    d = ch.num_features
    layout = ch.layout if ch.layout is not None else _with_layout(ch).layout
    cold = ell_scatter.scatter_rowterm(
        ch.cold_cols, r[:, None] * ch.cold_vals.to(torch.float32), d,
        layout=layout)
    g_hot = stream_fused.hot_rmatvec(ch.X_hot,
                                     stream_fused.rounded_like(ch.X_hot, r))
    if ch.cold_scale is not None:
        cold = cold * ch.cold_scale[:d]
        g_hot = g_hot * ch.hot_scale
    acc = torch.cat([cold, cold.new_zeros(1)])
    acc.index_add_(0, ch.hot_cols, g_hot)
    return acc[:d]


def _chunk_value_grad(loss: PointwiseLoss, ch: CanonicalChunk,
                      w_pad: Tensor, offsets: Tensor
                      ) -> tuple[Tensor, Tensor]:
    z = _chunk_margins_of(ch, w_pad, offsets)
    l, dl = loss.loss_and_dz(z, ch.labels)
    return (torch.sum(_masked(ch.weights, l)),
            _chunk_rowterm_grad(ch, _masked(ch.weights, dl)))


def _chunk_value(loss: PointwiseLoss, ch: CanonicalChunk, w_pad: Tensor,
                 offsets: Tensor) -> Tensor:
    """The value half of :func:`_chunk_value_grad` alone (margins + loss):
    the line-search probe pass skips the gradient's kernels."""
    z = _chunk_margins_of(ch, w_pad, offsets)
    l, _ = loss.loss_and_dz(z, ch.labels)
    return torch.sum(_masked(ch.weights, l))


def _chunk_nbytes(ch: CanonicalChunk) -> int:
    """Payload bytes of one chunk: what one transfer moves."""
    return sum(t.numel() * t.element_size() for t in ch.tensors().values())


# --------------------------------------------------------------- placement


def _place(ch: CanonicalChunk, device: torch.device) -> CanonicalChunk:
    """A device copy of ``ch`` with its column layout (on a card)."""
    out = dataclasses.replace(ch, **{
        name: t.to(device) for name, t in ch.tensors().items()})
    return _with_layout(out)


def _with_layout(ch: CanonicalChunk) -> CanonicalChunk:
    if ch.cold_cols.device.type != "cuda":
        return ch
    return dataclasses.replace(ch, layout=ell_scatter.build_layout(
        ch.cold_cols, ch.num_features))


def pin_chunks(chunked: ChunkedHybrid, count: int,
               device: Optional[DeviceLike] = None
               ) -> tuple[CanonicalChunk, ...]:
    """Place the first ``count`` chunks on ``device`` permanently, each
    with its column layout built once: spare device memory traded for
    stream traffic. The caller owns the sizing decision."""
    dev = resolve_device(device)
    return tuple(_place(ch, dev) for ch in chunked.chunks[:max(0, count)])


def pin_host_memory(chunked: ChunkedHybrid) -> ChunkedHybrid:
    """The same chunks in page-locked host memory (copied once), so the
    stream's ``non_blocking`` copies run as DMA beside the compute.
    Needs CUDA. (A tensor already pinned is kept as it is.)"""
    return dataclasses.replace(chunked, chunks=tuple(
        dataclasses.replace(ch, **{name: t.pin_memory()
                                   for name, t in ch.tensors().items()})
        for ch in chunked.chunks))


class ChunkStream:
    """One device's feed of a chunked batch, pass after pass.

    ``chunks()`` yields ``(i, chunk)`` for every chunk of one pass in
    order: the ``pinned`` leading chunks as they are (already on the
    device), then the rest streamed. On the CPU the host chunks are read
    in place. On a
    card each streamed chunk is copied ``non_blocking`` on a copy stream
    into one of ``prefetch_depth`` device buffers, and the compute
    stream waits on the copy's event before the chunk is handed out (a
    gradient pass builds its column layout on the compute stream). A
    buffer is refilled only behind an event recorded on the compute
    stream after its last reader's work was enqueued, so at most
    ``prefetch_depth`` streamed chunks are on the device and none is
    overwritten while read.

    ``bytes_moved`` and ``chunks_moved`` count the streamed chunks' host
    payload (on the CPU: what was read in place), ``passes`` the passes
    of each kind that went through the stream.
    """

    def __init__(self, chunked: ChunkedHybrid,
                 device: Optional[DeviceLike] = None,
                 prefetch_depth: int = 2, pinned=()):
        if prefetch_depth < 1:
            # depth 0 would yield no streamed chunks at all: a zero
            # value/gradient, not a slower one.
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.chunked = chunked
        self.device = _concrete(resolve_device(device))
        self.prefetch_depth = prefetch_depth
        self.pinned = tuple(pinned)
        for ch in self.pinned:
            if ch.X_hot.device != self.device:
                raise ValueError(f"pinned chunks lie on {ch.X_hot.device}, "
                                 f"the stream runs on {self.device}")
        self.bytes_moved = 0
        self.chunks_moved = 0
        self.passes = {"value_grad": 0, "value": 0, "margins": 0}
        self._buffers: Optional[list[dict[str, Tensor]]] = None
        # Per buffer, the compute-stream event behind its last reader;
        # kept across passes, so a new pass cannot overwrite a buffer the
        # previous one still reads.
        self._released: list = [None] * prefetch_depth
        self._copy_stream = None
        # Device-timed copies and passes whose events may still be
        # pending (see flush_timings).
        self._timed_copies: collections.deque = collections.deque()
        self._timed_passes: collections.deque = collections.deque()

    def chunks(self, pass_span=None):
        """Yield ``(i, chunk)`` for one pass. ``pass_span`` is the pass's
        open span (None when tracing is off): on a card it receives the
        pass's device seconds once they can be read."""
        mx, tr = obs.metrics(), obs.tracer()
        if mx is not None or tr is not None:
            self.flush_timings()
        yield from enumerate(self.pinned)
        todo = range(len(self.pinned), self.chunked.num_chunks)
        if self.device.type == "cpu":
            for i in todo:
                ch = self.chunked.chunks[i]
                if mx is None and tr is None:
                    self._count(ch)
                    yield i, ch
                    continue
                self._accounted_read(ch, i, mx, tr)
                try:
                    yield i, ch
                finally:
                    if mx is not None:
                        mx.gauge("photon_stream_inflight_chunks").dec()
            return
        yield from self._stream_cuda(todo, mx, tr, pass_span)

    def _count(self, ch: CanonicalChunk) -> None:
        self.bytes_moved += _chunk_nbytes(ch)
        self.chunks_moved += 1

    def _accounted_read(self, ch: CanonicalChunk, i: int, mx, tr) -> None:
        """The CPU's in-place read of one chunk, traced and metered: the
        counterpart of the reference's accounted ``device_put``."""
        nbytes, dtype = _chunk_nbytes(ch), chunk_dtype(ch)
        t0 = time.perf_counter()
        if tr is not None:
            with tr.span("stream.chunk_transfer", cat="transfer", index=i,
                         bytes=nbytes, dtype=dtype):
                self._count(ch)
        else:
            self._count(ch)
        if mx is not None:
            _count_transfer(mx, nbytes, dtype)
            mx.counter("photon_transfer_seconds_total", kind="stream",
                       dtype=dtype).inc(time.perf_counter() - t0)

    def flush_timings(self) -> None:
        """Record every device-timed copy and pass whose CUDA events have
        completed, oldest first; stop at the first pending one. It never
        waits: an event still pending stays for the next call (each pass
        calls this first, after its caller has read the previous pass's
        value)."""
        while self._timed_copies and self._timed_copies[0][-1].query():
            mx, span, dtype, start, end = self._timed_copies.popleft()
            seconds = start.elapsed_time(end) / 1e3
            if mx is not None:
                mx.counter("photon_transfer_seconds_total", kind="stream",
                           dtype=dtype).inc(seconds)
            if span is not None:
                span.set(device_seconds=seconds)
        while self._timed_passes and self._timed_passes[0][-1].query():
            span, start, end = self._timed_passes.popleft()
            span.set(device_seconds=start.elapsed_time(end) / 1e3)

    def _stream_cuda(self, todo, mx=None, tr=None, pass_span=None):
        depth = self.prefetch_depth
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
            proto = self.chunked.chunks[-1].tensors()
            self._buffers = [
                {name: torch.empty_like(t, device=self.device)
                 for name, t in proto.items()} for _ in range(depth)]
        copy = self._copy_stream
        released = self._released
        pending: collections.deque = collections.deque()
        order = iter(todo)
        timed = mx is not None or tr is not None
        pass_start = None
        if pass_span is not None:
            pass_start = torch.cuda.Event(enable_timing=True)
            pass_start.record(compute)

        def issue(k: int, i: int):
            b = k % depth
            host = self.chunked.chunks[i]
            nbytes, dtype = _chunk_nbytes(host), chunk_dtype(host)
            span = (tr.span("stream.chunk_transfer", cat="transfer",
                            index=i, bytes=nbytes, dtype=dtype)
                    if tr is not None else contextlib.nullcontext())
            with span, torch.cuda.stream(copy):
                if released[b] is not None:
                    copy.wait_event(released[b])
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(copy)
                buf = self._buffers[b]
                for name, t in host.tensors().items():
                    buf[name].copy_(t, non_blocking=True)
                ready = torch.cuda.Event(enable_timing=timed)
                ready.record(copy)
            self._count(host)
            if timed:
                self._timed_copies.append(
                    (mx, span if tr is not None else None, dtype, start,
                     ready))
                if mx is not None:
                    _count_transfer(mx, nbytes, dtype)
            pending.append((i, b, ready))

        k = 0
        for i in order:
            issue(k, i)
            k += 1
            if k == depth:
                break
        while pending:
            i, b, ready = pending.popleft()
            compute.wait_event(ready)
            ch = dataclasses.replace(self.chunked.chunks[i],
                                     **self._buffers[b])
            yield i, ch
            # The consumer has enqueued its reads of buffer b.
            released[b] = torch.cuda.Event()
            released[b].record(compute)
            del ch
            if mx is not None:
                mx.gauge("photon_stream_inflight_chunks").dec()
            nxt = next(order, None)
            if nxt is not None:
                issue(k, nxt)
                k += 1
        if pass_start is not None:
            pass_end = torch.cuda.Event(enable_timing=True)
            pass_end.record(compute)
            self._timed_passes.append((pass_span, pass_start, pass_end))


def _count_transfer(mx, nbytes: int, dtype: str) -> None:
    """One streamed chunk's bytes, its count and the in-flight gauge (the
    seconds come from the caller: host time on the CPU, device time on a
    card)."""
    mx.counter("photon_transfer_bytes_total", kind="stream",
               dtype=dtype).inc(nbytes)
    mx.counter("photon_transfer_chunks_total", kind="stream",
               dtype=dtype).inc()
    mx.gauge("photon_stream_inflight_chunks").inc()


def _concrete(device: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:N``, so device checks compare
    like with like."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _offsets_for(chunked: ChunkedHybrid, offsets: Optional[Tensor], i: int,
                 ch: CanonicalChunk) -> Tensor:
    if offsets is None:
        return ch.offsets
    lo = i * chunked.chunk_rows
    return offsets[lo:lo + chunked.chunk_rows]


def _padded(w: Tensor) -> Tensor:
    return torch.cat([w.to(torch.float32), w.new_zeros(1, dtype=torch.float32)])


def make_value_and_gradient(
    loss: PointwiseLoss,
    chunked: ChunkedHybrid,
    prefetch_depth: int = 2,
    pinned=(),
    *,
    device: Optional[DeviceLike] = None,
    stream: Optional[ChunkStream] = None,
) -> Callable[[Tensor, Optional[Tensor]], tuple[Tensor, Tensor]]:
    """Streamed Σ-over-chunks (value, gradient) in original column space.

    The returned callable is host-driven (a Python loop over the chunks);
    pair it with ``optim/streaming.minimize_streaming``. ``offsets``,
    when given, is the full (padded_n,) array of per-row offsets on the
    stream's device (coordinate-descent residuals); None uses the offsets
    staged in each chunk. ``stream`` shares one :class:`ChunkStream` (its
    device buffers and counters) between several passes; without it one
    is made from ``device``, ``prefetch_depth`` and ``pinned``."""
    st = stream or ChunkStream(chunked, device, prefetch_depth, pinned)

    def value_and_grad(w: Tensor, offsets: Optional[Tensor] = None):
        with obs.span("stream.pass", cat="stream", kind="value_grad",
                      chunks=chunked.num_chunks) as sp:
            w_pad = _padded(w)
            value = torch.zeros((), dtype=torch.float32, device=st.device)
            grad = torch.zeros(chunked.dim, dtype=torch.float32,
                               device=st.device)
            for i, ch in st.chunks(sp):
                v, g = _chunk_value_grad(
                    loss, ch, w_pad, _offsets_for(chunked, offsets, i, ch))
                value = value + v
                grad = grad + g
        st.passes["value_grad"] += 1
        return value, grad

    return value_and_grad


def make_value_only(
    loss: PointwiseLoss,
    chunked: ChunkedHybrid,
    prefetch_depth: int = 2,
    pinned=(),
    *,
    device: Optional[DeviceLike] = None,
    stream: Optional[ChunkStream] = None,
) -> Callable[[Tensor, Optional[Tensor]], Tensor]:
    """Streamed Σ-over-chunks VALUE: the line-search probe companion of
    :func:`make_value_and_gradient` (same stream discipline)."""
    st = stream or ChunkStream(chunked, device, prefetch_depth, pinned)

    def value_only(w: Tensor, offsets: Optional[Tensor] = None):
        with obs.span("stream.pass", cat="stream", kind="value_only",
                      chunks=chunked.num_chunks) as sp:
            w_pad = _padded(w)
            value = torch.zeros((), dtype=torch.float32, device=st.device)
            for i, ch in st.chunks(sp):
                value = value + _chunk_value(
                    loss, ch, w_pad, _offsets_for(chunked, offsets, i, ch))
        st.passes["value"] += 1
        return value

    return value_only


def margins_chunked(
    chunked: ChunkedHybrid,
    w: Tensor,
    offsets: Optional[Tensor] = None,
    prefetch_depth: int = 2,
    pinned=(),
    *,
    device: Optional[DeviceLike] = None,
    stream: Optional[ChunkStream] = None,
) -> Tensor:
    """(num_rows,) margins (wᵀx + offset), streamed; pad rows dropped."""
    st = stream or ChunkStream(chunked, device, prefetch_depth, pinned)
    with obs.span("stream.pass", cat="stream", kind="margins",
                  chunks=chunked.num_chunks) as sp:
        w_pad = _padded(w)
        parts = [_chunk_margins_of(ch, w_pad,
                                   _offsets_for(chunked, offsets, i, ch))
                 for i, ch in st.chunks(sp)]
    st.passes["margins"] += 1
    return torch.cat(parts)[:chunked.num_rows]


# ----------------------------------------------------------- chunk store
#
# One npz per chunk written atomically, a CRC32-carrying ``.ok`` commit
# marker per chunk written after it, and a ``meta.json`` completion record
# written LAST: the reference's layout, so a store written by either
# package loads in the other. The payload round-trips bit-stable (the int8
# codes and their scales are exact bytes). A chunk whose bytes fail the
# committed CRC re-stages through the caller's ``rebuild`` hook — exactly
# that chunk. bfloat16 fields are stored as their 16 bits in 2-byte void
# fields, the form numpy gives the reference's ml_dtypes arrays.

CHUNK_STORE_VERSION = 1


class ChunkStoreError(RuntimeError):
    """A persisted chunk stream that cannot be served and cannot be
    rebuilt (no ``rebuild`` hook was provided)."""


def save_chunked(directory: str, chunked: ChunkedHybrid) -> None:
    """Persist a staged ``ChunkedHybrid`` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    for i, ch in enumerate(chunked.chunks):
        path = os.path.join(directory, f"chunk_{i}.npz")
        arrays = {name: _stored(t) for name, t in ch.tensors().items()}
        atomic_write(path, lambda f, _a=arrays: np.savez(f, **_a))
        marker = json.dumps({
            "version": CHUNK_STORE_VERSION, "crc": file_crc32(path),
            "fields": sorted(arrays),
            "num_features": int(ch.num_features)}).encode()
        atomic_write(os.path.join(directory, f"chunk_{i}.ok"),
                     lambda f, _m=marker: f.write(_m))
    meta = json.dumps({
        "version": CHUNK_STORE_VERSION, "num_rows": int(chunked.num_rows),
        "chunk_rows": int(chunked.chunk_rows),
        "num_chunks": int(chunked.num_chunks),
        "dtype": chunk_dtype(chunked.chunks[0])}).encode()
    atomic_write(os.path.join(directory, "meta.json"),
                 lambda f: f.write(meta))


def _stored(t: Tensor) -> np.ndarray:
    """A chunk field as saved: bfloat16 as its bits in 2-byte void."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_stored(a: Optional[np.ndarray]) -> Optional[Tensor]:
    """A saved field as a tensor: 2-byte void is bfloat16's bits."""
    if a is not None and a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return _tensor(a.view(np.int16)).view(torch.bfloat16)
    return _tensor(a)


def _load_stored_chunk(directory: str, i: int) -> Optional[CanonicalChunk]:
    """One committed chunk, or None on any miss (no marker, version
    skew, CRC mismatch, unreadable npz): the caller re-stages it."""
    path = os.path.join(directory, f"chunk_{i}.npz")
    try:
        with open(os.path.join(directory, f"chunk_{i}.ok")) as f:
            marker = json.load(f)
        if marker.get("version") != CHUNK_STORE_VERSION:
            return None
        got = file_crc32(path)
        if got != int(marker["crc"]):
            logger.warning(
                "chunk store entry %s is corrupt (crc %08x != committed "
                "%08x) — re-staging exactly this chunk", path, got,
                int(marker["crc"]))
            return None
        with np.load(path, allow_pickle=False) as z:
            arrays = {name: z[name] for name in marker["fields"]}
        return CanonicalChunk(
            num_features=int(marker["num_features"]),
            **{name: _from_stored(arrays.get(name))
               for name in _CHUNK_FIELDS})
    except Exception:
        logger.debug("chunk store miss for chunk %d under %s",
                     i, directory, exc_info=True)
        return None


def load_chunked(directory: str, rebuild=None) -> ChunkedHybrid:
    """Load a persisted chunk stream; a chunk that fails its CRC (or is
    missing) re-stages through ``rebuild(i) -> CanonicalChunk``, or
    raises :class:`ChunkStoreError` when no hook was given."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != CHUNK_STORE_VERSION:
        raise ChunkStoreError(
            f"chunk store {directory} is version {meta.get('version')}, "
            f"expected {CHUNK_STORE_VERSION}")
    chunks = []
    for i in range(int(meta["num_chunks"])):
        ch = _load_stored_chunk(directory, i)
        if ch is None:
            if rebuild is None:
                raise ChunkStoreError(
                    f"chunk {i} of {directory} is missing or corrupt and "
                    f"no rebuild hook was provided")
            ch = rebuild(i)
        chunks.append(ch)
    return ChunkedHybrid(chunks=tuple(chunks),
                         num_rows=int(meta["num_rows"]),
                         chunk_rows=int(meta["chunk_rows"]))
