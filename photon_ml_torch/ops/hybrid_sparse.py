"""Hybrid hot-dense / cold-class sparse GLM aggregates (the Criteo path).

Port of ``photon_ml_tpu/ops/hybrid_sparse.py`` on one device. Reference
parity: the same ``ValueAndGradientAggregator`` /
``HessianVectorAggregator`` contracts as ``ops/sparse_aggregators.py``,
over a layout that splits the Zipf-distributed feature space in two:

- **hot columns** (count ≥ ``hot_threshold``, at most ``max_hot``) form a
  dense (n, k) block: margins and gradient are a matrix-vector product
  and its transpose;
- **cold columns** are relabeled into count-descending order (a static
  permutation of the feature space; the GLM objective is permutation-
  equivariant, so the solve runs in permuted space and maps back once per
  fit) and stored column-contiguous in power-of-two count classes,
  padded (C, L) blocks of row ids (padding ``n``) and values (padding 0).

Staging (:func:`build_hybrid`) is the reference's host numpy, call for
call, so ``perm``, ``inv_perm``, ``num_hot``, ``class_starts``, every
class's arrays and the hot block equal the reference's bit for bit. The
(n, k) hot block is never built on the host (at 4.75M rows the float32
block is 34 GB): its entries are scattered straight into a zero tensor
of the storage dtype on the target device.

**bfloat16 storage** (``feature_dtype=torch.bfloat16``, the reference's
flagship dtype) stores the hot block in bfloat16, rounded once (to
nearest even), with the reference's n/4096 threshold; the cold values
stay float32, as in the reference. The routes round what the
reference's ``_hot_matvec`` / ``_hot_rmatvec`` round and nothing else:
the hot coefficients (w, and v for H·v) before the margins, and the
residual r inside ``hot_pass`` before the transposed product; every
product then accumulates in float32. The Hessian diagonal squares the
block in float32, row block by row block, with r unrounded.

Where the reference leaves the work to XLA, the port runs its kernels on
a card, and their plain versions on CPU tensors:

- the hot block, float32, read once an evaluation: value and gradient
  through ``hot_pass.hot_value_and_gradient`` (the margins, the residual
  and the transposed product in one pass), H·v through
  ``hot_pass.hot_hessian_vector``, and the margins alone (the descent's
  scoring) through ``stream_fused.hot_margins`` (``base`` = the offsets).
  The cold margins are computed first and enter the pass. The block is
  stored with its columns padded by zero columns to a multiple of 16
  bytes (:func:`hot_align` columns; ``w`` padded with zeros), so every
  row starts on 16 bytes and the kernels take their vector loads and
  bulk copies;
- the cold margins' scatter ``zeros(n+1).at[rowids].add(products)``
  through ``ell_scatter`` over a column layout of the flat cold row ids
  with dim = n, built once per staged batch (padding id n ≥ dim adds
  nothing). ``index_add_`` would add with float atomics, so two passes
  would differ in their last bits;
- the cold gradient, the H·v row term and the Hessian diagonal's cold
  term through ``cold_grad.cold_grad_classes``, one launch a pass over
  every class: the gather ``r[rowids]`` and the padded row sums in one
  pass, over the flat row ids and values, written straight into one
  (num_cold_present,) tensor.

The Hessian diagonal's hot term ``r @ X_hot²`` is summed by
``stream_fused.hot_rmatvec`` over row blocks of at most
``DIAG_BLOCK_ROWS`` rows in block order, so no (n, k) squared temporary
exists.

Not ported: ``HybridShards``, ``build_hybrid_shards`` and ``local_shard``
(the data-sharded composition; slice 9, reached only through a mesh,
which the port does not have yet).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from photon_ml_torch.data.batch import check_feature_dtype
from photon_ml_torch.data.sparse import SparseBatch
from photon_ml_torch.ops.kernels import (cold_grad, ell_scatter, hot_pass,
                                         stream_fused)
from photon_ml_torch.ops.kernels.ell_scatter import ColumnLayout
from photon_ml_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

# The hot block's rows are a multiple of 16 bytes long: HOT_ALIGN float32
# columns (hot_align(torch.bfloat16) bfloat16 ones), the zero columns past
# num_hot inert in every product.
HOT_ALIGN_BYTES = 16
HOT_ALIGN = HOT_ALIGN_BYTES // 4
# Rows per block of the Hessian diagonal's hot term.
DIAG_BLOCK_ROWS = 262_144


@dataclasses.dataclass(frozen=True)
class HybridSparseBatch:
    """Hot-dense + cold-class layout of one sparse example batch.

    The feature space is PERMUTED: new column order is
    [hot columns (count desc) | cold present columns (count desc) |
    absent columns]. ``perm`` maps new → original column ids;
    ``inv_perm`` maps original → new. Coefficient vectors seen by the
    ops here live in the permuted space.

    ``X_hot`` holds ``num_hot`` columns and zero columns up to a multiple
    of :func:`hot_align` of its dtype. ``cold_flat_rowids`` and
    ``cold_flat_vals`` are every class's row ids and values in class
    order, flat, where ``cold_table`` says each class lies;
    ``cold_rowids`` and ``cold_vals`` are each class's (C, L) views into
    them, so the cold tier is held once.
    ``cold_layout`` is the flat row ids' column layout over dim = n, which
    the ``ell_scatter`` kernel reads; :meth:`to` builds it on a CUDA
    device. ``dataclasses.replace`` of the labels, weights or offsets
    keeps all of them.
    """

    X_hot: Tensor  # (n, k_pad) float32 or bfloat16
    labels: Tensor  # (n,)
    weights: Tensor  # (n,)
    offsets: Tensor  # (n,)
    perm: Tensor  # (d,) int32: new col -> original col
    inv_perm: Tensor  # (d,) int32: original col -> new col
    num_features: int
    num_hot: int
    # Per class: first permuted column id (hot block excluded).
    class_starts: tuple[int, ...]
    cold_flat_rowids: Tensor  # (T,) int32
    cold_flat_vals: Tensor  # (T,) float32
    cold_table: cold_grad.ClassTable
    cold_layout: Optional[ColumnLayout] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_rows(self) -> int:
        return int(self.labels.shape[0])

    @property
    def dim(self) -> int:
        return self.num_features

    @property
    def num_cold_present(self) -> int:
        return self.cold_table.num_columns

    @functools.cached_property
    def cold_rowids(self) -> tuple[Tensor, ...]:
        """Per class: (C, L) int32 row ids, pad == n (views)."""
        return cold_grad.class_views(self.cold_flat_rowids, self.cold_table)

    @functools.cached_property
    def cold_vals(self) -> tuple[Tensor, ...]:
        """Per class: (C, L) float32 values, pad == 0 (views)."""
        return cold_grad.class_views(self.cold_flat_vals, self.cold_table)

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def to(self, device) -> "HybridSparseBatch":
        """This batch on ``device``, contiguous; on a CUDA device the cold
        scatter's column layout is built here, once."""
        device = torch.device(device)
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self) if f.name != "cold_layout"}
        for name, value in fields.items():
            if isinstance(value, Tensor):
                fields[name] = value.to(device).contiguous()
        layout = self.cold_layout
        if layout is None or layout.device != device:
            layout = _cold_layout(fields["cold_flat_rowids"],
                                  self.num_rows, device)
        return HybridSparseBatch(**fields, cold_layout=layout)


def _cold_layout(flat_rowids: Tensor, n: int,
                 device: torch.device) -> Optional[ColumnLayout]:
    if device.type != "cuda":
        return None
    return ell_scatter.build_layout(flat_rowids.view(-1, 1), n)


def hot_align(dtype: torch.dtype) -> int:
    """Columns of ``dtype`` in 16 bytes: the hot block's width is a
    multiple of this."""
    return HOT_ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()


def _default_hot_threshold(n: int, feature_dtype=torch.float32) -> int:
    """The reference's dtype-aware hot/cold split point: max(8, n/2048)
    for a float32 block, max(8, n/4096) for a bfloat16 one (half the
    bytes a column, so more columns are worth densifying)."""
    bf16 = check_feature_dtype(feature_dtype) == torch.bfloat16
    return max(8, n // (4096 if bf16 else 2048))


def build_hybrid(batch: SparseBatch, hot_threshold: Optional[int] = None,
                 max_hot: int = 4096, feature_dtype=torch.float32,
                 device=None) -> HybridSparseBatch:
    """Stage an ELL SparseBatch into the hybrid layout on ``device`` (the
    batch's own by default), once.

    ``hot_threshold``: columns with at least this many nonzeros densify
    (default :func:`_default_hot_threshold` of ``feature_dtype``).
    ``max_hot`` caps the dense block's width. ``feature_dtype``
    (float32 or bfloat16, a torch dtype or its name) is the hot block's
    storage. The permutation and the cold classes are the reference's
    host numpy; the hot entries are scattered into the block on
    ``device``.
    """
    feature_dtype = check_feature_dtype(feature_dtype) or torch.float32
    device = torch.device(device) if device is not None else batch.device
    indices = batch.indices.cpu().numpy()
    values = batch.values.cpu().numpy()
    n, slots = indices.shape
    d = int(batch.num_features)
    if hot_threshold is None:
        hot_threshold = _default_hot_threshold(n, feature_dtype)

    flat_col = indices.reshape(-1)
    flat_row = np.repeat(np.arange(n, dtype=np.int32), slots)
    flat_val = values.reshape(-1)
    live = (flat_col < d) & (flat_val != 0.0)
    counts = np.bincount(flat_col[live], minlength=d)

    # Permuted order: count-descending (stable → ties break on column id).
    order_desc = np.argsort(-counts, kind="stable").astype(np.int32)
    k = int(min(max_hot, (counts >= hot_threshold).sum()))

    inv_perm = np.empty(d, np.int32)
    inv_perm[order_desc] = np.arange(d, dtype=np.int32)

    new_col = inv_perm[np.minimum(flat_col, d - 1)]
    hot_sel = live & (new_col < k)
    X_hot = _fill_hot(hot_sel.reshape(n, slots), new_col.reshape(n, slots),
                      values, k, device, feature_dtype)
    del hot_sel

    # Cold entries, column-contiguous in permuted order.
    cold_sel = live & (new_col >= k)
    c_new = new_col[cold_sel] - k
    c_row = flat_row[cold_sel]
    c_val = flat_val[cold_sel]
    del flat_row, live, new_col, cold_sel
    order = np.argsort(c_new, kind="stable")
    c_new, c_row, c_val = c_new[order], c_row[order], c_val[order]
    cold_counts = counts[order_desc][k:]  # descending
    present = int((cold_counts > 0).sum())
    col_start = np.concatenate(
        [[0], np.cumsum(cold_counts[:present])[:-1]]).astype(np.int64)

    # Power-of-two count classes over the present cold columns; counts are
    # descending, so each class is one contiguous slice of columns, and
    # descending class order is the permuted column layout. Each class is
    # filled in place in the flat arrays, class after class.
    shapes: list[tuple[int, int]] = []
    sels: list[np.ndarray] = []
    if present:
        cls = np.ceil(np.log2(np.maximum(
            cold_counts[:present], 1))).astype(np.int64)
        for kk in np.unique(cls)[::-1]:
            sel = np.flatnonzero(cls == kk)
            shapes.append((sel.size, 1 << int(kk)))
            sels.append(sel)
    table = cold_grad.class_table(shapes)
    flat_rows = np.full(table.num_slots, n, np.int32)
    flat_vals = np.zeros(table.num_slots, np.float32)
    for sel, (C, L), off in zip(sels, shapes, table.offsets):
        rp = flat_rows[off:off + C * L].reshape(C, L)
        vp = flat_vals[off:off + C * L].reshape(C, L)
        # Vectorized fill: position of each entry within its column.
        starts = col_start[sel]
        cnts = cold_counts[sel].astype(np.int64)
        total = int(cnts.sum())
        colpos = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(cnts)[:-1]]), cnts)
        src = np.repeat(starts, cnts) + colpos
        crow = np.repeat(np.arange(C, dtype=np.int64), cnts)
        rp[crow, colpos] = c_row[src]
        vp[crow, colpos] = c_val[src]

    def put(a, dtype=None):
        t = torch.as_tensor(a)
        return t.to(device=device, dtype=dtype or t.dtype).contiguous()

    rows_t, vals_t = put(flat_rows), put(flat_vals)
    return HybridSparseBatch(
        X_hot=X_hot,
        labels=put(batch.labels, torch.float32),
        weights=put(batch.weights, torch.float32),
        offsets=put(batch.offsets, torch.float32),
        perm=put(order_desc),
        inv_perm=put(inv_perm),
        num_features=d,
        num_hot=k,
        class_starts=tuple(int(sel[0]) for sel in sels),
        cold_flat_rowids=rows_t,
        cold_flat_vals=vals_t,
        cold_table=table,
        cold_layout=_cold_layout(rows_t, n, device))


def _fill_hot(hot: np.ndarray, new_col: np.ndarray, values: np.ndarray,
              k: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> Tensor:
    """The (n, k_pad) hot block of ``dtype`` on ``device``: zeros, then the
    hot entries ``hot`` (n, slots) at (row, ``new_col``), one slot at a
    time, each value rounded to ``dtype`` once (to nearest even). Within a
    slot every row appears once, so each copy is deterministic, and a
    later slot overwrites an earlier one, as the reference's single numpy
    assignment does where a row repeats a column; a bfloat16 block so
    holds the bits of the reference's float32 block cast to bfloat16,
    without a float32 block of its own."""
    n, slots = hot.shape
    align = hot_align(dtype)
    k_pad = -(-k // align) * align
    X = torch.zeros((n, k_pad), dtype=dtype, device=device)
    if not k:
        return X
    flat = X.view(-1)
    # The slot arrays go to the device once; each slot's rows, positions
    # and values are picked there.
    hot_t = torch.from_numpy(hot).to(device)
    col_t = torch.from_numpy(new_col).to(device)
    val_t = torch.from_numpy(values).to(device)
    for s in range(slots):
        rows = torch.nonzero(hot_t[:, s]).squeeze(1)
        if rows.numel() == 0:
            continue
        pos = rows * k_pad + col_t[rows, s].to(torch.int64)
        flat.index_copy_(0, pos, val_t[rows, s].to(dtype))
    return X


def to_permuted_space(hb: HybridSparseBatch, w: Tensor) -> Tensor:
    """Original-space (d,) vector → permuted space (once per fit)."""
    return torch.index_select(w, 0, hb.perm)


def to_original_space(hb: HybridSparseBatch, w_perm: Tensor) -> Tensor:
    """Permuted-space (d,) vector → original space (once per fit)."""
    return torch.index_select(w_perm, 0, hb.inv_perm)


def _hot_weights(hb: HybridSparseBatch, w_perm: Tensor) -> Tensor:
    """The hot block's (k_pad,) float32 coefficients: w_perm's first
    num_hot, then zeros for the padding columns; rounded to bfloat16
    over a bfloat16 block, as the reference's ``_hot_matvec`` rounds
    them."""
    pad = hb.X_hot.shape[1] - hb.num_hot
    return stream_fused.rounded_like(
        hb.X_hot, torch.cat([w_perm[:hb.num_hot], w_perm.new_zeros(pad)]))


def _cold_products(hb: HybridSparseBatch, w_perm: Tensor,
                   cold_vals: tuple[Tensor, ...]) -> Tensor:
    """Flat per-entry w[col]·value products over all classes.

    Column coefficients arrive by contiguous SLICE broadcast (no gather):
    each class's columns are one run of the permuted space.
    """
    parts = []
    for start, rows, vals in zip(hb.class_starts, hb.cold_rowids,
                                 cold_vals):
        C = rows.shape[0]
        w_c = w_perm[hb.num_hot + start: hb.num_hot + start + C]
        parts.append((w_c[:, None] * vals).reshape(-1))
    return torch.cat(parts)


def _cold_margins(hb: HybridSparseBatch,
                  w_perm: Tensor) -> Optional[Tensor]:
    """(n,) cold part of wᵀx: contiguous-slice broadcast products, then
    one scatter by row; None without cold classes."""
    if not hb.cold_rowids:
        return None
    prods = _cold_products(hb, w_perm, hb.cold_vals)
    return ell_scatter.scatter_rowterm(
        hb.cold_flat_rowids.view(-1, 1), prods.view(-1, 1), hb.num_rows,
        layout=hb.cold_layout)


def _plus(z: Tensor, cold: Optional[Tensor]) -> Tensor:
    return z if cold is None else z + cold


def margins(hb: HybridSparseBatch, w_perm: Tensor) -> Tensor:
    """(n,) wᵀx + offset. Hot: one matrix-vector product onto the
    offsets. Cold: :func:`_cold_margins`, added last."""
    z = hb.offsets
    if hb.num_hot:
        z = stream_fused.hot_margins(hb.X_hot, _hot_weights(hb, w_perm),
                                     hb.offsets)
    return _plus(z, _cold_margins(hb, w_perm))


def _masked(weights: Tensor, term: Tensor) -> Tensor:
    return torch.where(weights > 0.0, weights * term,
                       torch.zeros_like(term))


def _cold_grad(hb: HybridSparseBatch, r: Tensor,
               flat_vals: Tensor) -> Optional[Tensor]:
    """The (num_cold_present,) cold gradient over every class, class
    after class: the gather r[rowids] and the padded row sums in one
    ``cold_grad_classes`` call over the flat row ids and ``flat_vals``;
    None without cold classes."""
    if not hb.cold_table.shapes:
        return None
    return cold_grad.cold_grad_classes(r, hb.cold_flat_rowids, flat_vals,
                                       hb.cold_table)


def _assemble_grad(hb: HybridSparseBatch, g_hot: Optional[Tensor],
                   g_cold: Optional[Tensor]) -> Tensor:
    """(d,) permuted gradient from the (k_pad,) hot part and the cold
    classes' sums; absent (zero-count) columns sit at the permuted tail,
    0."""
    parts = []
    if hb.num_hot:
        parts.append(g_hot[:hb.num_hot])
    if g_cold is not None:
        parts.append(g_cold)
    d = hb.num_features
    if not parts:
        return torch.zeros(d, dtype=torch.float32, device=hb.device)
    dense = torch.cat(parts)
    if dense.shape[0] == d:
        return dense
    return torch.cat([dense, dense.new_zeros(d - dense.shape[0])])


def value_and_gradient(loss: PointwiseLoss, w_perm: Tensor,
                       hb: HybridSparseBatch) -> tuple[Tensor, Tensor]:
    """(Σ w·l, Σ w·dl·x) in permuted space — the fused hot/cold pass: the
    cold margins, then one pass over the hot block for z and its
    gradient, then the value and the cold gradient from z."""
    cold_z = _cold_margins(hb, w_perm)
    g_hot = None
    if hb.num_hot:
        z, g_hot = hot_pass.hot_value_and_gradient(
            hb.X_hot, _hot_weights(hb, w_perm), hb.offsets, cold_z,
            hb.labels, hb.weights, loss)
    else:
        z = _plus(hb.offsets, cold_z)
    l, dl = loss.loss_and_dz(z, hb.labels)
    value = torch.sum(_masked(hb.weights, l), dim=-1)
    r = _masked(hb.weights, dl)
    return value, _assemble_grad(hb, g_hot,
                                 _cold_grad(hb, r, hb.cold_flat_vals))


def hessian_vector(loss: PointwiseLoss, w_perm: Tensor, v_perm: Tensor,
                   hb: HybridSparseBatch) -> Tensor:
    """Σ w·d2l·(x·v)·x in permuted space (TRON's H·v): one pass over the
    hot block for z, x·v and the hot part."""
    cold_z, cold_zv = _cold_margins(hb, w_perm), _cold_margins(hb, v_perm)
    g_hot = None
    if hb.num_hot:
        z, xv, g_hot = hot_pass.hot_hessian_vector(
            hb.X_hot, _hot_weights(hb, w_perm), _hot_weights(hb, v_perm),
            hb.offsets, cold_z, cold_zv, hb.labels, hb.weights, loss)
    else:
        z = _plus(hb.offsets, cold_z)
        xv = _plus(hb.offsets, cold_zv) - hb.offsets
    d2 = loss.d2z(z, hb.labels)
    r = _masked(hb.weights, d2) * xv
    return _assemble_grad(hb, g_hot, _cold_grad(hb, r, hb.cold_flat_vals))


def hessian_diagonal(loss: PointwiseLoss, w_perm: Tensor,
                     hb: HybridSparseBatch,
                     block_rows: int = DIAG_BLOCK_ROWS) -> Tensor:
    """diag(H) = Σ w·d2l·x² in permuted space (SIMPLE variances). The hot
    term ``r @ X_hot²`` is summed over blocks of ``block_rows`` rows, in
    block order, each block squared in float32 (a bfloat16 square would
    round twice) and r unrounded, as in the reference."""
    z = margins(hb, w_perm)
    d2 = loss.d2z(z, hb.labels)
    r = _masked(hb.weights, d2)
    g_hot = None
    if hb.num_hot:
        g_hot = torch.zeros(hb.X_hot.shape[1], dtype=torch.float32,
                            device=hb.device)
        for i0 in range(0, hb.num_rows, block_rows):
            block = hb.X_hot[i0:i0 + block_rows].to(torch.float32)
            g_hot = g_hot + stream_fused.hot_rmatvec(
                block * block, r[i0:i0 + block_rows])
    return _assemble_grad(
        hb, g_hot, _cold_grad(hb, r, hb.cold_flat_vals * hb.cold_flat_vals))
