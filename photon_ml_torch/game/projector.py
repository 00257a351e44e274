"""Per-entity feature-subspace projection for random effects.

Port of ``photon_ml_tpu/game/projector.py`` (host numpy; the same inputs
give the same bytes). Reference parity: photon-lib
``projector/LinearSubspaceProjector.scala`` (global feature space ↔ the
subspace of features actually present in one entity's data) and
photon-api ``projector/IndexMapProjectorRDD.scala`` (one projector per
entity: active data projected forward, trained models back).

Instead of one projector object per entity, a bucket of entities carries
ONE (E_b, d_active) int32 column-index matrix ``cols``:

    cols[e, j] = global column of entity e's j-th active feature (−1 pad)

Features are gathered straight into projected bucket layout on the host —
dense shards via ``X[example_idx[:, :, None], cols[:, None, :]]``, sparse
(ELL) shards via an O(nnz) scatter of their stored triplets — so the dense
(E_b, cap, d) block is never materialized; solves run at d_active ≪ d.
For sparse shards not even the (n, d) matrix ever exists: the ELL indices
ARE the per-entity active sets. Coefficients live in the full space (the
(E, d) table) or in the (E, A) subspace table, and are gathered and
scattered through ``cols`` on the device (projectForward /
projectBackward).

Everything here is vectorized numpy over nonzero triplets — one sort +
segment pass per bucket, no per-entity Python loops — so staging scales to
10⁶ entities.

Conventions:
- If the shard has an intercept column it is ALWAYS active and is placed at
  projected slot 0, giving a static intercept index for regularization
  masks and normalization shift-folding in the lane-batched solve.
- Padded slots (cols == −1) have features zeroed, normalization factor 1 and
  shift 0 (factor 1, not 0 — ``model_to_transformed_space`` divides by the
  factor), and warm starts zeroed, so their coefficients stay exactly 0 and
  contribute nothing to value/gradient; the backward scatter drops them.
- ``d_active`` is one power-of-two bucket-wide width (max over the bucket's
  entities) — entities in a bucket share one padded projected width, the
  shape-bucketing trick applied to the feature axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from photon_ml_torch.data.game_data import SparseShard
from photon_ml_torch.game.buckets import EntityBucket


@dataclasses.dataclass
class BucketProjection:
    """Per-entity active-column index map for one bucket."""

    cols: np.ndarray  # (E_b, d_active) int32 global column ids; -1 pad
    d_active: int

    @property
    def num_entities(self) -> int:
        return int(self.cols.shape[0])


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


def pearson_scores(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """|Pearson correlation| of each feature column with the labels.

    Reference parity: photon-api ``data/LocalDataset.scala``
    ``stableComputePearsonCorrelationScore`` — zero-variance columns (and a
    zero-variance label) score 0 rather than NaN, so constant features are
    filtered out unless they are the intercept (which the caller always
    keeps).
    """
    y = y.astype(np.float64)
    Xc = X.astype(np.float64) - X.mean(axis=0, dtype=np.float64)
    yc = y - y.mean()
    cov = Xc.T @ yc
    denom = np.sqrt((Xc * Xc).sum(axis=0) * (yc * yc).sum())
    out = np.zeros(X.shape[1], np.float64)
    np.divide(np.abs(cov), denom, out=out, where=denom > 1e-12)
    return out


def shard_coo(X) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, vals) nonzero triplets of a dense matrix or SparseShard.

    For sparse shards this reads straight off the ELL arrays in O(nnz) —
    no dense (n, d) scan ever happens; padding slots (index == d, value 0)
    and explicit zeros are dropped. Callers staging several buckets compute
    this once per shard and pass it down.
    """
    if isinstance(X, SparseShard):
        idx = np.asarray(X.indices)
        val = np.asarray(X.values)
        valid = (idx < X.num_features) & (val != 0.0)
        rows = np.broadcast_to(
            np.arange(idx.shape[0], dtype=np.int32)[:, None],
            idx.shape)[valid]
        return rows, idx[valid].astype(np.int32), val[valid]
    X = np.asarray(X)
    rows, cols = np.nonzero(X)
    # Values keep the shard's own dtype (f32 shards stay compact; f64
    # inputs keep full precision for the Pearson moments).
    return rows.astype(np.int32), cols.astype(np.int32), X[rows, cols]


def _shard_shape(X) -> tuple[int, int]:
    if isinstance(X, SparseShard):
        return X.shape
    return int(X.shape[0]), int(X.shape[1])


@dataclasses.dataclass
class BucketTriplets:
    """One bucket's slice of a shard's nonzero triplets plus the reverse
    example-row maps — computed once per bucket and shared by
    ``build_bucket_projection`` and ``gather_projected_features`` so the
    O(n_rows) map build and O(nnz) filtering run once, not twice.

    The parallel staging pipeline (game/staging.py) builds these for lane
    SLICES of a bucket: ``lanes`` are then local to the slice, the map
    arrays are None, and the per-triplet ``cappos`` carries what
    ``cappos_of[rows]`` would have gathered — the slice never needs the
    O(n_rows) global maps (which would have to be pickled per task in
    process mode)."""

    rows: np.ndarray  # filtered triplet rows (this bucket's kept examples)
    cols: np.ndarray  # int64 global columns
    vals: np.ndarray  # shard-dtype values
    lanes: np.ndarray  # int64 lane per triplet
    lane_of: Optional[np.ndarray] = None  # (n_rows,) int32 lane; -1 outside
    cappos_of: Optional[np.ndarray] = None  # (n_rows,) int32 slot within cap
    cappos: Optional[np.ndarray] = None  # per-triplet slot (replaces map)


def bucket_triplets(
    bucket: EntityBucket,
    X,
    coo: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> BucketTriplets:
    n_rows, _ = _shard_shape(X)
    if coo is None:
        coo = shard_coo(X)
    rows_nz, cols_nz, vals_nz = coo
    lane_of, cappos_of = _lane_maps(bucket, n_rows)
    sel = lane_of[rows_nz] >= 0
    r = rows_nz[sel]
    return BucketTriplets(
        lane_of=lane_of, cappos_of=cappos_of, rows=r,
        cols=cols_nz[sel].astype(np.int64), vals=vals_nz[sel],
        lanes=lane_of[r].astype(np.int64))


def all_bucket_triplets(
    buckets: list,
    X,
    coo: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> list[BucketTriplets]:
    """Per-bucket triplet slices for EVERY bucket in one pass.

    ``bucket_triplets`` rebuilds an O(n_rows) reverse map and re-gathers it
    over all O(nnz) triplets per bucket; since each example row belongs to
    at most one bucket, one global (bucket, lane, slot) map and ONE nnz
    gather serve every bucket — at 10M rows / 80M nnz / 4 buckets this is
    the difference between ~10 s and ~2 s of staging. The returned
    ``lane_of``/``cappos_of`` maps are the shared GLOBAL maps (lanes of
    other buckets included); per-bucket consumers only ever read them at
    their own bucket's rows, where the values agree with the per-bucket
    build."""
    n_rows, _ = _shard_shape(X)
    if coo is None:
        coo = shard_coo(X)
    rows_nz, cols_nz, vals_nz = coo
    bucket_of = np.full(n_rows, -1, np.int16)
    lane_of = np.full(n_rows, -1, np.int32)
    cappos_of = np.zeros(n_rows, np.int32)
    if len(buckets) >= 2 ** 15:
        raise ValueError(f"{len(buckets)} buckets overflow the int16 map")
    for bi, b in enumerate(buckets):
        ex = b.example_idx
        kept = ex >= 0
        rk = ex[kept]
        bucket_of[rk] = bi
        lane_of[rk] = np.broadcast_to(
            np.arange(ex.shape[0], dtype=np.int32)[:, None], ex.shape)[kept]
        cappos_of[rk] = np.broadcast_to(
            np.arange(ex.shape[1], dtype=np.int32)[None, :], ex.shape)[kept]
    tb = bucket_of[rows_nz]  # the one nnz-sized gather
    out = []
    for bi in range(len(buckets)):
        sel = tb == bi
        r = rows_nz[sel]
        out.append(BucketTriplets(
            lane_of=lane_of, cappos_of=cappos_of, rows=r,
            cols=cols_nz[sel].astype(np.int64), vals=vals_nz[sel],
            lanes=lane_of[r].astype(np.int64)))
    return out


def _lane_maps(bucket: EntityBucket, n_rows: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Reverse maps example row → (bucket lane, slot within cap); −1 lane
    for rows outside this bucket (other buckets / dropped by upper_bound)."""
    ex = bucket.example_idx
    kept = ex >= 0
    lane_of = np.full(n_rows, -1, np.int32)
    cappos_of = np.zeros(n_rows, np.int32)
    lane_of[ex[kept]] = np.broadcast_to(
        np.arange(ex.shape[0], dtype=np.int32)[:, None], ex.shape)[kept]
    cappos_of[ex[kept]] = np.broadcast_to(
        np.arange(ex.shape[1], dtype=np.int32)[None, :], ex.shape)[kept]
    return lane_of, cappos_of


def build_bucket_projection(
    bucket: EntityBucket,
    X,
    intercept_index: Optional[int],
    min_dim: int = 8,
    labels: Optional[np.ndarray] = None,
    features_to_samples_ratio: Optional[float] = None,
    coo: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    triplets: Optional[BucketTriplets] = None,
) -> BucketProjection:
    """Compute each entity's active feature subspace for one bucket.

    A column is active for an entity iff any of the entity's (kept) examples
    has a nonzero value there (reference LinearSubspaceProjector: the index
    set of features present in the entity's data). ``X`` may be a dense
    (n, d) matrix or a SparseShard; pass ``coo=shard_coo(X)`` to reuse the
    triplet extraction across buckets, and ``triplets`` to additionally
    share the per-bucket filtering with ``gather_projected_features``.

    ``features_to_samples_ratio`` additionally caps each entity's subspace
    at ``ceil(ratio · num_samples)`` columns, keeping the highest
    |Pearson corr(feature, label)| ones (reference
    ``LocalDataset.filterFeaturesByPearsonCorrelationScore`` driven by
    ``RandomEffectDataConfiguration.numFeaturesToSamplesRatio``). The
    intercept is always kept and counts toward the cap, matching the
    reference (it assigns the intercept the maximal score). Pearson moments
    come from the same nonzero triplets (zeros contribute only to counts),
    identical in exact arithmetic to ``pearson_scores`` on dense columns.

    One sort + segment-reduce pass over the bucket's nonzeros — no
    per-entity loops.
    """
    if features_to_samples_ratio is not None and labels is None:
        raise ValueError("features_to_samples_ratio needs labels")
    _, d = _shard_shape(X)
    ex = bucket.example_idx  # (E_b, cap), -1 pad
    E_b = ex.shape[0]
    if triplets is None:
        triplets = bucket_triplets(bucket, X, coo)
    live = np.flatnonzero(np.asarray(bucket.entity_rows) >= 0).astype(
        np.int64)
    t_y = None
    yb = None
    y0 = 0.0
    if features_to_samples_ratio is not None:
        y = np.asarray(labels, np.float64)
        t_y = y[triplets.rows]
        y0 = float(y[0]) if y.size else 0.0
        yb = y[np.maximum(ex, 0)]
        yb[ex < 0] = 0.0
    u_lane, u_col = active_pairs(
        E_b, d, intercept_index, live,
        triplets.cols, triplets.vals, triplets.lanes,
        ratio=features_to_samples_ratio, t_y=t_y, y0=y0, yb=yb,
        kept=ex >= 0)
    d_active = projection_width(
        active_lane_counts(u_lane, E_b), d, min_dim)
    cols = fill_cols(u_lane, u_col, E_b, d_active, intercept_index)
    return BucketProjection(cols=cols, d_active=int(d_active))


def active_pairs(
    E_b: int,
    d: int,
    intercept_index: Optional[int],
    live: np.ndarray,
    c: np.ndarray,
    v: np.ndarray,
    l: np.ndarray,
    ratio: Optional[float] = None,
    t_y: Optional[np.ndarray] = None,
    y0: float = 0.0,
    yb: Optional[np.ndarray] = None,
    kept: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Unique active (lane, col) pairs of one bucket — or of any lane
    SLICE of one bucket, which is what makes the staging pipeline's
    entity-axis sharding exact: every computation here is per-lane
    (sorted runs never span lanes), so pairs of a slice are exactly the
    full bucket's pairs restricted to the slice's lanes.

    ``c``/``v``/``l`` are the slice's nonzero triplets (lanes LOCAL to the
    slice); ``live`` the local lanes holding a real entity. The Pearson
    cap (``ratio``) additionally needs per-triplet labels ``t_y``, the
    label of example 0 (``y0``, for the synthetic intercept entries), and
    the slice's bucket-layout labels ``yb`` + kept mask.
    """
    if intercept_index is not None:
        # Force the intercept active for every live entity via synthetic
        # zero-valued entries (harmless: the intercept's Pearson score is
        # overridden to +inf below, so its moments are never consulted).
        l = np.concatenate([l, live])
        c = np.concatenate(
            [c, np.full(live.shape, intercept_index, np.int64)])
        v = np.concatenate([v, np.zeros(live.shape, np.float32)])
        if t_y is not None:
            t_y = np.concatenate([t_y, np.full(live.shape, y0, np.float64)])

    # Unique (lane, col) pairs in (lane, col)-ascending order; key_s is
    # already sorted, so run boundaries replace a second sort in unique().
    # Keys pack as lane << shift | col when that fits int64 (cols < d ≤
    # 2^shift): the unpack is then two bit ops instead of an int64
    # divmod — measured ~5x cheaper at the 10⁷-row staging scale — and
    # the sort order is the same lexicographic (lane, col). Sort kind is
    # numpy's default introsort: keys are sorted for their VALUES only
    # (uniques + run boundaries; equal keys are indistinguishable), and
    # for int64 the "stable" kind falls back to mergesort at ~7x the cost.
    shift = int(max(d, 1)).bit_length()
    lane_bits = int(max(E_b, 1)).bit_length()
    if shift + lane_bits <= 63:
        key = (l << shift) | c
    else:  # astronomically wide: keep the exact multiplicative packing
        shift = None
        key = l * np.int64(d + 1) + c
    if ratio is None:
        key_s = np.sort(key)
    else:
        # The Pearson pass additionally needs triplet values/labels in
        # sorted order, so keep the permutation. STABLE sort: equal keys
        # (several examples of one entity hitting one column) keep their
        # original triplet order, making the per-pair reduceat moment
        # sums reproducible to the BIT between the whole-bucket build and
        # the lane-sharded parallel build (fp addition is order-
        # sensitive; introsort's equal-key order depends on array size).
        order = np.argsort(key, kind="stable")
        key_s = key[order]
    newrun_k = np.ones(key_s.shape, bool)
    if key_s.size:
        newrun_k[1:] = key_s[1:] != key_s[:-1]
    first = np.flatnonzero(newrun_k)
    uniq = key_s[first]
    if shift is not None:
        u_lane = uniq >> shift
        u_col = uniq & ((np.int64(1) << shift) - 1)
    else:
        u_lane = (uniq // (d + 1)).astype(np.int64)
        u_col = (uniq % (d + 1)).astype(np.int64)

    if ratio is not None and uniq.size:
        # Centered (two-pass) Pearson moments, the stable computation the
        # reference's stableComputePearsonCorrelationScore / the dense
        # ``pearson_scores`` use: every accumulated term is a centered
        # square or product, so a column with a huge mean and small
        # variance cannot cancel to zero. Zero entries of a column enter
        # the centered sums analytically: Σ_all (x−mx)² =
        # Σ_nz (x−mx)² + n_zero·mx², and Σ_all (x−mx)(y−my) =
        # Σ_nz (x−mx)(y−my) − mx·(Σ_zero y − n_zero·my).
        inv = np.cumsum(newrun_k) - 1  # sorted entry -> pair id
        v_s = v[order].astype(np.float64)
        y_s = t_y[order]
        cnt = np.diff(np.append(first, key_s.shape[0])).astype(np.float64)
        yb = np.where(kept, yb, 0.0)
        n_e = kept.sum(axis=1).astype(np.float64)
        ne_safe = np.maximum(n_e, 1.0)
        sy = yb.sum(axis=1)
        my = sy / ne_safe
        dyb = np.where(kept, yb - my[:, None], 0.0)
        vary_lane = (dyb * dyb).sum(axis=1)
        sx = np.add.reduceat(v_s, first)
        ne_u = ne_safe[u_lane]
        mx = sx / ne_u
        dx = v_s - mx[inv]
        dy = y_s - my[u_lane][inv]
        n_zero = ne_u - cnt
        varx = np.add.reduceat(dx * dx, first) + n_zero * mx * mx
        sy_nz = np.add.reduceat(y_s, first)
        cov = np.add.reduceat(dx * dy, first) \
            - mx * ((sy[u_lane] - sy_nz) - n_zero * my[u_lane])
        vary = vary_lane[u_lane]
        denom = np.sqrt(np.maximum(varx * vary, 0.0))
        score = np.zeros(uniq.shape, np.float64)
        np.divide(np.abs(cov), denom, out=score, where=denom > 1e-12)
        if intercept_index is not None:
            score[u_col == intercept_index] = np.inf
        keep_e = np.maximum(
            1, np.ceil(ratio * n_e)).astype(np.int64)
        # Within each lane order by (-score, col) — ties break on the lower
        # column id deterministically — and keep the first keep_e.
        ordr = np.lexsort((u_col, -score, u_lane))
        lane_o = u_lane[ordr]
        newrun = np.ones(lane_o.shape, bool)
        newrun[1:] = lane_o[1:] != lane_o[:-1]
        run_starts = np.flatnonzero(newrun)
        start_of = np.repeat(
            run_starts, np.diff(np.append(run_starts, lane_o.shape[0])))
        rank = np.arange(lane_o.shape[0]) - start_of
        kept_idx = np.sort(ordr[rank < keep_e[lane_o]])
        u_lane = u_lane[kept_idx]
        u_col = u_col[kept_idx]
    return u_lane, u_col


def active_lane_counts(u_lane: np.ndarray, E_b: int) -> np.ndarray:
    """Active-column count per lane from the unique-pair lane ids."""
    return (np.bincount(u_lane, minlength=E_b) if u_lane.size
            else np.zeros(E_b, np.int64))


def projection_width(seg_counts: np.ndarray, d: int, min_dim: int = 8
                     ) -> int:
    """Bucket-wide projected width: pow-2 of the max per-lane active
    count, floored at ``min_dim``, capped at ``d``. An entity with more
    active columns than d_active cannot be truncated — widen (can only
    happen via the min() cap, where d_active == d)."""
    max_active = max(1, int(seg_counts.max()) if seg_counts.size else 1)
    return min(d, max(min_dim, _next_pow2(max_active)))


def fill_cols(
    u_lane: np.ndarray,
    u_col: np.ndarray,
    E_b: int,
    d_active: int,
    intercept_index: Optional[int],
) -> np.ndarray:
    """(E_b, d_active) column map from sorted unique pairs, intercept
    pinned to slot 0. Pure per-lane math — exact on any lane slice."""
    seg_counts = active_lane_counts(u_lane, E_b)
    starts = np.concatenate([[0], np.cumsum(seg_counts)[:-1]])
    pos = np.arange(u_lane.shape[0]) - starts[u_lane]
    if intercept_index is not None and u_lane.size:
        # Intercept first: static projected intercept slot 0; columns below
        # the intercept's sorted position shift up by one.
        is_int = u_col == intercept_index
        p_lane = np.zeros(E_b, np.int64)
        p_lane[u_lane[is_int]] = pos[is_int]
        slot = np.where(is_int, 0,
                        np.where(pos < p_lane[u_lane], pos + 1, pos))
    else:
        slot = pos
    cols = np.full((E_b, d_active), -1, np.int32)
    cols[u_lane, slot] = u_col.astype(np.int32)
    return cols


def gather_projected_features(
    bucket: EntityBucket,
    projection: BucketProjection,
    X,
    coo: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    triplets: Optional[BucketTriplets] = None,
) -> np.ndarray:
    """Project features forward into (E_b, cap, d_active) bucket layout.

    Padded example rows and padded column slots are zeroed (inert under the
    zero-weight / zero-feature contracts). Dense shards use one fancy
    gather; SparseShards scatter their O(nnz) triplets straight into the
    projected block — the dense (n, d) matrix never exists. Entries whose
    column was filtered out of the subspace (the Pearson cap) are dropped,
    exactly as the dense gather reads only the kept columns.
    """
    if not isinstance(X, SparseShard):
        ex = np.maximum(bucket.example_idx, 0)  # (E_b, cap)
        cols = np.maximum(projection.cols, 0)  # (E_b, d_active)
        Xp = X[ex[:, :, None], cols[:, None, :]].astype(X.dtype, copy=False)
        Xp = np.where(projection.cols[:, None, :] < 0, 0.0, Xp)
        Xp = np.where(bucket.example_idx[:, :, None] < 0, 0.0, Xp)
        return np.ascontiguousarray(Xp)

    _, d = X.shape
    E_b, cap = bucket.example_idx.shape
    if triplets is None:
        triplets = bucket_triplets(bucket, X, coo)
    return scatter_projected(E_b, cap, d, projection, triplets)


def scatter_projected(
    E_b: int,
    cap: int,
    d: int,
    projection: BucketProjection,
    triplets: BucketTriplets,
) -> np.ndarray:
    """Sparse-shard projected gather over explicit triplets: per-lane
    math only, so it is exact on lane slices of a bucket (the parallel
    staging path calls it with slice-local triplets and never needs the
    shard arrays themselves)."""
    d_active = projection.d_active
    c, v, l = triplets.cols, triplets.vals, triplets.lanes
    cp = triplets.cappos
    if cp is None:
        cp = triplets.cappos_of[triplets.rows]
    # Map (lane, global col) → projected slot through each lane's SORTED
    # active set: the flattened (lane-major, within-lane ascending) key
    # array is globally sorted, so one searchsorted resolves every entry;
    # ``perm`` carries sorted position → actual slot (intercept-first
    # reordering included, since it permutes ``projection.cols`` itself).
    cw = np.where(projection.cols < 0, d + 1, projection.cols).astype(
        np.int64)
    perm = np.argsort(cw, axis=1, kind="stable")
    sorted_cols = np.take_along_axis(cw, perm, axis=1)
    flat_keys = (np.arange(E_b, dtype=np.int64)[:, None] * (d + 2)
                 + sorted_cols).reshape(-1)
    want = l * np.int64(d + 2) + c
    gpos = np.searchsorted(flat_keys, want)
    inset = flat_keys[np.minimum(gpos, flat_keys.size - 1)] == want
    cp, v, l, gpos = cp[inset], v[inset], l[inset], gpos[inset]
    slot = perm[l, gpos - l * d_active]
    Xp = np.zeros((E_b, cap, d_active), np.float32)
    Xp[l, cp, slot] = v.astype(np.float32)
    return Xp


def project_norm_arrays(
    projection: BucketProjection,
    factors: Optional[np.ndarray],
    shifts: Optional[np.ndarray],
) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Project normalization factors/shifts into each entity's subspace.

    Padded slots get factor 1 / shift 0 (the intercept-column convention):
    with their features zeroed by ``gather_projected_features`` the
    transformed feature (0 − 0)·1 is identically 0, so padded coordinates
    see zero gradient and stay at their (zeroed) warm start, while the
    model-space transforms (divide by factor, shift-mass sums) remain
    well-defined.
    """
    cols = np.maximum(projection.cols, 0)
    pad = projection.cols < 0
    f_p = None
    if factors is not None:
        f_p = np.asarray(factors)[cols].astype(np.float32)
        f_p[pad] = 1.0
    s_p = None
    if shifts is not None:
        s_p = np.asarray(shifts)[cols].astype(np.float32)
        s_p[pad] = 0.0
    return f_p, s_p
