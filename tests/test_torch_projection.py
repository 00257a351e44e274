"""The port's projector (``game/projector.py``) against the reference's.

The projector is host numpy in both packages, so every function is held
to the reference's output BIT FOR BIT (same dtypes, same bytes) over
several seeds, dense and sparse (ELL) shards, with and without an
intercept column, and with and without the Pearson cap
(``features_to_samples_ratio``): the triplets, the per-bucket column
maps and widths, the projected feature blocks, the projected
normalization arrays and the Pearson scores. Lane slices of a bucket,
processed alone (what the staging pipeline does), equal the whole
bucket's build restricted to their lanes.
"""

import numpy as np
import pytest

from photon_ml_torch.data.game_data import SparseShard
from photon_ml_torch.game import buckets, projector
from photon_ml_tpu.data.game_data import SparseShard as RefSparseShard
from photon_ml_tpu.game import buckets as ref_buckets
from photon_ml_tpu.game import projector as ref_projector

N, E, D, K = 700, 48, 40, 5


def _data(seed: int, kind: str):
    """Entity ids with a heavy head (several capacity buckets), labels,
    and a shard whose entities each use a subset of the columns."""
    rng = np.random.default_rng(seed)
    ids = (rng.pareto(1.2, N) * 4).astype(np.int64) % E
    ids = ids.astype(np.int32)
    y = (rng.random(N) < 0.4).astype(np.float32)
    if kind == "dense":
        emask = rng.random((E, D)) < 0.35
        X = (rng.normal(0.5, 2.0, size=(N, D))
             * (rng.random((N, D)) < 0.6) * emask[ids]).astype(np.float32)
        X[:, 0] = 1.0
        return ids, y, X, X.copy()
    pools = rng.integers(0, D, size=(E, 8))
    idx = np.sort(pools[ids[:, None], rng.integers(0, 8, (N, K))], axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    vals = rng.normal(size=(N, K)).astype(np.float32)
    vals[rng.random((N, K)) < 0.1] = 0.0  # explicit zeros are dropped
    idx[dup] = D
    vals[dup] = 0.0
    idx = idx.astype(np.int32)
    return (ids, y, SparseShard(idx, vals, D),
            RefSparseShard(idx.copy(), vals.copy(), D))


def _bucketings(ids):
    kw = dict(lower_bound=1, upper_bound=24)
    got = buckets.build_bucketing(ids, E, rng=np.random.default_rng(0), **kw)
    want = ref_buckets.build_bucketing(ids, E, rng=np.random.default_rng(0),
                                       **kw)
    return got, want


def _same(a, b, what):
    """Equal bytes, dtype and shape (None on both sides counts)."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                      b.dtype, a.shape,
                                                      b.shape)
    assert a.tobytes() == b.tobytes(), what


def _same_triplets(t, r, what):
    for f in ("rows", "cols", "vals", "lanes", "lane_of", "cappos_of",
              "cappos"):
        _same(getattr(t, f), getattr(r, f), f"{what}.{f}")


@pytest.mark.parametrize("ratio", [None, 0.4])
@pytest.mark.parametrize("intercept", [None, 0])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_functions_bit_equal(seed, kind, intercept, ratio):
    ids, y, X, rX = _data(seed, kind)
    bk, rbk = _bucketings(ids)
    coo, rcoo = projector.shard_coo(X), ref_projector.shard_coo(rX)
    for a, b, f in zip(coo, rcoo, ("rows", "cols", "vals")):
        _same(a, b, f"shard_coo.{f}")
    alls = projector.all_bucket_triplets(bk.buckets, X, coo)
    ralls = ref_projector.all_bucket_triplets(rbk.buckets, rX, rcoo)
    assert len(alls) == len(ralls) == len(bk.buckets) > 1
    for bi, (b, rb) in enumerate(zip(bk.buckets, rbk.buckets)):
        _same_triplets(alls[bi], ralls[bi], f"all_bucket_triplets[{bi}]")
        trip = projector.bucket_triplets(b, X, coo)
        _same_triplets(trip, ref_projector.bucket_triplets(rb, rX, rcoo),
                       f"bucket_triplets[{bi}]")
        proj = projector.build_bucket_projection(
            b, X, intercept, labels=y, features_to_samples_ratio=ratio,
            triplets=trip)
        rproj = ref_projector.build_bucket_projection(
            rb, rX, intercept, labels=y, features_to_samples_ratio=ratio,
            coo=rcoo)
        assert proj.d_active == rproj.d_active
        assert proj.num_entities == rproj.num_entities
        _same(proj.cols, rproj.cols, f"cols[{bi}]")
        if intercept is not None:
            live = b.entity_rows >= 0
            assert np.all(proj.cols[live, 0] == intercept)
        _same(projector.gather_projected_features(b, proj, X, coo, trip),
              ref_projector.gather_projected_features(rb, rproj, rX,
                                                      coo=rcoo),
              f"features[{bi}]")


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_pearson_scores_bit_equal(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(3.0, 0.01, size=(300, 12)).astype(np.float32)
    X[:, 2] = 7.0  # constant: scores 0, not NaN
    y = (rng.random(300) < 0.3).astype(np.float32)
    _same(projector.pearson_scores(X, y),
          ref_projector.pearson_scores(X, y), "pearson")
    assert projector.pearson_scores(X, y)[2] == 0.0


@pytest.mark.parametrize("shifts", [False, True])
def test_project_norm_arrays_bit_equal(shifts):
    ids, y, X, rX = _data(5, "dense")
    bk, rbk = _bucketings(ids)
    f = (1.0 / np.maximum(X.std(0), 1e-3)).astype(np.float32)
    s = X.mean(0).astype(np.float32) if shifts else None
    for b, rb in zip(bk.buckets, rbk.buckets):
        proj = projector.build_bucket_projection(b, X, 0)
        rproj = ref_projector.build_bucket_projection(rb, rX, 0)
        got = projector.project_norm_arrays(proj, f, s)
        want = ref_projector.project_norm_arrays(rproj, f, s)
        for a, w, what in zip(got, want, ("factors", "shifts")):
            _same(a, w, what)
        pad = proj.cols < 0
        assert np.all(got[0][pad] == 1.0)
        if shifts:
            assert np.all(got[1][pad] == 0.0)


@pytest.mark.parametrize("ratio", [None, 0.4])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_lane_slices_equal_the_whole_bucket(kind, ratio):
    """Pairs, column maps and the sparse scatter of two lane slices, each
    processed alone with slice-local lanes and the bucket's width, are
    the whole bucket's rows."""
    ids, y, X, _ = _data(7, kind)
    bk, _ = _bucketings(ids)
    b = max(bk.buckets, key=lambda b: b.num_entities)
    E_b, cap = b.example_idx.shape
    trip = projector.bucket_triplets(b, X)
    whole = projector.build_bucket_projection(
        b, X, 0, labels=y, features_to_samples_ratio=ratio, triplets=trip)
    cappos = trip.cappos_of[trip.rows]
    y64 = y.astype(np.float64)
    cut = (E_b // 16) * 8
    parts, feats = [], []
    for lo, hi in ((0, cut), (cut, E_b)):
        sel = (trip.lanes >= lo) & (trip.lanes < hi)
        ex = b.example_idx[lo:hi]
        yb = y64[np.maximum(ex, 0)]
        yb[ex < 0] = 0.0
        live = np.flatnonzero(b.entity_rows[lo:hi] >= 0).astype(np.int64)
        u_lane, u_col = projector.active_pairs(
            hi - lo, D, 0, live, trip.cols[sel], trip.vals[sel],
            trip.lanes[sel] - lo, ratio=ratio,
            t_y=y64[trip.rows[sel]] if ratio else None,
            y0=float(y64[0]), yb=yb if ratio else None, kept=ex >= 0)
        cols = projector.fill_cols(u_lane, u_col, hi - lo, whole.d_active, 0)
        parts.append(cols)
        if kind == "sparse":
            sl = projector.BucketTriplets(
                rows=np.zeros(0, np.int32), cols=trip.cols[sel],
                vals=trip.vals[sel], lanes=trip.lanes[sel] - lo,
                cappos=cappos[sel])
            feats.append(projector.scatter_projected(
                hi - lo, cap, D,
                projector.BucketProjection(cols, whole.d_active), sl))
    np.testing.assert_array_equal(np.concatenate(parts), whole.cols)
    if kind == "sparse":
        full = projector.gather_projected_features(b, whole, X,
                                                   triplets=trip)
        assert np.concatenate(feats).tobytes() == full.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_subspace_rows_and_positions_match_the_reference(seed):
    """``sort_subspace_rows`` and the score-side join ``_subspace_positions``
    (another algorithm than the reference's, the same positions): hits,
    inactive columns, ELL padding, ids past the table, a column held twice
    in one row and unsorted rows, in blocks smaller than the data."""
    from photon_ml_torch.game import models
    from photon_ml_tpu.game import models as ref_models

    rng = np.random.default_rng(seed)
    E_, A, d, n = 50, 6, 30, 400
    cols = rng.integers(0, d, (E_, A)).astype(np.int32)
    cols[rng.random((E_, A)) < 0.3] = -1
    cols[3, 1] = cols[3, 4] = 7  # a column held twice
    vals = rng.normal(size=(E_, A)).astype(np.float32)
    got = models.sort_subspace_rows(cols, vals, None)
    want = ref_models.sort_subspace_rows(cols, vals, None)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b, "sorted")
    assert got[3] is None and want[3] is None
    ids = rng.integers(0, E_ + 3, n).astype(np.int32)  # some past E
    idx = rng.integers(0, d + 1, (n, 5)).astype(np.int32)  # d = padding
    for table in (cols, got[0]):
        want_pos = ref_models._subspace_positions(table, d, ids, idx)
        _same(models._subspace_positions(table, d, ids, idx, block_rows=64),
              want_pos, "positions")
        assert (want_pos < E_ * A).any() and (want_pos == E_ * A).any()
    empty = np.full((E_, A), -1, np.int32)
    _same(models._subspace_positions(empty, d, ids, idx),
          ref_models._subspace_positions(empty, d, ids, idx), "empty")
