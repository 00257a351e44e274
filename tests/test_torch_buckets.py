"""The port's entity bucketing is the reference's, array for array.

Same ids, bounds and generator seed through
``photon_ml_tpu.game.buckets.build_bucketing`` and the port's copy:
entity rows, example ids, counts and the trained mask are equal, with
``upper_bound`` capping drawing its random subsets. Within a bucket the
valid row ids are unique, which is what lets the row scatter of a wave
run without atomics.
"""

import numpy as np
import pytest

from photon_ml_torch.game import buckets
from photon_ml_tpu.game import buckets as ref_buckets


def _ids(rng, n=3000, E=250):
    p = 1.0 / np.arange(1, E + 1) ** 1.2
    return rng.choice(E, size=n, p=p / p.sum()).astype(np.int32), E


@pytest.mark.parametrize("lower,upper", [(1, None), (1, 24), (3, 40)])
def test_bucketing_equals_reference(lower, upper):
    ids, E = _ids(np.random.default_rng(21))
    got = buckets.build_bucketing(ids, E, lower_bound=lower,
                                  upper_bound=upper,
                                  rng=np.random.default_rng(5))
    want = ref_buckets.build_bucketing(ids, E, lower_bound=lower,
                                       upper_bound=upper,
                                       rng=np.random.default_rng(5))
    assert len(got.buckets) == len(want.buckets) > 1
    for g, w in zip(got.buckets, want.buckets):
        np.testing.assert_array_equal(g.entity_rows, w.entity_rows)
        np.testing.assert_array_equal(g.example_idx, w.example_idx)
        np.testing.assert_array_equal(g.counts, w.counts)
        assert g.entity_rows.dtype == w.entity_rows.dtype
        assert g.example_idx.dtype == w.example_idx.dtype
    np.testing.assert_array_equal(got.trained_entities,
                                  want.trained_entities)
    assert got.num_passive_only_entities == want.num_passive_only_entities
    assert got.num_passive_examples == want.num_passive_examples
    if upper is not None:
        assert got.num_passive_examples > 0  # capping happened


def test_valid_rows_unique_within_each_bucket():
    ids, E = _ids(np.random.default_rng(22))
    bk = buckets.build_bucketing(ids, E, upper_bound=32,
                                 rng=np.random.default_rng(0))
    seen = []
    for b in bk.buckets:
        rows = b.entity_rows[b.entity_rows >= 0]
        assert len(np.unique(rows)) == len(rows)
        assert b.num_entities % bk.entity_pad_multiple == 0
        # Padding lanes trail the bucket and hold no examples.
        pad = b.entity_rows < 0
        assert np.all(b.example_idx[pad] == -1)
        seen.append(rows)
    seen = np.concatenate(seen)
    assert len(np.unique(seen)) == len(seen)  # one bucket per entity
    np.testing.assert_array_equal(np.sort(seen),
                                  np.flatnonzero(bk.trained_entities))


def test_bucket_arrays_mask_padding_slots():
    ids, E = _ids(np.random.default_rng(23), n=400, E=40)
    bk = buckets.build_bucketing(ids, E)
    weights = np.random.default_rng(1).uniform(0.5, 2.0, ids.shape[0])
    for b in bk.buckets:
        wb = buckets.bucket_weights(b, weights.astype(np.float32))
        assert np.all(wb[b.example_idx < 0] == 0.0)
        (ex_ids,) = buckets.gather_bucket_arrays(b, ids)
        live = b.example_idx >= 0
        lane_rows = np.broadcast_to(b.entity_rows[:, None], live.shape)
        np.testing.assert_array_equal(ex_ids[live], lane_rows[live])


def test_out_of_range_ids_raise():
    with pytest.raises(ValueError, match="entity ids must lie"):
        buckets.build_bucketing(np.array([0, 5], np.int32), 5)
