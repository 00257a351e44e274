"""The port's hybrid hot/cold layout against the reference's.

``build_hybrid`` must stage exactly what the JAX package's
``photon_ml_tpu.ops.hybrid_sparse.build_hybrid`` stages, bit for bit:
the permutation both ways, the hot count, the class starts, every
class's (C, L) row ids and values, and the hot block (the port's is
stored with zero columns up to a multiple of ``HOT_ALIGN``). Covered: the
default threshold, a threshold no column reaches (no hot block), an
all-hot layout (no cold class), ``max_hot`` capping, duplicate and
sentinel ELL slots, and an empty tail of columns. The aggregates
(margins, value and gradient, H·v, the Hessian diagonal with its hot
term in row blocks smaller than n) match the reference's within rtol
1e-5 (float32 sums in another order), and the two space maps invert
each other.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import sparse
from photon_ml_torch.ops import hybrid_sparse as hs
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.kernels import cold_grad, ell_scatter, stream_fused
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.ops import hybrid_sparse as ref_hs
from photon_ml_tpu.ops import losses as ref_losses

RTOL = 1e-5
N, DIM, NNZ = 4096, 4096, 32


def _batches(idx, val, seed=0):
    """The same ELL arrays as a port batch and a reference batch, with
    random labels, weights (some zero) and offsets."""
    rng = np.random.default_rng(seed)
    n = idx.shape[0]
    y = (rng.random(n) < 0.3).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    o = (0.2 * rng.normal(size=n)).astype(np.float32)
    t = torch.from_numpy
    return (sparse.SparseBatch(t(idx), t(val), t(y), t(w), t(o), DIM),
            ref_sparse.SparseBatch(idx, val, y, w, o, DIM))


def _zipf(seed=2):
    b, _ = sparse.synthetic_sparse(N, DIM, NNZ, seed=seed)
    rb, _ = ref_sparse.synthetic_sparse(N, DIM, NNZ, seed=seed)
    np.testing.assert_array_equal(b.indices.numpy(), np.asarray(rb.indices))
    return b.indices.numpy().copy(), b.values.numpy().copy()


def _messy():
    """Zipf rows with duplicate columns within a row (hot and cold),
    sentinel ids (d and past it), explicit zero values, and only the
    first 3,000 columns used, so the permuted tail is empty."""
    idx, val = _zipf(5)
    rng = np.random.default_rng(5)
    idx = np.where(idx < DIM, idx % 3000, idx).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # a duplicate in every row (often hot)
    idx[::7, 5] = idx[::7, 4]  # more, in the tail
    val[:, 1] = rng.normal(size=N).astype(np.float32)
    idx[rng.random(idx.shape) < 0.05] = DIM
    idx[rng.random(idx.shape) < 0.01] = DIM + 3
    val[rng.random(val.shape) < 0.02] = 0.0
    return idx, val


CASES = {
    "default threshold": (_zipf, {}),
    "no hot block": (_zipf, {"hot_threshold": 10 ** 9}),
    "all hot": (_zipf, {"hot_threshold": 1}),
    "max_hot caps": (_zipf, {"hot_threshold": 2, "max_hot": 37}),
    "duplicates, sentinels, empty tail": (_messy, {}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    make, kw = CASES[request.param]
    batch, ref_batch = _batches(*make())
    return (request.param, hs.build_hybrid(batch, device="cpu", **kw),
            ref_hs.build_hybrid(ref_batch, device=False, **kw))


def test_layout_matches_reference_bit_for_bit(pair):
    name, hb, ref = pair
    for f in ("perm", "inv_perm", "labels", "weights", "offsets"):
        np.testing.assert_array_equal(getattr(hb, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    assert hb.perm.dtype == hb.inv_perm.dtype == torch.int32
    assert hb.num_hot == ref.num_hot and hb.num_features == ref.num_features
    assert hb.class_starts == ref.class_starts
    assert len(hb.cold_rowids) == len(ref.cold_rowids)
    for a, b, ra, rb in zip(hb.cold_rowids, hb.cold_vals, ref.cold_rowids,
                            ref.cold_vals):
        assert a.dtype == torch.int32 and b.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), ra)
        np.testing.assert_array_equal(b.numpy(), rb)
    k = hb.num_hot
    assert hb.X_hot.shape[1] % hs.HOT_ALIGN == 0
    assert hb.X_hot.shape[1] - k < hs.HOT_ALIGN
    np.testing.assert_array_equal(hb.X_hot[:, :k].numpy(), ref.X_hot)
    assert not hb.X_hot[:, k:].any()
    np.testing.assert_array_equal(
        hb.cold_flat_rowids.numpy(),
        np.concatenate([r.reshape(-1) for r in ref.cold_rowids]
                       or [np.zeros(0, np.int32)]))
    assert hb.num_rows == N and hb.dim == DIM
    assert hb.num_cold_present == ref.num_cold_present
    assert hb.cold_layout is None  # built on a card only
    if name == "no hot block":
        assert k == 0
    if name == "all hot":
        assert k > 0 and not hb.cold_rowids
    if name == "max_hot caps":
        assert k == 37
    if name == "default threshold":
        assert k > 0 and len(hb.cold_rowids) >= 3
        assert hs._default_hot_threshold(N) == \
            ref_hs._default_hot_threshold(N, jnp.float32)
    if name.startswith("duplicates"):
        counts = np.bincount(np.asarray(ref.perm)[:hb.num_hot + sum(
            r.shape[0] for r in ref.cold_rowids)], minlength=DIM)
        assert counts[3000:].sum() == 0  # the unused columns are absent


def _shares_flat(views, flat, table):
    """Each view starts at its class's offset in ``flat``'s storage."""
    assert len(views) == len(table.shapes)
    for v, off, shape in zip(views, table.offsets, table.shapes):
        assert tuple(v.shape) == shape
        assert v.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
        assert v.data_ptr() == flat.data_ptr() + off * flat.element_size()


@pytest.mark.parametrize("moved", [False, True])
def test_cold_classes_are_views_of_the_flat_arrays(pair, moved):
    """After staging and after ``to``: the flat values are the
    reference's classes in class order, the table matches the classes,
    and each class's tensors are views of the flat ones."""
    _, hb, ref = pair
    if moved:
        hb = hb.to("cpu")
    np.testing.assert_array_equal(
        hb.cold_flat_vals.numpy(),
        np.concatenate([v.reshape(-1) for v in ref.cold_vals]
                       or [np.zeros(0, np.float32)]))
    assert hb.cold_flat_vals.dtype == torch.float32
    assert hb.cold_table.shapes == tuple(
        tuple(np.asarray(r).shape) for r in ref.cold_rowids)
    assert hb.cold_table.num_slots == hb.cold_flat_rowids.numel()
    _shares_flat(hb.cold_rowids, hb.cold_flat_rowids, hb.cold_table)
    _shares_flat(hb.cold_vals, hb.cold_flat_vals, hb.cold_table)


def _vectors(hb, seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=DIM)).astype(np.float32)
    v = rng.normal(size=DIM).astype(np.float32)
    return w, v


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def test_aggregates_match_reference(pair):
    _, hb, ref = pair
    w, v = _vectors(hb, 1)
    t = torch.from_numpy
    _close(hs.margins(hb, t(w)), ref_hs.margins(ref, jnp.asarray(w)))
    val, grad = hs.value_and_gradient(losses.LOGISTIC, t(w), hb)
    rval, rgrad = ref_hs.value_and_gradient(ref_losses.LOGISTIC,
                                            jnp.asarray(w), ref)
    np.testing.assert_allclose(float(val), float(rval), rtol=RTOL)
    _close(grad, rgrad)
    _close(hs.hessian_vector(losses.LOGISTIC, t(w), t(v), hb),
           ref_hs.hessian_vector(ref_losses.LOGISTIC, jnp.asarray(w),
                                 jnp.asarray(v), ref))


@pytest.mark.parametrize("block_rows", [hs.DIAG_BLOCK_ROWS, 1000, 4096])
def test_hessian_diagonal_matches_reference(pair, block_rows):
    """The hot term summed over row blocks (one block, ragged blocks,
    blocks that divide n) gives the reference's diagonal."""
    _, hb, ref = pair
    w, _ = _vectors(hb, 2)
    got = hs.hessian_diagonal(losses.LOGISTIC, torch.from_numpy(w), hb,
                              block_rows=block_rows)
    _close(got, ref_hs.hessian_diagonal(ref_losses.LOGISTIC,
                                        jnp.asarray(w), ref))


def test_space_maps_invert_and_match_reference(pair):
    _, hb, ref = pair
    w = np.random.default_rng(3).normal(size=DIM).astype(np.float32)
    p = hs.to_permuted_space(hb, torch.from_numpy(w))
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(ref_hs.to_permuted_space(ref, jnp.asarray(w))))
    np.testing.assert_array_equal(hs.to_original_space(hb, p).numpy(), w)
    np.testing.assert_array_equal(
        hs.to_permuted_space(hb, hs.to_original_space(
            hb, torch.from_numpy(w))).numpy(), w)


def test_to_moves_and_replace_keeps_fields():
    batch, _ = _batches(*_zipf())
    hb = hs.build_hybrid(batch)  # the batch's own device
    moved = hb.to("cpu")
    assert moved.device == torch.device("cpu") and moved.cold_layout is None
    for f in dataclasses.fields(hb):
        a, b = getattr(hb, f.name), getattr(moved, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        elif f.name != "cold_layout":
            assert a == b, f.name
    for a, b in zip(hb.cold_rowids + hb.cold_vals,
                    moved.cold_rowids + moved.cold_vals):
        assert torch.equal(a, b)
    swapped = dataclasses.replace(hb, offsets=torch.zeros(N))
    assert swapped.cold_flat_rowids is hb.cold_flat_rowids


def test_cpu_path_launches_no_kernel():
    batch, _ = _batches(*_zipf())
    hb = hs.build_hybrid(batch, device="cpu")
    counts = (cold_grad.cold_grad.launches,
              ell_scatter.scatter_rowterm.launches,
              stream_fused.hot_margins.launches,
              stream_fused.hot_rmatvec.launches)
    w = torch.zeros(DIM)
    hs.value_and_gradient(losses.LOGISTIC, w, hb)
    hs.hessian_diagonal(losses.LOGISTIC, w, hb, block_rows=1000)
    assert counts == (cold_grad.cold_grad.launches,
                      ell_scatter.scatter_rowterm.launches,
                      stream_fused.hot_margins.launches,
                      stream_fused.hot_rmatvec.launches)


def test_staged_on_cuda_matches_cpu():
    """On a card: the layout built there equals the CPU one, its cold
    scatter layout exists, and value and gradient agree with the CPU's
    within rtol 1e-5, the same bits on two passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hybrid path's kernels have no "
                    "CPU mode (chip_smoke.py drives them on the card)")
    batch, _ = _batches(*_zipf())
    cpu = hs.build_hybrid(batch, device="cpu")
    dev = hs.build_hybrid(batch, device="cuda")
    assert dev.cold_layout is not None
    assert torch.equal(dev.X_hot.cpu(), cpu.X_hot)
    w = torch.from_numpy(_vectors(cpu, 4)[0])
    v1, g1 = hs.value_and_gradient(losses.LOGISTIC, w.cuda(), dev)
    v2, g2 = hs.value_and_gradient(losses.LOGISTIC, w.cuda(), dev)
    vc, gc = hs.value_and_gradient(losses.LOGISTIC, w, cpu)
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    np.testing.assert_allclose(float(v1), float(vc), rtol=RTOL)
    _close(g1.cpu(), gc.numpy())


def test_one_cold_launch_per_pass_on_cuda():
    """On a card: value and gradient, H·v and the Hessian diagonal each
    launch cold_grad once, over every class."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hybrid path's kernels have no "
                    "CPU mode (chip_smoke.py drives them on the card)")
    batch, _ = _batches(*_zipf())
    dev = hs.build_hybrid(batch, device="cuda")
    assert len(dev.cold_rowids) >= 3
    w, v = (torch.from_numpy(x).cuda() for x in _vectors(dev, 5))
    for run in (lambda: hs.value_and_gradient(losses.LOGISTIC, w, dev),
                lambda: hs.hessian_vector(losses.LOGISTIC, w, v, dev),
                lambda: hs.hessian_diagonal(losses.LOGISTIC, w, dev)):
        before = cold_grad.cold_grad.launches
        run()
        assert cold_grad.cold_grad.launches == before + 1
