"""ell_scatter: the port's ELL scatter-add against the reference kernels.

The plain version (what the wrapper runs on CPU tensors) is held against
``scatter_rowterm_pallas`` in interpret mode and ``scatter_rowterm_xla``
at the dimensions where the JAX package runs its Pallas kernel, and
against ``scatter_rowterm_xla`` at d = 100,000: within float32 rounding
(the sums run in another order), and bit for bit on integer-valued row
terms, where every partial sum is exact. The column layout the Hopper
kernel reads is held against numpy, and the kernel's two-pass order is
replayed in numpy over it. The kernel itself runs only on a CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.ops.kernels import ell_scatter as es
from photon_ml_tpu.ops.kernels import ell_scatter as ref

# Float32 sums of the same terms in another order: the docs/KERNELS.md
# gate, max |a − b| / max |b|.
PARITY_REL = 1e-3
# And each column on its own: within this share of its Σ|terms| of its
# exact (float64) sum.
COLUMN_TOL = 1e-5


def _case(rng, n, k, dim, integer=False):
    """Zipf-skewed ids (a hot head, a long tail), ~10% padding at the
    sentinel and a few ids past it, which must add nothing."""
    ids = np.minimum(rng.zipf(1.3, size=(n, k)) - 1, dim - 1)
    ids[rng.random((n, k)) < 0.1] = dim
    ids[rng.random((n, k)) < 0.02] = dim + 5
    if integer:
        rv = rng.integers(-8, 9, (n, k)).astype(np.float32)
    else:
        rv = rng.normal(size=(n, k)).astype(np.float32)
    return ids.astype(np.int32), rv


def _plain(ids, rv, dim):
    return es.scatter_rowterm(torch.from_numpy(ids), torch.from_numpy(rv),
                              dim).numpy()


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


@pytest.mark.parametrize("dim", [96, 512])
def test_plain_matches_pallas_and_xla(dim):
    ids, rv = _case(np.random.default_rng(dim), 700, 12, dim)
    got = _plain(ids, rv, dim)
    assert got.shape == (dim,) and got.dtype == np.float32
    pallas = np.asarray(ref.scatter_rowterm_pallas(
        jnp.asarray(ids), jnp.asarray(rv), dim, interpret=True))
    xla = np.asarray(ref.scatter_rowterm_xla(jnp.asarray(ids),
                                             jnp.asarray(rv), dim))
    assert _rel(got, pallas) <= PARITY_REL
    assert _rel(got, xla) <= PARITY_REL


def test_plain_matches_xla_at_large_dim():
    dim = 100_000
    ids, rv = _case(np.random.default_rng(5), 4000, 32, dim)
    got = _plain(ids, rv, dim)
    xla = np.asarray(ref.scatter_rowterm_xla(jnp.asarray(ids),
                                             jnp.asarray(rv), dim))
    assert _rel(got, xla) <= PARITY_REL


@pytest.mark.parametrize("dim", [96, 512, 100_000])
def test_integer_row_terms_bit_exact(dim):
    ids, rv = _case(np.random.default_rng(dim + 1), 900, 16, dim,
                    integer=True)
    got = _plain(ids, rv, dim)
    np.testing.assert_array_equal(got, np.asarray(ref.scatter_rowterm_xla(
        jnp.asarray(ids), jnp.asarray(rv), dim)))
    if dim <= 512:
        np.testing.assert_array_equal(got, np.asarray(
            ref.scatter_rowterm_pallas(jnp.asarray(ids), jnp.asarray(rv),
                                       dim, interpret=True)))


def test_padding_and_empty_columns():
    dim = 10
    ids = np.array([[0, 10, 10, 3], [10, 10, 10, 10], [3, 12, 0, 99]],
                   np.int32)
    rv = np.array([[1.0, 7.0, 7.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                   [4.0, 9.0, 0.5, 9.0]], np.float32)
    want = np.zeros(dim, np.float32)
    want[0], want[3] = 1.5, 6.0
    np.testing.assert_array_equal(_plain(ids, rv, dim), want)
    all_pad = np.full((5, 3), dim, np.int32)
    np.testing.assert_array_equal(
        _plain(all_pad, np.ones((5, 3), np.float32), dim),
        np.zeros(dim, np.float32))
    layout = es.build_layout(torch.from_numpy(all_pad), dim)
    assert layout.nnz == 0 and layout.num_pieces == 0
    assert not layout.col_ptr.any()


def _numpy_layout(ids, dim):
    flat = ids.reshape(-1)
    valid = np.nonzero(flat < dim)[0]
    perm = valid[np.argsort(flat[valid], kind="stable")]
    col_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(flat[flat < dim], minlength=dim))])
    return perm, col_ptr


@pytest.mark.parametrize("n,k,dim", [(3000, 16, 512), (20000, 8, 100),
                                     (50, 4, 7)])
def test_layout_matches_numpy_and_replays_the_kernel(n, k, dim):
    rng = np.random.default_rng(n)
    ids, rv = _case(rng, n, k, dim)
    lay = es.build_layout(torch.from_numpy(ids), dim)
    perm, col_ptr = _numpy_layout(ids, dim)
    np.testing.assert_array_equal(lay.perm.numpy(), perm)
    np.testing.assert_array_equal(lay.col_ptr.numpy(), col_ptr)
    assert lay.perm.dtype == torch.int32 and lay.numel == n * k
    # The kernel's order: each piece summed lane-strided, then pieces in
    # order; short columns in row order. Integer terms make every order
    # exact, so the replay equals the plain version bit for bit.
    rv = rng.integers(-8, 9, (n, k)).astype(np.float32).reshape(-1)
    ps, pe, pp = (t.numpy().astype(np.int64) for t in
                  (lay.piece_start, lay.piece_end, lay.piece_ptr))
    partial = [rv[perm[a:b]].sum() for a, b in zip(ps, pe)]
    out = np.array([
        np.sum(partial[pp[c]:pp[c + 1]], dtype=np.float32)
        if pp[c + 1] > pp[c] else rv[perm[col_ptr[c]:col_ptr[c + 1]]].sum()
        for c in range(dim)], np.float32)
    np.testing.assert_array_equal(out, _plain(ids, rv.reshape(n, k), dim))


def test_pieces_cover_long_columns_with_large_offsets():
    """Piece bounds are computed in int64 and fit int32 up to 2^31 − 1:
    a column pointer past 2^31 / 8 (what n·k reaches at config 5) cuts
    into exact pieces without a tensor that large."""
    short, long_len = es.SHORT_COLUMN, 3 * es.PIECE + 17
    base = 2 ** 31 // 8 + 12345
    counts = np.array([0, short, long_len, 1, short + 1], np.int64)
    col_ptr = torch.from_numpy(
        np.concatenate([[base], base + np.cumsum(counts)]).astype(np.int32))
    piece_ptr, start, end = es.build_pieces(col_ptr)
    np.testing.assert_array_equal(piece_ptr.numpy(), [0, 0, 0, 4, 4, 5])
    lo = base + short
    np.testing.assert_array_equal(
        start.numpy(), [lo, lo + es.PIECE, lo + 2 * es.PIECE,
                        lo + 3 * es.PIECE, lo + long_len + 1])
    np.testing.assert_array_equal(
        end.numpy(), [lo + es.PIECE, lo + 2 * es.PIECE, lo + 3 * es.PIECE,
                      lo + long_len, lo + long_len + 2 + short])
    assert start.dtype == end.dtype == torch.int32


def test_cpu_wrapper_leaves_launch_counter_alone():
    ids, rv = _case(np.random.default_rng(2), 50, 4, 20)
    before = es.scatter_rowterm.launches
    _plain(ids, rv, 20)
    assert es.scatter_rowterm.launches == before


@pytest.mark.parametrize("case", ["ids_dtype", "rv_dtype", "rv_shape",
                                  "negative_dim", "negative_id"])
def test_wrapper_rejects_bad_inputs(case):
    ids = torch.zeros((4, 3), dtype=torch.int32)
    rv = torch.zeros((4, 3))
    dim = 5
    if case == "ids_dtype":
        ids = ids.long()
    elif case == "rv_dtype":
        rv = rv.double()
    elif case == "rv_shape":
        rv = torch.zeros((4, 2))
    elif case == "negative_dim":
        dim = -1
    if case == "negative_id":
        ids[1, 2] = -3
        with pytest.raises(ValueError, match=">= 0"):
            es.build_layout(ids, dim)
        return
    with pytest.raises(ValueError):
        es.scatter_rowterm(ids, rv, dim)


def test_kernel_matches_plain_on_cuda():
    """On a card: the kernel within PARITY_REL of its plain version and
    each column within COLUMN_TOL · Σ|terms| of its exact sum, bit-exact
    on integer terms, the same bits on two launches; without a layout it
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ell_scatter kernel has no "
                    "CPU mode (chip_smoke.py holds it on the card)")
    rng = np.random.default_rng(11)
    for dim, integer in ((512, False), (100_000, False), (2048, True)):
        ids, rv = _case(rng, 20000, 32, dim, integer=integer)
        i, r = (torch.from_numpy(a).cuda() for a in (ids, rv))
        lay = es.build_layout(i, dim)
        got = es.scatter_rowterm(i, r, dim, layout=lay)
        again = es.scatter_rowterm(i, r, dim, layout=lay)
        want = es.scatter_rowterm_reference(i, r, dim)
        flat = i.reshape(-1).long().clamp(max=dim)

        def exact(t):
            return torch.zeros(dim + 1, dtype=torch.float64,
                               device=t.device).index_add_(
                0, flat, t.reshape(-1).double())[:dim]
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if integer:
            assert torch.equal(got, want)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= PARITY_REL
        assert bool(((got.double() - exact(r)).abs()
                     <= COLUMN_TOL * exact(r.abs())).all())
        with pytest.raises(ValueError, match="layout"):
            es.scatter_rowterm(i, r, dim)
