"""ell_rmatvec: Xᵀr over the ELL pattern, its row terms formed inside.

The plain version (what the wrapper runs on CPU tensors) is held against
the JAX package's ``scatter_rowterm_xla`` and ``scatter_rowterm_pallas``
(interpret mode) over the same row terms r ⊗ values and r ⊗ values²,
made in numpy: within float32 rounding (the sums run in another order),
and bit for bit on integer-valued inputs, where every partial sum is
exact. The layout it reads on the card (each valid slot's row and value
in column order) is held against a numpy stable argsort, and the Hopper
kernel's fixed order is replayed in numpy over it: bit for bit the
replay of the generic kernel's order over the materialised row terms,
which is what lets the ELL objective switch routes without changing a
bit. The kernel itself runs only on a CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data.sparse import SparseBatch
from photon_ml_torch.ops import sparse_aggregators as sagg
from photon_ml_torch.ops.kernels import ell_scatter as es
from photon_ml_torch.ops.losses import LOGISTIC
from photon_ml_tpu.ops.kernels import ell_scatter as ref

# Float32 sums of the same terms in another order: the docs/KERNELS.md
# gate, max |a − b| / max |b|.
PARITY_REL = 1e-3


def _case(rng, n, k, dim, integer=False):
    """Zipf-skewed ids (a hot head, a long tail), ~10% padding at the
    sentinel and a few ids past it, which must add nothing; values and r
    normal, or small integers (every product and sum then exact)."""
    ids = np.minimum(rng.zipf(1.3, size=(n, k)) - 1, dim - 1)
    ids[rng.random((n, k)) < 0.1] = dim
    ids[rng.random((n, k)) < 0.02] = dim + 5
    if integer:
        values = rng.integers(-4, 5, (n, k)).astype(np.float32)
        r = rng.integers(-3, 4, n).astype(np.float32)
    else:
        values = rng.normal(size=(n, k)).astype(np.float32)
        r = rng.normal(size=n).astype(np.float32)
    return ids.astype(np.int32), values, r


def _rowterms(values, r, square):
    """r ⊗ values (values²) in float32, as the caller formed them."""
    v = values * values if square else values
    return r[:, None] * v


def _fused(ids, values, r, dim, square):
    return es.ell_rmatvec(torch.from_numpy(ids), torch.from_numpy(values),
                          torch.from_numpy(r), dim, square=square).numpy()


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)


@pytest.mark.parametrize("square", [False, True])
def test_plain_matches_pallas_and_xla(square):
    dim = 512
    ids, values, r = _case(np.random.default_rng(7 + square), 700, 12, dim)
    got = _fused(ids, values, r, dim, square)
    assert got.shape == (dim,) and got.dtype == np.float32
    rv = jnp.asarray(_rowterms(values, r, square))
    pallas = np.asarray(ref.scatter_rowterm_pallas(
        jnp.asarray(ids), rv, dim, interpret=True))
    xla = np.asarray(ref.scatter_rowterm_xla(jnp.asarray(ids), rv, dim))
    assert _rel(got, pallas) <= PARITY_REL
    assert _rel(got, xla) <= PARITY_REL


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dim", [512, 100_000])
def test_integer_inputs_bit_exact(dim, square):
    ids, values, r = _case(np.random.default_rng(dim + square), 900, 16,
                           dim, integer=True)
    got = _fused(ids, values, r, dim, square)
    rv = jnp.asarray(_rowterms(values, r, square))
    np.testing.assert_array_equal(got, np.asarray(
        ref.scatter_rowterm_xla(jnp.asarray(ids), rv, dim)))
    if dim <= 512:
        np.testing.assert_array_equal(got, np.asarray(
            ref.scatter_rowterm_pallas(jnp.asarray(ids), rv, dim,
                                       interpret=True)))


@pytest.mark.parametrize("square", [False, True])
def test_plain_keeps_the_materialised_routes_bits(square):
    """On the CPU the fused entry is the plain scatter over the same row
    terms: every CPU result of the ELL objective keeps its bits."""
    dim = 3000
    ids, values, r = _case(np.random.default_rng(3), 2000, 24, dim)
    want = es.scatter_rowterm(torch.from_numpy(ids), torch.from_numpy(
        _rowterms(values, r, square)), dim).numpy()
    np.testing.assert_array_equal(_fused(ids, values, r, dim, square), want)


def _numpy_layout(ids, dim):
    flat = ids.reshape(-1)
    valid = np.nonzero(flat < dim)[0]
    perm = valid[np.argsort(flat[valid], kind="stable")]
    col_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(flat[flat < dim], minlength=dim))])
    return perm, col_ptr


@pytest.mark.parametrize("n,k,dim", [(3000, 16, 512), (20000, 8, 100),
                                     (50, 4, 7)])
def test_value_layout_matches_numpy(n, k, dim):
    ids, values, _ = _case(np.random.default_rng(n), n, k, dim)
    t_ids, t_values = torch.from_numpy(ids), torch.from_numpy(values)
    lay = es.build_layout(t_ids, dim, t_values)
    generic = es.build_layout(t_ids, dim)
    perm, col_ptr = _numpy_layout(ids, dim)
    np.testing.assert_array_equal(lay.rows.numpy(), perm // k)
    np.testing.assert_array_equal(lay.sorted_values.numpy(),
                                  values.reshape(-1)[perm])
    assert lay.rows.dtype == torch.int32
    assert lay.sorted_values.dtype == torch.float32
    assert lay.perm is None and lay.nnz == perm.size == generic.nnz
    for name in ("col_ptr", "piece_ptr", "piece_start", "piece_end"):
        assert torch.equal(getattr(lay, name), getattr(generic, name))
    np.testing.assert_array_equal(lay.col_ptr.numpy(), col_ptr)
    assert generic.rows is None and generic.sorted_values is None
    assert lay.nbytes == sum(t.numel() * 4 for t in (
        lay.col_ptr, lay.piece_ptr, lay.piece_start, lay.piece_end,
        lay.rows, lay.sorted_values))


def _replay(terms, lay):
    """The kernel's order over the column-ordered float32 ``terms``: each
    piece summed by 32 lanes (lane l takes entries l, l + 32, ... in
    order), the lanes by the xor butterfly (16, 8, 4, 2, 1), the pieces
    in order; a short column in row order; all in float32."""
    col_ptr, piece_ptr, start, end = (t.numpy().astype(np.int64) for t in (
        lay.col_ptr, lay.piece_ptr, lay.piece_start, lay.piece_end))
    partial = []
    for a, b in zip(start, end):
        lanes = np.zeros(32, np.float32)
        for j in range(a, b, 32):
            step = terms[j:min(j + 32, b)]
            lanes[:step.size] += step
        for offset in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ offset]
        partial.append(lanes[0])
    out = np.zeros(lay.dim, np.float32)
    for c in range(lay.dim):
        acc = np.float32(0.0)
        if piece_ptr[c + 1] > piece_ptr[c]:
            for p in range(piece_ptr[c], piece_ptr[c + 1]):
                acc = np.float32(acc + partial[p])
        else:
            for j in range(col_ptr[c], col_ptr[c + 1]):
                acc = np.float32(acc + terms[j])
        out[c] = acc
    return out


@pytest.mark.parametrize("square", [False, True])
def test_replay_of_the_fused_order_equals_the_generic_one(square):
    """The fused kernel's terms r[rows[j]] · v (· v) over the value
    layout are the generic kernel's rv[perm[j]] over r ⊗ values, bit for
    bit, in the same order, so the two sums agree bit for bit; one column
    long enough for three pieces, several of a few dozen entries."""
    n, k, dim = 10_000, 4, 400
    rng = np.random.default_rng(21)
    ids, values, r = _case(rng, n, k, dim)
    ids[:, 0] = 0  # every row: 10,000 entries, three pieces
    t_ids = torch.from_numpy(ids)
    lay = es.build_layout(t_ids, dim, torch.from_numpy(values))
    generic = es.build_layout(t_ids, dim)
    assert lay.num_pieces >= 3
    col_len = np.diff(lay.col_ptr.numpy())
    assert ((col_len > es.SHORT_COLUMN) & (col_len < es.PIECE)).any()
    assert ((col_len > 0) & (col_len <= es.SHORT_COLUMN)).any()
    rows, sv = lay.rows.numpy(), lay.sorted_values.numpy()
    fused_terms = (r[rows] * (sv * sv if square else sv)).astype(np.float32)
    rv = _rowterms(values, r, square).reshape(-1)
    generic_terms = rv[generic.perm.numpy()]
    np.testing.assert_array_equal(fused_terms, generic_terms)
    got = _replay(fused_terms, lay)
    np.testing.assert_array_equal(got, _replay(generic_terms, generic))
    assert _rel(got, _fused(ids, values, r, dim, square)) <= PARITY_REL


def test_cpu_path_leaves_launch_counters_alone():
    ids, values, r = _case(np.random.default_rng(2), 50, 4, 20)
    before = (es.ell_rmatvec.launches, es.scatter_rowterm.launches)
    _fused(ids, values, r, 20, False)
    _fused(ids, values, r, 20, True)
    assert (es.ell_rmatvec.launches, es.scatter_rowterm.launches) == before


@pytest.mark.parametrize("case", [
    "ids_dtype", "values_dtype", "values_shape", "r_dtype", "r_length",
    "negative_dim", "generic_layout", "layout_dim", "layout_slots",
    "values_for_layout"])
def test_wrapper_rejects_bad_inputs(case):
    ids = torch.zeros((4, 3), dtype=torch.int32)
    values = torch.zeros((4, 3))
    r = torch.zeros(4)
    dim, layout = 5, None
    if case == "ids_dtype":
        ids = ids.long()
    elif case == "values_dtype":
        values = values.double()
    elif case == "values_shape":
        values = torch.zeros((4, 2))
    elif case == "r_dtype":
        r = r.double()
    elif case == "r_length":
        r = torch.zeros(3)
    elif case == "negative_dim":
        dim = -1
    elif case == "generic_layout":
        layout = es.build_layout(ids, dim)
    elif case == "layout_dim":
        layout = es.build_layout(ids, dim + 1, values)
    elif case == "layout_slots":
        layout = es.build_layout(ids[:3], dim, values[:3])
    elif case == "values_for_layout":
        with pytest.raises(ValueError, match="float32"):
            es.build_layout(ids, dim, values.double())
        return
    with pytest.raises(ValueError):
        es.ell_rmatvec(ids, values, r, dim, layout=layout)


def test_scatter_rowterm_rejects_a_value_layout():
    ids = torch.zeros((4, 3), dtype=torch.int32)
    values = torch.ones((4, 3))
    with pytest.raises(ValueError, match="perm"):
        es.scatter_rowterm(ids, values, 5,
                           layout=es.build_layout(ids, 5, values))


def _batch(rng, n, k, dim):
    ids, values, _ = _case(rng, n, k, dim)
    values[ids >= dim] = 0.0  # the ELL contract: padding at dim, value 0
    return SparseBatch(
        indices=torch.from_numpy(np.minimum(ids, dim)),
        values=torch.from_numpy(values),
        labels=torch.from_numpy((rng.random(n) < 0.3).astype(np.float32)),
        weights=torch.from_numpy(
            np.where(rng.random(n) < 0.1, 0.0, rng.random(n) + 0.5)
            .astype(np.float32)),
        offsets=torch.from_numpy(rng.normal(size=n).astype(np.float32)),
        num_features=dim)


def test_objective_keeps_the_materialised_routes_bits():
    """The ELL objective's gradient, H·v and Hessian diagonal through
    ell_rmatvec give the bits of the scatter over r ⊗ values (values²)
    that the objective formed before."""
    rng = np.random.default_rng(5)
    dim = 700
    batch = _batch(rng, 1500, 10, dim)
    loss = LOGISTIC
    w = torch.from_numpy(rng.normal(size=dim).astype(np.float32) * 0.1)
    v = torch.from_numpy(rng.normal(size=dim).astype(np.float32))

    def masked(t):
        return torch.where(batch.weights > 0, batch.weights * t,
                           torch.zeros_like(t))

    def scatter(r, values):
        return es.scatter_rowterm(batch.indices, r[:, None] * values, dim)

    z = sagg.margins(batch, w)
    _, dl = loss.loss_and_dz(z, batch.labels)
    d2 = loss.d2z(z, batch.labels)
    xv = sagg.ell_matvec(batch.indices, batch.values, v)
    _, grad = sagg.value_and_gradient(loss, w, batch)
    assert torch.equal(grad, scatter(masked(dl), batch.values))
    assert torch.equal(sagg.hessian_vector(loss, w, v, batch),
                       scatter(masked(d2) * xv, batch.values))
    assert torch.equal(sagg.hessian_diagonal(loss, w, batch),
                       scatter(masked(d2), batch.values * batch.values))


def test_kernel_matches_generic_route_on_cuda():
    """On a card: ell_rmatvec over a batch staged with .to() gives the
    bits of scatter_rowterm over r ⊗ values (values²) and its generic
    layout, the same bits on two launches, integer inputs bit-exact with
    the plain version; without a layout it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ell_rmatvec kernel has no CPU "
                    "mode (chip_smoke.py holds it on the card)")
    rng = np.random.default_rng(13)
    for dim, integer in ((512, False), (100_000, False), (2048, True)):
        ids, values, r = _case(rng, 20000, 32, dim, integer=integer)
        i, x, rr = (torch.from_numpy(a).cuda() for a in (ids, values, r))
        lay = es.build_layout(i, dim, x)
        generic = es.build_layout(i, dim)
        for square in (False, True):
            got = es.ell_rmatvec(i, x, rr, dim, layout=lay, square=square)
            again = es.ell_rmatvec(i, x, rr, dim, layout=lay, square=square)
            rv = rr[:, None] * (x * x if square else x)
            want = es.scatter_rowterm(i, rv, dim, layout=generic)
            torch.cuda.synchronize()
            assert torch.equal(got, again) and torch.equal(got, want)
            if integer:
                assert torch.equal(got, es.scatter_rowterm_reference(
                    i, rv, dim))
        with pytest.raises(ValueError, match="layout"):
            es.ell_rmatvec(i, x, rr, dim)
