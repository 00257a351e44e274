"""cold_grad: the hybrid layout's cold-class gradient against the reference.

The plain versions (what the wrappers run on CPU tensors) are held
against the JAX package's two-pass XLA form
(``photon_ml_tpu/ops/hybrid_sparse._cold_grad``) and against the TPU
kernel the port replaces, ``fused_cold_grad`` of
``dev-scripts/exp_cold_gather.py``, in interpret mode: one class at a
time through ``cold_grad``, and every class of a layout at once through
``cold_grad_classes`` over the flat arrays; within 1e-6 (float32 sums of
the same terms in another order), and bit for bit on integer-valued
inputs. Also: the class table (offsets, outputs, threads per column,
block starts; no classes, one L = 1 class), the L = 1 class, an
all-padding class, squared values (the Hessian diagonal's use), ids
outside [0, n), the wrappers' input checks, and that the CPU path leaves
the launch count alone. The kernel itself runs only on a CUDA card.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.ops.kernels import cold_grad as cg
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.ops import hybrid_sparse as ref_hs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
N = 4096


def _experiment():
    """``dev-scripts/exp_cold_gather.py`` as a module (its import enables
    the JAX compile cache in the repo's ignored ``.jax_cache/``)."""
    path = os.path.join(REPO, "dev-scripts", "exp_cold_gather.py")
    spec = importlib.util.spec_from_file_location("exp_cold_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _r2d(r):
    """The experiment's (n_pad/128, 128) residual table, flat slot n = 0."""
    n = r.shape[0]
    flat_pad = (-(n + 1)) % 128 + 1
    return jnp.concatenate([jnp.asarray(r),
                            jnp.zeros((flat_pad,), jnp.float32)]
                           ).reshape(-1, 128)


@pytest.fixture(scope="module")
def layout():
    """The reference's hybrid layout of a config-5 shaped batch, and a
    residual."""
    batch, _ = ref_sparse.synthetic_sparse(N, 4096, 32, seed=2)
    hb = ref_hs.build_hybrid(batch, device=False)
    r = np.random.default_rng(0).normal(size=N).astype(np.float32)
    return hb, r


def _plain(r, rows, vals):
    return cg.cold_grad(torch.from_numpy(np.asarray(r)),
                        torch.from_numpy(np.asarray(rows)),
                        torch.from_numpy(np.asarray(vals))).numpy()


def test_plain_matches_xla_cold_grad_per_class(layout):
    hb, r = layout
    assert len(hb.cold_rowids) >= 3
    want = ref_hs._cold_grad(hb, jnp.asarray(r), hb.cold_vals)
    for rows, vals, w in zip(hb.cold_rowids, hb.cold_vals, want):
        got = _plain(r, rows, vals)
        assert got.shape == (rows.shape[0],) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL)


def _flat(classes):
    """Classes [(rows, vals)] laid flat, class after class, and their
    table."""
    rows = np.concatenate([np.asarray(a).reshape(-1) for a, _ in classes]
                          or [np.zeros(0, np.int32)])
    vals = np.concatenate([np.asarray(b).reshape(-1) for _, b in classes]
                          or [np.zeros(0, np.float32)])
    table = cg.class_table([np.asarray(a).shape for a, _ in classes])
    return torch.from_numpy(rows), torch.from_numpy(vals), table


def test_classes_plain_matches_xla_cold_grad(layout):
    """Every class of the layout in one call, against the reference's
    per-class slices concatenated."""
    hb, r = layout
    rows, vals, table = _flat(list(zip(hb.cold_rowids, hb.cold_vals)))
    got = cg.cold_grad_classes(torch.from_numpy(r), rows, vals,
                               table).numpy()
    want = np.concatenate([np.asarray(w) for w in ref_hs._cold_grad(
        hb, jnp.asarray(r), hb.cold_vals)])
    assert got.shape == (table.num_columns,) and got.dtype == np.float32
    assert table.num_columns == hb.num_cold_present
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_classes_plain_matches_fused_pallas_kernel_per_class(layout):
    """Each class's slice of the one-call output against the TPU kernel
    in interpret mode, the squared values (the diagonal's) too."""
    hb, r = layout
    rows, vals, table = _flat(list(zip(hb.cold_rowids, hb.cold_vals)))
    exp = _experiment()
    r2d = _r2d(r)
    for v in (vals, vals * vals):
        got = cg.cold_grad_classes(torch.from_numpy(r), rows, v,
                                   table).numpy()
        for a, b, o in zip(cg.class_views(rows, table),
                           cg.class_views(v, table), table.out_offsets):
            want = np.asarray(exp.fused_cold_grad(
                r2d, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                interpret=True))
            np.testing.assert_allclose(got[o:o + a.shape[0]], want,
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length,threads", [
    (0, 1), (1, 1), (2, 1), (4, 1), (8, 2), (16, 4), (17, 8), (32, 8),
    (64, 16), (512, 128), (1024, 256), (4096, 256), (1 << 20, 256)])
def test_threads_per_column(length, threads):
    assert cg.threads_per_column(length) == threads


def test_class_table_of_the_layout(layout):
    """Offsets, outputs and block starts are the prefix sums of C·L, C
    and ⌈C·T / 256⌉ in class order, and the launcher's packed rows say
    the same."""
    hb, _ = layout
    shapes = [tuple(np.asarray(a).shape) for a in hb.cold_rowids]
    t = cg.class_table(shapes)
    C = np.array([c for c, _ in shapes])
    L = np.array([length for _, length in shapes])
    T = np.array([cg.threads_per_column(length) for length in L])
    blocks = -(-C * T // cg.BLOCK_THREADS)
    assert t.shapes == tuple(shapes) and t.threads == tuple(T)
    assert t.offsets == tuple(np.cumsum(C * L) - C * L)
    assert t.out_offsets == tuple(np.cumsum(C) - C)
    assert t.block_starts == tuple(np.cumsum(blocks) - blocks)
    assert (t.num_slots, t.num_columns, t.num_blocks) == (
        int((C * L).sum()), int(C.sum()), int(blocks.sum()))
    np.testing.assert_array_equal(
        np.array(t.packed).reshape(-1, 6),
        np.stack([t.offsets, C, L, T, t.out_offsets, t.block_starts], 1))


def test_class_table_without_classes():
    t = cg.class_table([])
    assert (t.shapes, t.offsets, t.num_blocks, t.num_slots,
            t.num_columns) == ((), (), 0, 0, 0)
    rows, vals, _ = _flat([])
    out = cg.cold_grad_classes(torch.ones(5), rows, vals, t)
    assert out.shape == (0,) and out.dtype == torch.float32
    assert cg.class_views(rows, t) == ()


def test_class_table_of_one_l1_class():
    t = cg.class_table([(300, 1)])
    assert (t.offsets, t.out_offsets, t.threads, t.block_starts) == (
        (0,), (0,), (1,), (0,))
    assert (t.num_blocks, t.num_slots, t.num_columns) == (2, 300, 300)
    rng = np.random.default_rng(7)
    rows, vals = _class(rng, 50, 300, 1, 0.7)
    r = rng.normal(size=50).astype(np.float32)
    got = cg.cold_grad_classes(torch.from_numpy(r),
                               torch.from_numpy(rows.reshape(-1)),
                               torch.from_numpy(vals.reshape(-1)), t)
    np.testing.assert_array_equal(got.numpy(), _plain(r, rows, vals))


def test_class_table_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="classes exceed"):
        cg.class_table([(1, 1)] * (cg.MAX_CLASSES + 1))
    with pytest.raises(ValueError, match="class shape"):
        cg.class_table([(-1, 4)])


def test_class_views_share_the_flat_storage():
    flat = torch.arange(2 * 8 + 3 * 2, dtype=torch.int32)
    t = cg.class_table([(2, 8), (3, 2)])
    a, b = cg.class_views(flat, t)
    assert a.shape == (2, 8) and b.shape == (3, 2)
    assert a.data_ptr() == flat.data_ptr()
    assert b.data_ptr() == flat.data_ptr() + 16 * flat.element_size()
    np.testing.assert_array_equal(b.numpy().reshape(-1), np.arange(16, 22))


def test_plain_matches_fused_pallas_kernel(layout):
    hb, r = layout
    exp = _experiment()
    r2d = _r2d(r)
    for rows, vals in zip(hb.cold_rowids, hb.cold_vals):
        want = np.asarray(exp.fused_cold_grad(
            r2d, jnp.asarray(rows), jnp.asarray(vals), interpret=True))
        np.testing.assert_allclose(_plain(r, rows, vals), want, rtol=TOL,
                                   atol=TOL)


def test_squared_values_match_reference_diagonal_term(layout):
    hb, r = layout
    sq = tuple(np.asarray(v) * np.asarray(v) for v in hb.cold_vals)
    want = ref_hs._cold_grad(hb, jnp.asarray(r),
                             tuple(jnp.asarray(v) for v in sq))
    for rows, v2, w in zip(hb.cold_rowids, sq, want):
        np.testing.assert_allclose(_plain(r, rows, v2), np.asarray(w),
                                   rtol=TOL, atol=TOL)


def _class(rng, n, C, L, fill, integer=False):
    """A (C, L) class: each column's first ``fill`` share of slots hold
    row ids in [0, n), the rest padding (id n, value 0)."""
    rows = np.full((C, L), n, np.int32)
    vals = np.zeros((C, L), np.float32)
    live = rng.random((C, L)) < fill
    rows[live] = rng.integers(0, n, int(live.sum()))
    vals[live] = (rng.integers(-8, 9, int(live.sum())) if integer
                  else rng.normal(size=int(live.sum())))
    return rows, vals


@pytest.mark.parametrize("C,L,fill", [(700, 1, 1.0), (300, 1, 0.5),
                                      (64, 8, 0.0), (50, 64, 0.7),
                                      (3, 2048, 0.9)])
def test_edge_classes_match_pallas_kernel(C, L, fill):
    """The L = 1 class, all-padding and half-padded classes, and long
    columns, against the TPU kernel in interpret mode."""
    rng = np.random.default_rng(C * L)
    n = 1000
    rows, vals = _class(rng, n, C, L, fill)
    r = rng.normal(size=n).astype(np.float32)
    want = np.asarray(_experiment().fused_cold_grad(
        _r2d(r), jnp.asarray(rows), jnp.asarray(vals), interpret=True))
    got = _plain(r, rows, vals)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if fill == 0.0:
        np.testing.assert_array_equal(got, np.zeros(C, np.float32))


def test_integer_inputs_bit_exact():
    rng = np.random.default_rng(3)
    n = 2000
    r = rng.integers(-4, 5, n).astype(np.float32)
    for C, L in ((500, 1), (200, 16), (20, 512)):
        rows, vals = _class(rng, n, C, L, 0.8, integer=True)
        got = _plain(r, rows, vals)
        exact = np.where(rows < n, np.concatenate([r, [0]])[rows], 0.0)
        np.testing.assert_array_equal(
            got, (exact.astype(np.float64) * vals).sum(1).astype(np.float32))


def test_ids_outside_the_rows_read_zero():
    r = torch.tensor([1.0, 2.0, 4.0])
    rows = torch.tensor([[0, 3, 7], [-1, 2, 3]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 5.0, 5.0], [9.0, 1.0, 0.0]])
    np.testing.assert_array_equal(cg.cold_grad(r, rows, vals).numpy(),
                                  [1.0, 4.0])


def test_cpu_wrapper_leaves_launch_counter_alone():
    before = cg.cold_grad.launches
    cg.cold_grad(torch.ones(4), torch.zeros((2, 2), dtype=torch.int32),
                 torch.ones((2, 2)))
    cg.cold_grad_classes(torch.ones(4), torch.zeros(6, dtype=torch.int32),
                         torch.ones(6), cg.class_table([(1, 4), (1, 2)]))
    assert cg.cold_grad.launches == before


@pytest.mark.parametrize("case", ["r_dtype", "rows_dtype", "rows_length",
                                  "rows_shape", "vals_dtype", "vals_length",
                                  "mixed_devices", "other_device"])
def test_classes_wrapper_rejects_bad_inputs(case):
    table = cg.class_table([(2, 2), (4, 1)])
    r = torch.zeros(6)
    rows = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros(8)
    if case == "r_dtype":
        r = r.double()
    elif case == "rows_dtype":
        rows = rows.long()
    elif case == "rows_length":
        rows = torch.zeros(9, dtype=torch.int32)
    elif case == "rows_shape":
        rows = rows.view(4, 2)
    elif case == "vals_dtype":
        vals = vals.double()
    elif case == "vals_length":
        vals = torch.zeros(7)
    elif case == "mixed_devices":
        vals = vals.to("meta")
    elif case == "other_device":
        r, rows, vals = (t.to("meta") for t in (r, rows, vals))
    with pytest.raises(ValueError, match="cold_grad"):
        cg.cold_grad_classes(r, rows, vals, table)


@pytest.mark.parametrize("case", ["r_dtype", "r_shape", "rows_dtype",
                                  "rows_shape", "vals_dtype", "vals_shape",
                                  "mixed_devices", "other_device"])
def test_wrapper_rejects_bad_inputs(case):
    r = torch.zeros(6)
    rows = torch.zeros((4, 2), dtype=torch.int32)
    vals = torch.zeros((4, 2))
    if case == "mixed_devices":
        vals = vals.to("meta")
    elif case == "other_device":
        r, rows, vals = (t.to("meta") for t in (r, rows, vals))
    elif case == "r_dtype":
        r = r.double()
    elif case == "r_shape":
        r = torch.zeros((6, 1))
    elif case == "rows_dtype":
        rows = rows.long()
    elif case == "rows_shape":
        rows = torch.zeros(8, dtype=torch.int32)
    elif case == "vals_dtype":
        vals = vals.double()
    elif case == "vals_shape":
        vals = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="cold_grad"):
        cg.cold_grad(r, rows, vals)


def test_kernel_matches_plain_on_cuda():
    """On a card: the kernel against its plain version on every class
    width, within TOL and each column within 1e-5 · Σ|terms| of its exact
    sum, bit-exact on integer inputs, the same bits on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cold_grad kernel has no CPU "
                    "mode (chip_smoke.py holds it on the card)")
    rng = np.random.default_rng(11)
    n = 50_000
    for C, L, integer in ((4000, 1, False), (900, 16, False),
                          (60, 1024, False), (500, 64, True)):
        rows, vals = _class(rng, n, C, L, 0.8, integer)
        r = (rng.integers(-4, 5, n) if integer
             else rng.normal(size=n)).astype(np.float32)
        rr, ii, vv = (torch.from_numpy(a).cuda() for a in (r, rows, vals))
        got = cg.cold_grad(rr, ii, vv)
        again = cg.cold_grad(rr, ii, vv)
        want = cg.cold_grad_reference(rr, ii, vv)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if integer:
            assert torch.equal(got, want)
        g = torch.cat([rr, rr.new_zeros(1)]).double()[
            ii.long().clamp(max=n)]
        exact = (g * vv.double()).sum(1)
        mag = (g.abs() * vv.double().abs()).sum(1)
        assert bool(((got.double() - exact).abs() <= 1e-5 * mag).all())


def test_classes_kernel_matches_plain_on_cuda():
    """On a card: one launch a call over a layout of every class width
    (aligned, and shifted off 16 bytes so the kernel takes its scalar
    loads): each column within 1e-5 · Σ|terms| of its exact sum, the
    same bits on two launches and with either load width, bit-exact
    against the plain version on integer inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cold_grad kernel has no CPU "
                    "mode (chip_smoke.py holds it on the card)")
    rng = np.random.default_rng(12)
    n = 50_000
    shapes = [(7, 4096), (30, 1024), (90, 256), (400, 64), (900, 16),
              (3000, 4), (2000, 2), (5000, 1), (10, 3), (5, 0)]
    for integer in (False, True):
        classes = [_class(rng, n, C, L, 0.8, integer) for C, L in shapes]
        rows, vals, table = _flat(classes)
        r = (rng.integers(-4, 5, n) if integer
             else rng.normal(size=n)).astype(np.float32)
        rr, ii, vv = (t.cuda() for t in (torch.from_numpy(r), rows, vals))
        before = cg.cold_grad.launches
        got = cg.cold_grad_classes(rr, ii, vv, table)
        assert cg.cold_grad.launches == before + 1
        again = cg.cold_grad_classes(rr, ii, vv, table)
        # The same layout one slot off a 16-byte boundary.
        ii1 = torch.cat([ii.new_zeros(1), ii])[1:]
        vv1 = torch.cat([vv.new_zeros(1), vv])[1:]
        unaligned = cg.cold_grad_classes(rr, ii1, vv1, table)
        want = cg.cold_grad_classes_reference(rr, ii, vv, table)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, unaligned)
        if integer:
            assert torch.equal(got, want)
        for a, b, o in zip(cg.class_views(ii, table),
                           cg.class_views(vv, table), table.out_offsets):
            g = torch.cat([rr, rr.new_zeros(1)]).double()[
                a.long().clamp(max=n)]
            exact = (g * b.double()).sum(1)
            mag = (g.abs() * b.double().abs()).sum(1)
            part = got[o:o + a.shape[0]].double()
            assert bool(((part - exact).abs() <= 1e-5 * mag).all())
