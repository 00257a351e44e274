"""cold_grad: the hybrid layout's cold-class gradient against the reference.

The plain version (what the wrapper runs on CPU tensors) is held, class
by class, against the JAX package's two-pass XLA form
(``photon_ml_tpu/ops/hybrid_sparse._cold_grad``) and against the TPU
kernel the port replaces, ``fused_cold_grad`` of
``dev-scripts/exp_cold_gather.py``, in interpret mode: within 1e-6
(float32 sums of the same terms in another order), and bit for bit on
integer-valued inputs. Also: the L = 1 class, an all-padding class,
squared values (the Hessian diagonal's use), ids outside [0, n), the
wrapper's input checks, and that the CPU path leaves the launch count
alone. The kernel itself runs only on a CUDA card.
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
    assert cg.cold_grad.launches == before


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
