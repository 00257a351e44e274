"""stream_fused: the streamed chunk's hot-tier kernels against the reference.

The plain versions (what the wrappers run on CPU tensors) are held against
``hot_margins_pallas``/``hot_rmatvec_pallas`` in interpret mode and
against ``hot_*_xla`` for float32 and int8 codes: each output within
1e-5 of its Σ|terms| of the exact (float64) value, and ``parity_rel``
(max |a − b| / max |b|, the docs/KERNELS.md gate) within 1e-3. bfloat16
codes are held against the interpret path only: the reference's unfused
path rounds the weights to bfloat16 as well, the Pallas kernel does not,
and the port follows the Pallas kernel. Integer-valued fixtures, where
every partial sum is exact, agree bit for bit. The kernels themselves
run only on a CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.ops.kernels import stream_fused as sf
from photon_ml_tpu.ops.kernels import stream_fused as ref

PARITY_REL = 1e-3
TERM_TOL = 1e-5
DTYPES = ("float32", "int8", "bfloat16")


def _codes(rng, n, h, dtype, integer=False, zero_tail=0):
    """(X as float32 values, X in the storage dtype for torch and JAX):
    60% zeros, like a hot block's tail columns; ``zero_tail`` all-zero
    rows at the end, like a padded chunk's."""
    if integer:
        x = rng.integers(-8, 9, (n, h)).astype(np.float32)
    elif dtype == "int8":
        x = rng.integers(-127, 128, (n, h)).astype(np.float32)
    else:
        x = rng.normal(size=(n, h)).astype(np.float32)
    x[rng.random((n, h)) < 0.6] = 0.0
    if zero_tail:
        x[n - zero_tail:] = 0.0
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        return xt.float().numpy(), xt, jnp.asarray(x).astype(jnp.bfloat16)
    np_dtype = np.int8 if dtype == "int8" else np.float32
    xc = x.astype(np_dtype)
    return x, torch.from_numpy(xc), jnp.asarray(xc)


def _vec(rng, size, integer=False):
    if integer:
        return rng.integers(-4, 5, size).astype(np.float32)
    return rng.normal(size=size).astype(np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-9) \
        if want.size else 0.0


def _within_terms(got, exact, mag):
    return bool(np.all(np.abs(got.astype(np.float64) - exact)
                       <= TERM_TOL * mag))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h", [(1000, 37), (300, 600), (257, 512)])
def test_margins_plain_matches_pallas_and_xla(dtype, n, h):
    rng = np.random.default_rng(n * h)
    x, xt, xj = _codes(rng, n, h, dtype, zero_tail=5)
    w, base = _vec(rng, h), _vec(rng, n)
    got = sf.hot_margins(xt, torch.from_numpy(w),
                         torch.from_numpy(base)).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    x64 = x.astype(np.float64)
    exact = x64 @ w + base
    assert _within_terms(got, exact, np.abs(x64) @ np.abs(w) + np.abs(base))
    # The zero rows of the tail give base back exactly.
    np.testing.assert_array_equal(got[-5:], base[-5:])
    pallas = np.asarray(ref.hot_margins_pallas(
        xj, jnp.asarray(w), jnp.asarray(base), interpret=True))
    assert _rel(got, pallas) <= PARITY_REL
    if dtype != "bfloat16":
        xla = np.asarray(ref.hot_margins_xla(xj, jnp.asarray(w),
                                             jnp.asarray(base)))
        assert _rel(got, xla) <= PARITY_REL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h", [(1000, 37), (300, 600), (1030, 512)])
def test_rmatvec_plain_matches_pallas_and_xla(dtype, n, h):
    rng = np.random.default_rng(n + h)
    x, xt, xj = _codes(rng, n, h, dtype, zero_tail=7)
    r = _vec(rng, n)
    r[-7:] = 0.0  # padded rows carry no row term
    got = sf.hot_rmatvec(xt, torch.from_numpy(r)).numpy()
    assert got.shape == (h,) and got.dtype == np.float32
    x64 = x.astype(np.float64)
    assert _within_terms(got, r @ x64, np.abs(r) @ np.abs(x64))
    pallas = np.asarray(ref.hot_rmatvec_pallas(xj, jnp.asarray(r),
                                               interpret=True))
    assert _rel(got, pallas) <= PARITY_REL
    if dtype != "bfloat16":
        xla = np.asarray(ref.hot_rmatvec_xla(xj, jnp.asarray(r)))
        assert _rel(got, xla) <= PARITY_REL


@pytest.mark.parametrize("dtype", DTYPES)
def test_integer_fixture_bit_exact(dtype):
    """Integer codes, weights, bases and row terms: every partial sum is
    exact in float32, so the plain version, the Pallas program and the
    float64 sum agree bit for bit."""
    rng = np.random.default_rng(17)
    n, h = 700, 45
    x, xt, xj = _codes(rng, n, h, dtype, integer=True)
    w, base, r = _vec(rng, h, True), _vec(rng, n, True), _vec(rng, n, True)
    m = sf.hot_margins(xt, torch.from_numpy(w), torch.from_numpy(base))
    g = sf.hot_rmatvec(xt, torch.from_numpy(r))
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(m.numpy(), (x64 @ w + base).astype(
        np.float32))
    np.testing.assert_array_equal(g.numpy(), (r @ x64).astype(np.float32))
    np.testing.assert_array_equal(m.numpy(), np.asarray(
        ref.hot_margins_pallas(xj, jnp.asarray(w), jnp.asarray(base),
                               interpret=True)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(
        ref.hot_rmatvec_pallas(xj, jnp.asarray(r), interpret=True)))


def test_bfloat16_weights_stay_float32():
    """The kernel multiplies by the float32 weights it is given (the
    Pallas kernel's contract); the routes round them to bfloat16 before
    the call, as the reference's default route does, and that gives
    other numbers than unrounded weights."""
    rng = np.random.default_rng(3)
    x, xt, _ = _codes(rng, 64, 32, "bfloat16")
    w = _vec(rng, 32)
    base = np.zeros(64, np.float32)
    got = sf.hot_margins(xt, torch.from_numpy(w),
                         torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64) @ w, rtol=1e-5,
                               atol=1e-5)
    w16 = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    assert np.abs(got - x.astype(np.float64) @ w16).max() > 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_shapes(dtype):
    rng = np.random.default_rng(0)
    _, xt, _ = _codes(rng, 0, 16, dtype)
    assert sf.hot_margins(xt, torch.zeros(16), torch.zeros(0)).shape == (0,)
    np.testing.assert_array_equal(
        sf.hot_rmatvec(xt, torch.zeros(0)).numpy(), np.zeros(16, np.float32))
    _, xt, _ = _codes(rng, 5, 0, dtype)
    base = torch.arange(5, dtype=torch.float32)
    assert torch.equal(sf.hot_margins(xt, torch.zeros(0), base), base)
    assert sf.hot_rmatvec(xt, torch.ones(5)).shape == (0,)


def test_cpu_wrappers_leave_launch_counters_alone():
    rng = np.random.default_rng(1)
    _, xt, _ = _codes(rng, 50, 20, "int8")
    before = (sf.hot_margins.launches, sf.hot_rmatvec.launches)
    sf.hot_margins(xt, torch.ones(20), torch.zeros(50))
    sf.hot_rmatvec(xt, torch.ones(50))
    assert (sf.hot_margins.launches, sf.hot_rmatvec.launches) == before


@pytest.mark.parametrize("case", ["x_dtype", "x_rank", "w_shape",
                                  "w_dtype", "base_shape", "r_shape",
                                  "other_device"])
def test_wrappers_reject_bad_inputs(case):
    X = torch.zeros((6, 4), dtype=torch.int8)
    w, base, r = torch.zeros(4), torch.zeros(6), torch.zeros(6)
    if case == "x_dtype":
        X = X.to(torch.int16)
    elif case == "x_rank":
        X = X.reshape(-1)
    elif case == "w_shape":
        w = torch.zeros(5)
    elif case == "w_dtype":
        w = w.double()
    elif case == "base_shape":
        base = torch.zeros(5)
    elif case == "r_shape":
        r = torch.zeros(4)
    elif case == "other_device":
        X = X.to("meta")
    with pytest.raises(ValueError):
        if case in ("r_shape",):
            sf.hot_rmatvec(X, r)
        else:
            sf.hot_margins(X, w, base)


def test_only_cpu_tensors_reach_the_plain_version():
    """Tensors off the CPU never fall back to the plain version: another
    device is refused, and on a machine without CUDA a call on CUDA
    tensors raises. No launch is counted."""
    before = (sf.hot_margins.launches, sf.hot_rmatvec.launches)
    X = torch.zeros((4, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sf.hot_margins(X, torch.zeros(2, device="meta"),
                       torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sf.hot_rmatvec(X, torch.zeros(4, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            sf.hot_margins(torch.zeros((4, 2), dtype=torch.int8,
                                       device="cuda"),
                           torch.zeros(2, device="cuda"),
                           torch.zeros(4, device="cuda"))
        with pytest.raises((RuntimeError, AssertionError)):
            sf.hot_rmatvec(torch.zeros((4, 2), device="cuda"),
                           torch.zeros(4, device="cuda"))
    assert (sf.hot_margins.launches, sf.hot_rmatvec.launches) == before


def _misaligned(X):
    """X copied 4 bytes into a larger buffer: contiguous, its base not on
    16 bytes."""
    buf = torch.empty(X.numel() + 4, dtype=X.dtype, device=X.device)
    view = buf[1:1 + X.numel()].view(X.shape)
    view.copy_(X)
    return view


@pytest.mark.parametrize("dtype,h,misaligned,want", [
    ("float32", 512, False, "ring"), ("float32", 4, False, "ring"),
    ("float32", 1772, False, "ring"),
    ("float32", sf.MAX_COLUMNS, False, "ring"),
    ("float32", 37, False, "direct"), ("float32", 6, False, "direct"),
    ("float32", 512, True, "direct"),
    ("float32", sf.MAX_COLUMNS + 4, False, "direct"),
    ("int8", 512, False, "direct"), ("bfloat16", 512, False, "direct")])
def test_route_rule(dtype, h, misaligned, want):
    """The ring takes float32 rows of whole 16-byte vectors, within the
    width limit, from a 16-byte aligned base; everything else goes
    direct. The rule reads the shape and the pointer alone."""
    X = torch.zeros((3, h), dtype=getattr(torch, dtype))
    if misaligned:
        X = _misaligned(X)
        assert X.is_contiguous() and X.data_ptr() % 16 == 4
    assert sf.route(X) == want


def test_ring_shape_fits_a_block():
    """Every width the ring takes gets a geometry the kernels accept, for
    either kernel's ring: 1 to 8 rows a tile dividing the 512-row group,
    2 to 8 tiles, and dynamic shared memory within a block's."""
    for stages in (sf.MARGINS_STAGES, sf.RMATVEC_STAGES):
        for h in range(4, sf.MAX_COLUMNS + 1, 4):
            rows, got = sf.ring_shape(h, stages)
            assert 1 <= rows <= sf.MAX_ROWS and sf.ROW_GROUP % rows == 0, h
            assert got == stages and 2 <= got <= sf.MAX_STAGES, h
            assert sf.shared_bytes(h, rows, got) <= sf.MAX_SHARED, h
    # The streamed chunk, the hybrid block, the limit.
    for h, margins, rmatvec in ((512, (8, 3), (8, 2)),
                                (1772, (8, 3), (8, 2)),
                                (sf.MAX_COLUMNS, (2, 3), (2, 2))):
        assert sf.ring_shape(h, sf.MARGINS_STAGES) == margins
        assert sf.ring_shape(h, sf.RMATVEC_STAGES) == rmatvec


@pytest.mark.parametrize("n,groups", [(1, 1), (511, 1), (512, 1),
                                      (513, 2), (1024, 2), (1025, 3),
                                      (262_144, 512)])
def test_partial_rows(n, groups):
    """hot_rmatvec's partial sums: one row a 512-row group, the last
    group short."""
    assert sf.partial_rows(n) == groups


def test_kernels_match_plain_on_cuda():
    """On a card: each kernel within 1e-5 of Σ|terms| of its exact value
    and within PARITY_REL of its plain version, bit-exact on integer
    fixtures, the same bits on two launches, for every storage dtype and
    a ragged shape; float32 blocks on both routes (fewer rows than a
    tile, rows not a multiple of 512, a width for each instantiation of
    the ring's rmatvec kernel, the widest ring rows and beyond), and the
    ring's hot_margins bit for bit the direct route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream_fused kernels have no "
                    "CPU mode (chip_smoke.py holds them on the card)")
    rng = np.random.default_rng(5)
    cases = [(dtype, shape, integer) for dtype in DTYPES
             for shape, integer in (((4097, 512), False),
                                    ((1000, 37), False),
                                    ((2048, 96), True))]
    cases += [("float32", shape, False) for shape in (
        (5, 512), (1000, 512), (1003, 64), (1003, 96), (1030, 192),
        (1030, 516), (1030, 1772), (777, 4000), (1027, sf.MAX_COLUMNS),
        (515, sf.MAX_COLUMNS + 4))]
    for dtype, (n, h), integer in cases:
        x, xt, _ = _codes(rng, n, h, dtype, integer=integer)
        w, base, r = (_vec(rng, s, integer) for s in (h, n, n))
        X = xt.cuda()
        wt, bt, rt = (torch.from_numpy(a).cuda() for a in (w, base, r))
        routes = [X]
        if dtype == "float32" and h % 4 == 0 and h <= sf.MAX_COLUMNS:
            assert sf.route(X) == "ring"
            routes.append(_misaligned(X))
            assert sf.route(routes[-1]) == "direct"
        ring_m = None
        for X in routes:
            m1, m2 = sf.hot_margins(X, wt, bt), sf.hot_margins(X, wt, bt)
            g1, g2 = sf.hot_rmatvec(X, rt), sf.hot_rmatvec(X, rt)
            torch.cuda.synchronize()
            assert torch.equal(m1, m2) and torch.equal(g1, g2)
            if ring_m is None:
                ring_m = m1
            else:  # the direct route gives the ring's margins bits
                assert torch.equal(m1, ring_m)
            x64 = x.astype(np.float64)
            m, g = m1.cpu().numpy(), g1.cpu().numpy()
            assert _within_terms(m, x64 @ w + base,
                                 np.abs(x64) @ np.abs(w) + np.abs(base))
            assert _within_terms(g, r @ x64, np.abs(r) @ np.abs(x64))
            pm = sf.hot_margins_reference(X, wt, bt).cpu().numpy()
            pg = sf.hot_rmatvec_reference(X, rt).cpu().numpy()
            assert _rel(m, pm) <= PARITY_REL and _rel(g, pg) <= PARITY_REL
            if integer:
                np.testing.assert_array_equal(m, pm)
                np.testing.assert_array_equal(g, pg)
