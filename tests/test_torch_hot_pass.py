"""hot_pass: the hybrid hot block's one-pass value-and-gradient and H·v.

On CPU tensors the wrappers run their plain versions, which must equal
the two-kernel route they replace bit for bit (``stream_fused``'s plain
margins, the loss's torch functions, its plain transposed product), for
every loss, with and without a cold term, at a ragged and a wider hot
block, over float32 and over bfloat16 blocks (whose route rounds r to
bfloat16 before the transposed product, and is given w and v already
rounded). ``hybrid_sparse.value_and_gradient`` and ``hessian_vector``, now
routed through them, must give the bits of that route too, and match
the JAX package's ``photon_ml_tpu.ops.hybrid_sparse`` within the band of
``tests/test_torch_hybrid_sparse.py``: rtol 1e-5, and an absolute floor
of 1e-5 of the largest entry (float32 sums in another order). The
bit-for-bit comparisons run on one CPU thread: a threaded CPU
matrix-vector product may split its sums differently from one call to
the next under load. The kernel runs only on a CUDA card: its cases
skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import sparse
from photon_ml_torch.ops import hybrid_sparse as hs
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.kernels import hot_pass as hp
from photon_ml_torch.ops.kernels import stream_fused as sf
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.ops import hybrid_sparse as ref_hs
from photon_ml_tpu.ops import losses as ref_losses

RTOL = 1e-5
PARITY_REL = 1e-3
TERM_TOL = 1e-5
N, DIM, NNZ = 3000, 600, 16
LOSSES = {"logistic": (losses.LOGISTIC, ref_losses.LOGISTIC),
          "squared": (losses.SQUARED, ref_losses.SQUARED),
          "poisson": (losses.POISSON, ref_losses.POISSON),
          "smoothed_hinge": (losses.SMOOTHED_HINGE,
                             ref_losses.SMOOTHED_HINGE)}
# Hybrid layouts of the same rows: 310 hot columns and 4 cold classes; 37
# hot (a ragged width, stored as 40) and 8 classes; all 595 present
# columns hot and no class; no hot block and 13 classes.
LAYOUTS = {"default": {}, "ragged hot": {"max_hot": 37, "hot_threshold": 2},
           "no cold": {"hot_threshold": 1},
           "no hot": {"hot_threshold": 10 ** 9}}


def _labels(rng, name, n):
    if name == "squared":
        return rng.normal(size=n).astype(np.float32)
    if name == "poisson":
        return rng.poisson(1.0, n).astype(np.float32)
    return (rng.random(n) < 0.3).astype(np.float32)


def _rows(rng, name, n):
    """labels, weights (some zero) and offsets for ``n`` rows."""
    y = _labels(rng, name, n)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    o = (0.2 * rng.normal(size=n)).astype(np.float32)
    return y, w, o


def _block(seed, name, n, h):
    """A hot block with 60% zeros and the vectors of one pass, as CPU
    tensors: X, w, v, offsets, cold_z, cold_zv, labels, weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    x[rng.random((n, h)) < 0.6] = 0.0
    w, v = (0.1 * rng.normal(size=(2, h))).astype(np.float32)
    y, wt, o = _rows(rng, name, n)
    cz, czv = (0.3 * rng.normal(size=(2, n))).astype(np.float32)
    t = torch.from_numpy
    return {"X": t(x), "w": t(w), "v": t(v), "offsets": t(o),
            "cold_z": t(cz), "cold_zv": t(czv), "labels": t(y),
            "weights": t(wt)}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _two_kernel_route(b, loss, cold):
    """What hybrid_sparse ran before the fused pass: hot_margins, the
    cold term, the loss in torch, hot_rmatvec."""
    cz = b["cold_z"] if cold else None
    czv = b["cold_zv"] if cold else None
    z = sf.hot_margins(b["X"], b["w"], b["offsets"])
    z = z if cz is None else z + cz
    xv = sf.hot_margins(b["X"], b["v"], b["offsets"])
    xv = (xv if czv is None else xv + czv) - b["offsets"]
    wt = b["weights"]
    _, dl = loss.loss_and_dz(z, b["labels"])
    r_g = torch.where(wt > 0.0, wt * dl, torch.zeros_like(dl))
    d2 = loss.d2z(z, b["labels"])
    r_h = torch.where(wt > 0.0, wt * d2, torch.zeros_like(d2)) * xv
    if b["X"].dtype == torch.bfloat16:  # the reference's _hot_rmatvec
        r_g, r_h = (r.to(torch.bfloat16).float() for r in (r_g, r_h))
    return z, xv, sf.hot_rmatvec(b["X"], r_g), sf.hot_rmatvec(b["X"], r_h)


def _bf16_block(seed, name, n, h):
    """_block with X stored in bfloat16 and w, v rounded to bfloat16, as
    the hybrid route hands them over."""
    b = _block(seed, name, n, h)
    for k in ("X", "w", "v"):
        b[k] = b[k].to(torch.bfloat16)
    b["w"], b["v"] = b["w"].float(), b["v"].float()
    return b


@pytest.mark.parametrize("h", [40, 600])
@pytest.mark.parametrize("cold", [True, False], ids=["cold", "no cold"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_plain_pass_equals_two_kernel_route(one_thread, name, cold, h):
    loss = LOSSES[name][0]
    b = _block(7, name, 2500, h)
    cz = b["cold_z"] if cold else None
    czv = b["cold_zv"] if cold else None
    z, xv, g, g_h = _two_kernel_route(b, loss, cold)
    fz, fg = hp.hot_value_and_gradient(b["X"], b["w"], b["offsets"], cz,
                                       b["labels"], b["weights"], loss)
    hz, hxv, hg = hp.hot_hessian_vector(
        b["X"], b["w"], b["v"], b["offsets"], cz, czv, b["labels"],
        b["weights"], loss)
    for got, want in ((fz, z), (fg, g), (hz, z), (hxv, xv), (hg, g_h)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.isfinite(fg).all() and torch.isfinite(hg).all()


@pytest.mark.parametrize("h", [40, 600])
@pytest.mark.parametrize("cold", [True, False], ids=["cold", "no cold"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_plain_bfloat16_pass_equals_rounded_route(one_thread, name, cold,
                                                  h):
    """Over a bfloat16 block: z and xv the two-kernel route's bits with
    the rounded w and v, and g that route's with r rounded to bfloat16;
    the float32-residual product is another number."""
    loss = LOSSES[name][0]
    b = _bf16_block(7, name, 2500, h)
    cz = b["cold_z"] if cold else None
    czv = b["cold_zv"] if cold else None
    z, xv, g, g_h = _two_kernel_route(b, loss, cold)
    fz, fg = hp.hot_value_and_gradient(b["X"], b["w"], b["offsets"], cz,
                                       b["labels"], b["weights"], loss)
    hz, hxv, hg = hp.hot_hessian_vector(
        b["X"], b["w"], b["v"], b["offsets"], cz, czv, b["labels"],
        b["weights"], loss)
    for got, want in ((fz, z), (fg, g), (hz, z), (hxv, xv), (hg, g_h)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    wt = b["weights"]
    _, dl = loss.loss_and_dz(z, b["labels"])
    unrounded = sf.hot_rmatvec(b["X"], torch.where(wt > 0, wt * dl,
                                                   torch.zeros_like(dl)))
    assert not torch.equal(unrounded, fg)


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layouts(request):
    """One layout of the same rows for every loss: (port, reference)."""
    b, _ = sparse.synthetic_sparse(N, DIM, NNZ, seed=2)
    idx, val = b.indices.numpy(), b.values.numpy()
    out = {}
    for name in LOSSES:
        y, w, o = _rows(np.random.default_rng(3), name, N)
        t = torch.from_numpy
        port = sparse.SparseBatch(t(idx), t(val), t(y), t(w), t(o), DIM)
        ref = ref_sparse.SparseBatch(idx, val, y, w, o, DIM)
        kw = LAYOUTS[request.param]
        out[name] = (hs.build_hybrid(port, device="cpu", **kw),
                     ref_hs.build_hybrid(ref, device=False, **kw))
    return request.param, out


def _vectors(seed):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.normal(size=DIM)).astype(np.float32),
            rng.normal(size=DIM).astype(np.float32))


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_hybrid_keeps_two_kernel_bits_on_cpu(one_thread, layouts, name):
    """value and gradient and H·v give the bits of the route before the
    fused pass: margins (hot_margins, then the cold scatter), the loss,
    then hot_rmatvec and every cold class."""
    layout, by_loss = layouts
    hb, _ = by_loss[name]
    loss = LOSSES[name][0]
    want_hot = {"default": 310, "ragged hot": 37, "no cold": 595,
                "no hot": 0}[layout]
    assert hb.num_hot == want_hot
    assert bool(hb.cold_rowids) == (layout != "no cold")
    w, v = (torch.from_numpy(a) for a in _vectors(4))

    def rowterm(r):  # hot_rmatvec + every cold class, as before
        g_hot = sf.hot_rmatvec(hb.X_hot, r) if hb.num_hot else None
        return hs._assemble_grad(hb, g_hot,
                                 hs._cold_grad(hb, r, hb.cold_flat_vals))

    z = hs.margins(hb, w)
    l, dl = loss.loss_and_dz(z, hb.labels)
    value = torch.sum(hs._masked(hb.weights, l), dim=-1)
    grad = rowterm(hs._masked(hb.weights, dl))
    xv = hs.margins(hb, v) - hb.offsets
    hv = rowterm(hs._masked(hb.weights, loss.d2z(z, hb.labels)) * xv)
    got_value, got_grad = hs.value_and_gradient(loss, w, hb)
    assert torch.equal(got_value, value) and torch.equal(got_grad, grad)
    assert torch.equal(hs.hessian_vector(loss, w, v, hb), hv)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_hybrid_matches_reference(layouts, name):
    _, by_loss = layouts
    hb, ref = by_loss[name]
    loss, ref_loss = LOSSES[name]
    w, v = _vectors(5)
    t = torch.from_numpy
    val, grad = hs.value_and_gradient(loss, t(w), hb)
    rval, rgrad = ref_hs.value_and_gradient(ref_loss, jnp.asarray(w), ref)
    np.testing.assert_allclose(float(val), float(rval), rtol=RTOL)
    _close(grad, rgrad)
    _close(hs.hessian_vector(loss, t(w), t(v), hb),
           ref_hs.hessian_vector(ref_loss, jnp.asarray(w), jnp.asarray(v),
                                 ref))


def _call(entry, b, loss=losses.LOGISTIC):
    if entry == "value_and_gradient":
        return hp.hot_value_and_gradient(
            b["X"], b["w"], b["offsets"], b["cold_z"], b["labels"],
            b["weights"], loss)
    return hp.hot_hessian_vector(
        b["X"], b["w"], b["v"], b["offsets"], b["cold_z"], b["cold_zv"],
        b["labels"], b["weights"], loss)


BAD = {
    "int8 X": lambda b: b.update(X=b["X"].to(torch.int8)),
    "bfloat16 ragged width": lambda b: b.update(
        X=b["X"][:, :4].to(torch.bfloat16), w=b["w"][:4], v=b["v"][:4]),
    "X rank": lambda b: b.update(X=b["X"].reshape(-1)),
    "ragged width": lambda b: b.update(X=b["X"][:, :6], w=b["w"][:6],
                                       v=b["v"][:6]),
    "w shape": lambda b: b.update(w=b["w"][:4]),
    "w dtype": lambda b: b.update(w=b["w"].double()),
    "v shape": lambda b: b.update(v=b["v"][:4]),
    "offsets shape": lambda b: b.update(offsets=b["offsets"][:5]),
    "cold_z shape": lambda b: b.update(cold_z=b["cold_z"][:5]),
    "cold_zv shape": lambda b: b.update(cold_zv=b["cold_zv"][:5]),
    "labels dtype": lambda b: b.update(labels=b["labels"].double()),
    "weights shape": lambda b: b.update(weights=b["weights"][:5]),
    "mixed devices": lambda b: b.update(w=b["w"].to("meta")),
    "meta device": lambda b: b.update({k: x.to("meta")
                                       for k, x in b.items()}),
}


# v and cold_zv reach the H·v entry only.
REJECTED = [(case, entry) for case in sorted(BAD)
            for entry in ("value_and_gradient", "hessian_vector")
            if entry == "hessian_vector"
            or case not in ("v shape", "cold_zv shape")]


@pytest.mark.parametrize("case, entry", REJECTED)
def test_inputs_rejected(case, entry):
    b = _block(1, "logistic", 6, 8)
    BAD[case](b)
    with pytest.raises(ValueError):
        _call(entry, b)


@pytest.mark.parametrize("entry", ["value_and_gradient", "hessian_vector"])
def test_unknown_loss_rejected(entry):
    b = _block(1, "logistic", 6, 8)
    custom = losses.PointwiseLoss(
        name="huber", loss_and_dz=losses.SQUARED.loss_and_dz,
        d2z=losses.SQUARED.d2z, mean=losses.SQUARED.mean)
    with pytest.raises(ValueError, match="huber"):
        _call(entry, b, custom)


@pytest.mark.parametrize("entry", ["value_and_gradient", "hessian_vector"])
def test_empty_block(entry):
    b = _block(1, "logistic", 0, 8)
    out = _call(entry, b)
    assert out[0].shape == (0,) and out[-1].shape == (8,)
    assert not out[-1].any()


def _counters():
    return (hp.hot_value_and_gradient.launches,
            hp.hot_hessian_vector.launches, sf.hot_margins.launches,
            sf.hot_rmatvec.launches)


def test_cpu_calls_leave_counters_alone():
    before = _counters()
    b = _block(2, "logistic", 700, 40)
    _call("value_and_gradient", b)
    _call("hessian_vector", b)
    assert _counters() == before


@pytest.mark.parametrize("hessian", [False, True])
@pytest.mark.parametrize("h", [4, 40, 1772, 4096, 8192])
def test_ring_shape_fits_a_block(h, hessian):
    rows, stages = hp.ring_shape(h, hessian)
    assert 1 <= rows <= hp.MAX_ROWS and hp.ROW_GROUP % rows == 0
    assert 2 <= stages <= hp.MAX_STAGES
    assert hp.shared_bytes(h, rows, stages, hessian) <= hp.MAX_SHARED
    if h == 1772:  # the config-5 hybrid block
        assert (rows, stages) == (8, 3)


@pytest.mark.parametrize("hessian", [False, True])
@pytest.mark.parametrize("h", [8, 40, 2984, 3016, 4096, 8192])
def test_ring_shape_fits_a_block_bfloat16(h, hessian):
    """The bfloat16 entry's shared memory: the ring's bfloat16 rows,
    bfloat16 w (and v), each slot's residuals and three mbarriers a slot
    (tile landed, residuals written, slot read). At config 5's widths
    the ring leaves room for two blocks an SM."""
    rows, stages = hp.ring_shape(h, hessian, 2)
    assert 1 <= rows <= hp.MAX_ROWS and hp.ROW_GROUP % rows == 0
    assert 2 <= stages <= hp.MAX_STAGES
    vectors = 2 if hessian else 1
    assert hp.shared_bytes(h, rows, stages, hessian, 2) == (
        stages * rows * h * 2 + vectors * h * 2
        + stages * hp.MAX_ROWS * 4 + 3 * stages * 8) <= hp.MAX_SHARED
    if h in (2984, 3016):  # config 5's bfloat16 block at 9.5M rows
        assert (rows, stages) == (8, 2)
        assert 2 * (hp.shared_bytes(h, rows, stages, hessian, 2)
                    + hp.BLOCK_RESERVED) <= hp.SM_SHARED


def _within_terms(got, exact, mag):
    return bool(np.all(np.abs(got - exact) <= TERM_TOL * mag))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_kernel_matches_plain_on_cuda(name):
    """On a card: z and xv bit for bit the two-kernel route's, g within
    1e-5 · Σ|terms| of its float64 sum and within PARITY_REL of the plain
    version, the same bits on two launches, launches counted; ragged
    row counts, three widths, with and without a cold term."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hot_pass kernel has no CPU "
                    "mode (chip_smoke.py holds it on the card)")
    loss = LOSSES[name][0]
    for n, h, cold in ((4097, 600, True), (1000, 40, False),
                       (513, 1772, True)):
        b = {k: x.cuda() for k, x in _block(9, name, n, h).items()}
        if not cold:
            b["cold_z"] = b["cold_zv"] = None
        z, xv, _, _ = _two_kernel_route(b, loss, cold)
        before = _counters()
        z1, g1 = _call("value_and_gradient", b, loss)
        z2, g2 = _call("value_and_gradient", b, loss)
        hz, hxv, hg = _call("hessian_vector", b, loss)
        torch.cuda.synchronize()
        assert _counters()[:2] == (before[0] + 2, before[1] + 1)
        assert torch.equal(z1, z) and torch.equal(z2, z)
        assert torch.equal(hz, z) and torch.equal(hxv, xv)
        assert torch.equal(g1, g2)
        _, pg = hp.hot_value_and_gradient_reference(
            b["X"], b["w"], b["offsets"], b["cold_z"], b["labels"],
            b["weights"], loss)
        *_, ph = hp.hot_hessian_vector_reference(
            b["X"], b["w"], b["v"], b["offsets"], b["cold_z"],
            b["cold_zv"], b["labels"], b["weights"], loss)
        wt, x64 = b["weights"], b["X"].double().cpu().numpy()
        _, dl = loss.loss_and_dz(z, b["labels"])
        r_g = torch.where(wt > 0, wt * dl, torch.zeros_like(dl))
        r_h = torch.where(wt > 0, wt * loss.d2z(z, b["labels"]),
                          torch.zeros_like(dl)) * xv
        for got, r, plain in ((g1, r_g, pg), (hg, r_h, ph)):
            r64 = r.double().cpu().numpy()
            assert _within_terms(got.cpu().numpy(), r64 @ x64,
                                 np.abs(r64) @ np.abs(x64))
            rel = float((got - plain).abs().max()) / max(
                float(plain.abs().max()), 1e-9)
            assert rel <= PARITY_REL


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_kernel_matches_plain_on_cuda_bfloat16(name):
    """test_kernel_matches_plain_on_cuda over bfloat16 blocks (w and v
    rounded, r rounded inside the pass): z and xv bit for bit the
    rounded route's, g within 1e-5 · Σ|terms| of the float64 sum of the
    same rounded operands. 1,029 rows end mid-tile and mid-group; 3,016
    columns are config 5's block at 9.5M rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hot_pass kernel has no CPU "
                    "mode (chip_smoke.py holds it on the card)")
    loss = LOSSES[name][0]
    for n, h, cold in ((4097, 600, True), (1000, 40, False),
                       (513, 2984, True), (1029, 3016, True),
                       (1029, 3016, False)):
        b = {k: x.cuda() for k, x in _bf16_block(9, name, n, h).items()}
        if not cold:
            b["cold_z"] = b["cold_zv"] = None
        z, xv, _, _ = _two_kernel_route(b, loss, cold)
        before = _counters()
        z1, g1 = _call("value_and_gradient", b, loss)
        z2, g2 = _call("value_and_gradient", b, loss)
        hz, hxv, hg = _call("hessian_vector", b, loss)
        torch.cuda.synchronize()
        assert _counters()[:2] == (before[0] + 2, before[1] + 1)
        assert torch.equal(z1, z) and torch.equal(z2, z)
        assert torch.equal(hz, z) and torch.equal(hxv, xv)
        assert torch.equal(g1, g2)
        _, pg = hp.hot_value_and_gradient_reference(
            b["X"], b["w"], b["offsets"], b["cold_z"], b["labels"],
            b["weights"], loss)
        *_, ph = hp.hot_hessian_vector_reference(
            b["X"], b["w"], b["v"], b["offsets"], b["cold_z"],
            b["cold_zv"], b["labels"], b["weights"], loss)
        wt, x64 = b["weights"], b["X"].double().cpu().numpy()
        _, dl = loss.loss_and_dz(z, b["labels"])
        r_g = torch.where(wt > 0, wt * dl, torch.zeros_like(dl))
        r_h = torch.where(wt > 0, wt * loss.d2z(z, b["labels"]),
                          torch.zeros_like(dl)) * xv
        r_g, r_h = (r.to(torch.bfloat16).float() for r in (r_g, r_h))
        for got, r, plain in ((g1, r_g, pg), (hg, r_h, ph)):
            r64 = r.double().cpu().numpy()
            assert _within_terms(got.cpu().numpy(), r64 @ x64,
                                 np.abs(r64) @ np.abs(x64))
            rel = float((got - plain).abs().max()) / max(
                float(plain.abs().max()), 1e-9)
            assert rel <= PARITY_REL
