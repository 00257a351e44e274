"""The row-streamed sparse path against the reference: staging, the chunk
store, the streamed passes and the host-driven L-BFGS/OWL-QN.

Staging is host numpy with the reference's own calls, so the staged
chunks equal the reference's bit for bit (float32 and int8, serial and
threaded, with a short tail chunk). A chunk store written by either
package loads in the other, bit-stable. The streamed value, gradient and
margins (the plain kernels on the CPU) agree with the reference's within
rtol 1e-5. ``minimize_streaming`` takes the reference's iterations and
lands within 5e-3 of its coefficients (the band for full solves), and a
resume from a snapshot replays the uninterrupted run bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.ops import losses
from photon_ml_torch.ops import streaming_sparse as ss
from photon_ml_torch.optim import OptimizerConfig, minimize_streaming
from photon_ml_torch.optim.regularization import with_l2, with_l2_value
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops import streaming_sparse as ref_ss
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.streaming import \
    minimize_streaming as ref_minimize_streaming

N, DIM, NNZ, CHUNK = 700, 96, 5, 256
RTOL = 1e-5
TOL = 5e-3
NOT_PORTED = type(not_ported("x", 0))


@pytest.fixture(scope="module")
def batch():
    """700 rows over 256-row chunks: the last chunk is short (188 rows)."""
    return ref_sparse.synthetic_sparse(N, DIM, NNZ, seed=3)[0]


def _raw_chunks(batch, make, chunk_rows=CHUNK, offsets=None):
    arrays = {name: np.asarray(getattr(batch, name)) for name in
              ("indices", "values", "labels", "weights", "offsets")}
    if offsets is not None:
        arrays["offsets"] = offsets
    for lo in range(0, N, chunk_rows):
        yield make(**{k: v[lo:lo + chunk_rows] for k, v in arrays.items()},
                   num_features=DIM)


def _stage(batch, dtype="float32", num_hot=16, workers=1, offsets=None):
    ref = ref_ss.build_chunked(
        _raw_chunks(batch, ref_sparse.SparseBatch, offsets=offsets), DIM,
        CHUNK, num_hot=num_hot, feature_dtype=dtype)
    port = ss.build_chunked(
        _raw_chunks(batch, ss._RawChunk, offsets=offsets), DIM, CHUNK,
        num_hot=num_hot, feature_dtype=dtype, workers=workers)
    return ref, port


def _assert_same_chunks(ref, port):
    """Every field of every chunk equal in dtype and bits (either side
    may hold numpy arrays or CPU tensors)."""
    assert (port.num_rows, port.chunk_rows, port.num_chunks) == \
        (ref.num_rows, ref.chunk_rows, ref.num_chunks)
    for rc, pc in zip(ref.chunks, port.chunks):
        assert pc.num_features == rc.num_features
        for name in ss._CHUNK_FIELDS:
            want, got = getattr(rc, name), getattr(pc, name)
            if want is None:
                assert got is None, name
                continue
            want, got = np.asarray(want), np.asarray(got)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("num_hot", [16, DIM])
def test_build_chunked_bit_identical(batch, dtype, workers, num_hot):
    """num_hot = d puts H above the live column count of each chunk, so
    hot_cols ends in sentinel columns."""
    ref, port = _stage(batch, dtype, num_hot, workers)
    assert port.num_rows == N and port.num_chunks == 3
    _assert_same_chunks(ref, port)
    if num_hot == DIM:
        assert bool((port.chunks[-1].hot_cols == DIM).any())
    assert ss.chunk_dtype(port.chunks[0]) == dtype
    assert len({ch.structure() for ch in port.chunks}) == 1


def test_build_chunked_rejects_bad_streams(batch):
    chunks = list(_raw_chunks(batch, ss._RawChunk))
    with pytest.raises(ValueError, match="only the final chunk"):
        ss.build_chunked([chunks[2], chunks[0]], DIM, CHUNK)
    with pytest.raises(ValueError, match="rows > chunk_rows"):
        ss.build_chunked(chunks, DIM, 100)
    with pytest.raises(ValueError, match="empty"):
        ss.build_chunked([], DIM, CHUNK)
    with pytest.raises(ValueError, match="feature_dtype"):
        ss.build_chunked(chunks, DIM, CHUNK, feature_dtype="float16")
    with pytest.raises(ValueError, match="feature_dtype"):
        ss.feature_dtype_name("float16")


def test_quantizers_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 17)).astype(np.float32)
    x[3] = 0.0
    for got, want in zip(ss.quantize_rows_int8(x),
                         ref_ss.quantize_rows_int8(x)):
        np.testing.assert_array_equal(got, want)
    assert ss.plan_num_hot(1 << 18, 1 << 27, "int8") == \
        ref_ss.plan_num_hot(1 << 18, 1 << 27, "int8")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_chunk_store_crosses_packages_both_ways(batch, tmp_path, dtype):
    ref, port = _stage(batch, dtype)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ss.save_chunked(ref_dir, ref)
    ss.save_chunked(port_dir, port)
    _assert_same_chunks(ref, ss.load_chunked(ref_dir))
    _assert_same_chunks(ref, ref_ss.load_chunked(port_dir))
    # The reference reading its own store is the yardstick of the above.
    _assert_same_chunks(ref_ss.load_chunked(ref_dir),
                        ss.load_chunked(port_dir))


def test_corrupt_chunk_restages_exactly_that_chunk(batch, tmp_path):
    ref, port = _stage(batch, "int8")
    directory = str(tmp_path / "store")
    ss.save_chunked(directory, port)
    path = os.path.join(directory, "chunk_1.npz")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ss.ChunkStoreError, match="chunk 1"):
        ss.load_chunked(directory)
    raws = list(_raw_chunks(batch, ss._RawChunk))
    rebuilt = []

    def rebuild(i):
        rebuilt.append(i)
        return ss._build_canonical(raws[i], DIM, 16, "int8")

    _assert_same_chunks(ref, ss.load_chunked(directory, rebuild=rebuild))
    assert rebuilt == [1]


def _inputs(seed, offsets):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=DIM).astype(np.float32)
    off = (rng.normal(size=3 * CHUNK).astype(np.float32) * 0.5
           if offsets else None)
    return w, off


@pytest.mark.parametrize("pinned", [0, 2])
@pytest.mark.parametrize("offsets", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_streamed_passes_match_reference(batch, dtype, offsets, pinned):
    staged_off = np.asarray(batch.offsets) + 0.25  # staged offsets in use
    ref, port = _stage(batch, dtype, offsets=staged_off)
    w, off = _inputs(7, offsets)
    jw = jnp.asarray(w)
    joff = None if off is None else jnp.asarray(off)
    tw = torch.from_numpy(w)
    toff = None if off is None else torch.from_numpy(off)
    stream = ss.ChunkStream(port, "cpu", 2,
                            ss.pin_chunks(port, pinned, "cpu"))
    vr, gr = ref_ss.make_value_and_gradient(ref_losses.LOGISTIC, ref)(jw,
                                                                      joff)
    vp, gp = ss.make_value_and_gradient(losses.LOGISTIC, port,
                                        stream=stream)(tw, toff)
    assert vp.shape == () and gp.shape == (DIM,)
    np.testing.assert_allclose(float(vp), float(vr), rtol=RTOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gr), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(gr)).max())
    v_only = ss.make_value_only(losses.LOGISTIC, port, stream=stream)
    np.testing.assert_allclose(float(v_only(tw, toff)), float(vr),
                               rtol=RTOL)
    zr = np.asarray(ref_ss.margins_chunked(ref, jw, joff))
    zp = ss.margins_chunked(port, tw, toff, stream=stream).numpy()
    assert zp.shape == (N,)
    np.testing.assert_allclose(zp, zr, rtol=RTOL,
                               atol=RTOL * np.abs(zr).max())
    # Three passes, each delivering the streamed (unpinned) chunks.
    assert stream.passes == {"value_grad": 1, "value": 1, "margins": 1}
    streamed = port.chunks[pinned:]
    assert stream.chunks_moved == 3 * len(streamed)
    assert stream.bytes_moved == 3 * sum(ss._chunk_nbytes(c)
                                         for c in streamed)


def test_stream_refuses_zero_depth(batch):
    _, port = _stage(batch)
    with pytest.raises(ValueError, match="prefetch_depth"):
        ss.ChunkStream(port, "cpu", 0)


def _objectives(batch, l2, module, chunked, **kw):
    """(value_and_grad, value_only) with 0.5·l2·‖w‖² over one package's
    streamed passes."""
    if module is ss:
        vg = ss.make_value_and_gradient(losses.LOGISTIC, chunked, **kw)
        v = ss.make_value_only(losses.LOGISTIC, chunked, **kw)
        return (with_l2(lambda w: vg(w), l2),
                with_l2_value(lambda w: v(w), l2))
    vg = ref_ss.make_value_and_gradient(ref_losses.LOGISTIC, chunked)
    v = ref_ss.make_value_only(ref_losses.LOGISTIC, chunked)

    def vg_l2(w):
        f, g = vg(w)
        return f + 0.5 * l2 * jnp.sum(w * w), g + l2 * w

    return vg_l2, (lambda w: v(w) + 0.5 * l2 * jnp.sum(w * w))


@pytest.mark.parametrize("l1", [0.0, 2.0])
def test_minimize_streaming_matches_reference(batch, l1):
    """L-BFGS (l1 = 0) and OWL-QN (l1 > 0): the same iteration count and
    coefficients within TOL of the reference's streamed solve. Tolerance
    1e-6 stops both on a relative change well above float32 rounding; at
    1e-9 the test compares changes of a few ulps, and where each stops
    depends on the last bits of the sums."""
    ref, port = _stage(batch)
    l2 = 1.0 if l1 == 0.0 else 0.1
    rvg, rv = _objectives(batch, l2, ref_ss, ref)
    pvg, pv = _objectives(batch, l2, ss, port, device="cpu")
    rl1 = None if l1 == 0.0 else jnp.full((DIM,), l1, jnp.float32)
    pl1 = None if l1 == 0.0 else torch.full((DIM,), l1)
    r_ref = ref_minimize_streaming(
        rvg, jnp.zeros((DIM,), jnp.float32),
        RefOptimizerConfig(max_iterations=60, tolerance=1e-6),
        value_only=rv, l1_weights=rl1)
    r_port = minimize_streaming(
        pvg, torch.zeros(DIM), OptimizerConfig(max_iterations=60,
                                               tolerance=1e-6),
        value_only=pv, l1_weights=pl1)
    assert int(r_port.iterations) == int(r_ref.iterations)
    assert bool(r_port.converged) == bool(r_ref.converged)
    np.testing.assert_allclose(r_port.w.numpy(), np.asarray(r_ref.w),
                               rtol=TOL, atol=TOL)
    if l1:
        np.testing.assert_array_equal(r_port.w.numpy() == 0,
                                      np.asarray(r_ref.w) == 0)


@pytest.mark.parametrize("l1", [0.0, 0.5])
def test_resume_from_snapshot_is_bit_identical(batch, l1):
    _, port = _stage(batch, "int8")
    vg, v = _objectives(batch, 0.1, ss, port, device="cpu")
    l1w = None if l1 == 0.0 else torch.full((DIM,), l1)
    cfg = OptimizerConfig(max_iterations=12, tolerance=1e-12)
    snaps = []
    full = minimize_streaming(vg, torch.zeros(DIM), cfg, value_only=v,
                              l1_weights=l1w,
                              checkpoint_save=snaps.append)
    assert int(full.iterations) == 12 and len(snaps) == 12
    snap = snaps[4]
    assert int(snap["it"]) == 5
    # A copy of the snapshot, as a saved and reloaded one would be.
    saved = {k: np.array(val, copy=True) for k, val in snap.items()}
    resumed = minimize_streaming(vg, torch.zeros(DIM), cfg, value_only=v,
                                 l1_weights=l1w, resume_state=saved)
    assert torch.equal(resumed.w, full.w)
    assert float(resumed.value) == float(full.value)
    np.testing.assert_array_equal(resumed.value_history.numpy(),
                                  full.value_history.numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        minimize_streaming(vg, torch.zeros(DIM),
                           OptimizerConfig(history_length=4),
                           resume_state=snap)

