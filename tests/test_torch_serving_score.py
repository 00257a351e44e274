"""serving_score: the port's plain version against the reference kernel.

The plain version (what the wrapper runs on CPU tensors) is held against
both ``score_rows_xla`` and ``score_rows_pallas`` in interpret mode.
Integer features with power-of-two scales over int8 codes make every
partial sum exact, so those agree bit for bit; random f32 agrees to
rtol 1e-6, the summation order being the only difference. The Hopper
kernel itself runs only on a CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.ops.kernels import serving_score as ss
from photon_ml_tpu.ops.kernels import serving_score as ref


def _exact_inputs(rng, n=20, d=30, E=8):
    mat = rng.integers(-4, 5, (n, d)).astype(np.float32)
    slots = rng.integers(0, E, n).astype(np.int32)
    cache = rng.integers(-127, 128, (E, d)).astype(np.int8)
    scale = (2.0 ** rng.integers(-20, 10, E)).astype(np.float32)
    return mat, slots, cache, scale


def _port(mat, slots, cache, scale):
    return ss.score_rows(torch.from_numpy(mat), torch.from_numpy(slots),
                         torch.from_numpy(cache),
                         None if scale is None else torch.from_numpy(scale)
                         ).numpy()


def _jax(fn, mat, slots, cache, scale, **kw):
    return np.asarray(fn(jnp.asarray(mat), jnp.asarray(slots),
                         jnp.asarray(cache),
                         None if scale is None else jnp.asarray(scale), **kw))


def test_int8_bit_exact_against_xla_and_pallas():
    mat, slots, cache, scale = _exact_inputs(np.random.default_rng(3))
    got = _port(mat, slots, cache, scale)
    np.testing.assert_array_equal(got, _jax(ref.score_rows_xla, mat, slots,
                                            cache, scale))
    np.testing.assert_array_equal(got, _jax(ref.score_rows_pallas, mat,
                                            slots, cache, scale,
                                            interpret=True))


@pytest.mark.parametrize("with_scale", [False, True])
def test_f32_cache_matches_reference(with_scale):
    rng = np.random.default_rng(4)
    mat = rng.normal(size=(20, 30)).astype(np.float32)
    slots = rng.integers(0, 8, 20).astype(np.int32)
    cache = rng.normal(size=(8, 30)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 8).astype(np.float32) if with_scale \
        else None
    got = _port(mat, slots, cache, scale)
    for want in (_jax(ref.score_rows_xla, mat, slots, cache, scale),
                 _jax(ref.score_rows_pallas, mat, slots, cache, scale,
                      interpret=True)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_zero_rows_and_fallback_slot_are_exactly_zero():
    rng = np.random.default_rng(5)
    mat = rng.normal(size=(6, 12)).astype(np.float32)
    cache = np.zeros((3, 12), np.int8)
    scale = np.full(3, 0.37, np.float32)
    np.testing.assert_array_equal(
        _port(mat, np.zeros(6, np.int32), cache, scale), np.zeros(6))
    # The fallback row: codes 0 and scale 0 (int8), zeros (f32).
    cache8 = rng.integers(-127, 128, (4, 12)).astype(np.int8)
    cache8[3] = 0
    scale8 = np.array([1.0, 0.5, 2.0, 0.0], np.float32)
    slots = np.array([3, 0, 3, 1, 3, 2], np.int32)
    got = _port(mat, slots, cache8, scale8)
    np.testing.assert_array_equal(got[slots == 3], 0.0)
    assert np.all(got[slots != 3] != 0.0)
    cache32 = rng.normal(size=(4, 12)).astype(np.float32)
    cache32[3] = 0.0
    np.testing.assert_array_equal(
        _port(mat, slots, cache32, None)[slots == 3], 0.0)


def test_out_of_range_slots_clamp_like_pallas():
    mat, _, cache, scale = _exact_inputs(np.random.default_rng(6), n=8, E=5)
    slots = np.array([-7, -1, 0, 4, 5, 99, 2, 2**30], np.int32)
    got = _port(mat, slots, cache, scale)
    np.testing.assert_array_equal(got, _jax(ref.score_rows_pallas, mat,
                                            slots, cache, scale,
                                            interpret=True))
    clamped = np.clip(slots, 0, 4)
    np.testing.assert_array_equal(got, _port(mat, clamped, cache, scale))


def test_cpu_wrapper_leaves_launch_counter_alone():
    before = ss.score_rows.launches
    mat, slots, cache, scale = _exact_inputs(np.random.default_rng(7))
    _port(mat, slots, cache, scale)
    _port(mat, slots, cache.astype(np.float32), None)
    assert ss.score_rows.launches == before


@pytest.mark.parametrize("case", ["mat_dtype", "slots_dtype", "cache_dtype",
                                  "width", "int8_no_scale", "scale_shape",
                                  "noncontiguous", "mixed_device"])
def test_wrapper_rejects_bad_inputs(case):
    mat, slots, cache, scale = (torch.from_numpy(a) for a in _exact_inputs(
        np.random.default_rng(8)))
    if case == "mat_dtype":
        mat = mat.double()
    elif case == "slots_dtype":
        slots = slots.long()
    elif case == "cache_dtype":
        cache = cache.to(torch.int16)
    elif case == "width":
        cache = cache[:, :-1].contiguous()
    elif case == "int8_no_scale":
        scale = None
    elif case == "scale_shape":
        scale = scale[:-1]
    elif case == "noncontiguous":
        mat = torch.cat([mat, mat], dim=1)[:, ::2]
    elif case == "mixed_device":
        cache = cache.to("meta")
    with pytest.raises(ValueError):
        ss.score_rows(mat, slots, cache, scale)


def test_kernel_matches_plain_on_cuda():
    """The Hopper kernel against the plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    mat, slots, cache, scale = (torch.from_numpy(a).to(dev)
                                for a in _exact_inputs(rng, n=100, d=40))
    before = ss.score_rows.launches
    got = ss.score_rows(mat, slots, cache, scale)
    torch.cuda.synchronize()
    assert ss.score_rows.launches == before + 1
    assert torch.equal(got, ss.score_rows_reference(mat, slots, cache,
                                                    scale))
    cache32 = torch.randn(8, 40, device=dev)
    mat32 = torch.randn(100, 40, device=dev)
    np.testing.assert_allclose(
        ss.score_rows(mat32, slots, cache32).cpu().numpy(),
        ss.score_rows_reference(mat32, slots, cache32, None).cpu().numpy(),
        rtol=1e-5, atol=1e-5)
