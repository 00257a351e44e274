"""re_rows: the port's row movers against the reference kernels.

The plain versions (what the wrappers run on CPU tensors) are held bit
for bit against ``gather_rows_xla``/``scatter_rows_xla`` and against
``gather_rows_pallas``/``scatter_rows_pallas`` in interpret mode: both
are pure data movement. The Hopper kernels themselves run only on a
CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.ops.kernels import re_rows as rr
from photon_ml_tpu.ops.kernels import re_rows as ref


def _case(rng, d, E=40, B=24, padding="some"):
    W = rng.normal(size=(E, d)).astype(np.float32)
    rows = rng.permutation(E)[:B].astype(np.int32)  # unique, as in a wave
    if padding == "some":
        rows[rng.random(B) < 0.3] = -1
        rows[-2:] = -1  # trailing padding lanes, as bucket padding has
    elif padding == "all":
        rows[:] = -1
    vals = rng.normal(size=(B, d)).astype(np.float32)
    return W, rows, vals


CASES = [(d, padding) for d in (8, 70, 128) for padding in ("some", "all")]


@pytest.mark.parametrize("d,padding", CASES)
def test_gather_bit_exact_against_xla_and_pallas(d, padding):
    W, rows, _ = _case(np.random.default_rng(d), d, padding=padding)
    got = rr.gather_rows(torch.from_numpy(W), torch.from_numpy(rows))
    assert got.shape == (rows.shape[0], d)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.gather_rows_xla(jnp.asarray(W),
                                                    jnp.asarray(rows))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.gather_rows_pallas(
            jnp.asarray(W), jnp.asarray(rows), interpret=True)))


@pytest.mark.parametrize("d,padding", CASES)
def test_scatter_bit_exact_against_xla_and_pallas(d, padding):
    W, rows, vals = _case(np.random.default_rng(100 + d), d,
                          padding=padding)
    table = torch.from_numpy(W.copy())
    ptr = table.data_ptr()
    out = rr.scatter_rows_(table, torch.from_numpy(rows),
                           torch.from_numpy(vals))
    # In place: the same tensor comes back, and the table is updated.
    assert out is table and out.data_ptr() == ptr
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref.scatter_rows_xla(
            jnp.asarray(W), jnp.asarray(rows), jnp.asarray(vals))))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref.scatter_rows_pallas(
            jnp.asarray(W), jnp.asarray(rows), jnp.asarray(vals),
            interpret=True)))
    untouched = np.setdiff1d(np.arange(W.shape[0]), rows[rows >= 0])
    np.testing.assert_array_equal(out.numpy()[untouched], W[untouched])
    np.testing.assert_array_equal(out.numpy()[rows[rows >= 0]],
                                  vals[rows >= 0])


def test_cpu_wrappers_leave_launch_counters_alone():
    W, rows, vals = _case(np.random.default_rng(1), 8)
    before = (rr.gather_rows.launches, rr.scatter_rows_.launches)
    rr.gather_rows(torch.from_numpy(W), torch.from_numpy(rows))
    rr.scatter_rows_(torch.from_numpy(W), torch.from_numpy(rows),
                     torch.from_numpy(vals))
    assert (rr.gather_rows.launches, rr.scatter_rows_.launches) == before


@pytest.mark.parametrize("case", ["W_dtype", "rows_dtype", "vals_shape",
                                  "id_too_large", "id_below_padding",
                                  "noncontiguous", "mixed_device"])
def test_wrappers_reject_bad_inputs(case):
    W, rows, vals = (torch.from_numpy(a) for a in _case(
        np.random.default_rng(2), 8))
    if case == "W_dtype":
        W = W.double()
    elif case == "rows_dtype":
        rows = rows.long()
    elif case == "vals_shape":
        vals = vals[:, :-1].contiguous()
    elif case == "id_too_large":
        rows[0] = W.shape[0]
    elif case == "id_below_padding":
        rows[0] = -2
    elif case == "noncontiguous":
        W = torch.cat([W, W], dim=1)[:, ::2]
    elif case == "mixed_device":
        rows = rows.to("meta")
    with pytest.raises(ValueError):
        rr.scatter_rows_(W, rows, vals)
    if case != "vals_shape":
        with pytest.raises(ValueError):
            rr.gather_rows(W, rows)


def test_kernels_match_plain_on_cuda():
    """The Hopper kernels against the plain versions, on the card, at
    aligned and unaligned widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for d, padding in CASES:
        W, rows, vals = (torch.from_numpy(a).to(dev) for a in _case(
            np.random.default_rng(d), d, padding=padding))
        g0, s0 = rr.gather_rows.launches, rr.scatter_rows_.launches
        assert torch.equal(rr.gather_rows(W, rows),
                           rr.gather_rows_reference(W, rows))
        want = rr.scatter_rows_reference(W.clone(), rows, vals)
        got = W.clone()
        ptr = got.data_ptr()
        out = rr.scatter_rows_(got, rows, vals)
        torch.cuda.synchronize()
        assert out.data_ptr() == ptr and torch.equal(out, want)
        assert (rr.gather_rows.launches, rr.scatter_rows_.launches) == (
            g0 + 1, s0 + 1)
