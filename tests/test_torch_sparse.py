"""The port's sparse (ELL) data and aggregates against the reference.

``synthetic_sparse`` and ``from_csr`` build the same arrays as
``photon_ml_tpu.data.sparse`` bit for bit; ``from_sparse_batch`` gives
the same dataset. The value, gradient, H·v and Hessian diagonal of
``ops/sparse_aggregators.py`` (plain ``ell_scatter`` on CPU tensors) match
the reference's within rtol 1e-5: the same float32 terms, summed in
another order. Padding slots and zero-weight padding rows add nothing,
even when the padding rows hold garbage.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import sparse
from photon_ml_torch.data.game_data import from_sparse_batch
from photon_ml_torch.game.models import ell_matvec as models_ell_matvec
from photon_ml_torch.ops import losses
from photon_ml_torch.ops import sparse_aggregators as sagg
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data.game_data import \
    from_sparse_batch as ref_from_sparse_batch
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops import sparse_aggregators as ref_sagg

RTOL = 1e-5
N, DIM, NNZ = 600, 300, 12


def _arrays(b):
    return [np.asarray(a) for a in (b.indices, b.values, b.labels,
                                    b.weights, b.offsets)]


@pytest.mark.parametrize("zipf,task", [(True, "logistic"),
                                       (False, "linear")])
def test_synthetic_sparse_equals_reference(zipf, task):
    b, w = sparse.synthetic_sparse(N, DIM, NNZ, task=task, seed=7,
                                   zipf=zipf)
    rb, rw = ref_sparse.synthetic_sparse(N, DIM, NNZ, task=task, seed=7,
                                         zipf=zipf)
    assert b.indices.dtype == torch.int32 and b.num_features == DIM
    for got, want in zip(_arrays(b), _arrays(rb)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(w, rw)
    ds, rds = from_sparse_batch(b), ref_from_sparse_batch(rb)
    np.testing.assert_array_equal(ds.feature_shards["global"].indices,
                                  rds.feature_shards["global"].indices)
    np.testing.assert_array_equal(ds.response, rds.response)
    assert ds.shard_dim("global") == DIM and ds.num_rows == N


def test_from_csr_equals_reference():
    rng = np.random.default_rng(3)
    rows = [np.sort(rng.choice(50, size=rng.integers(0, 9), replace=False))
            for _ in range(40)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate(rows).astype(np.int32)
    values = rng.normal(size=indices.shape[0]).astype(np.float32)
    labels = (rng.random(40) < 0.5).astype(np.float32)
    for max_nnz in (None, 5):  # 5 caps rows, keeping the largest |values|
        b = sparse.from_csr(indptr, indices, values, labels, 50,
                            max_nnz=max_nnz)
        rb = ref_sparse.from_csr(indptr, indices, values, labels, 50,
                                 max_nnz=max_nnz)
        for got, want in zip(_arrays(b), _arrays(rb)):
            np.testing.assert_array_equal(got, want)


def test_pad_to_adds_inert_sentinel_rows():
    b, _ = sparse.synthetic_sparse(20, 30, 4, seed=1)
    p = b.pad_to(25)
    assert p.num_rows == 25 and p.layout is None
    assert bool((p.indices[20:] == 30).all())
    assert not p.values[20:].any() and not p.weights[20:].any()
    with pytest.raises(ValueError, match="cannot shrink"):
        b.pad_to(10)


@pytest.fixture(scope="module")
def problem():
    b, _ = sparse.synthetic_sparse(N, DIM, NNZ, seed=11)
    rb, _ = ref_sparse.synthetic_sparse(N, DIM, NNZ, seed=11)
    rng = np.random.default_rng(12)
    w = (0.3 * rng.normal(size=DIM)).astype(np.float32)
    v = rng.normal(size=DIM).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, N).astype(np.float32)
    offsets = (0.2 * rng.normal(size=N)).astype(np.float32)
    b = dataclasses.replace(b, weights=torch.from_numpy(weights),
                            offsets=torch.from_numpy(offsets))
    rb = dataclasses.replace(rb, weights=weights, offsets=offsets)
    return b, rb, w, v


@pytest.mark.parametrize("loss_name", ["logistic", "squared", "poisson"])
def test_aggregates_match_reference(problem, loss_name):
    b, rb, w, v = problem
    loss, ref_loss = losses.get_loss(loss_name), \
        ref_losses.get_loss(loss_name)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    jw, jv = jnp.asarray(w), jnp.asarray(v)
    rbj = ref_sparse.SparseBatch(*(jnp.asarray(a) for a in _arrays(rb)),
                                 num_features=DIM)
    value, grad = sagg.value_and_gradient(loss, tw, b)
    rvalue, rgrad = ref_sagg.value_and_gradient(ref_loss, jw, rbj)
    np.testing.assert_allclose(float(value), float(rvalue), rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(rgrad)).max())
    for got, want in (
            (sagg.hessian_vector(loss, tw, tv, b),
             ref_sagg.hessian_vector(ref_loss, jw, jv, rbj)),
            (sagg.hessian_diagonal(loss, tw, b),
             ref_sagg.hessian_diagonal(ref_loss, jw, rbj)),
            (sagg.margins(b, tw), ref_sagg.margins(rbj, jw)),
            (sagg.scores(b, tw), ref_sagg.scores(rbj, jw))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_padding_rows_and_slots_inert(problem):
    """Padded rows (weight 0, sentinel slots, garbage labels/offsets) and
    extra sentinel slots change no aggregate."""
    b, _, w, v = problem
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    p = b.pad_to(N + 37)
    p = dataclasses.replace(
        p, labels=torch.cat([b.labels, torch.full((37,), 1e30)]),
        offsets=torch.cat([b.offsets, torch.full((37,), -1e30)]))
    wide = dataclasses.replace(
        b, indices=torch.cat([b.indices, torch.full((N, 3), DIM,
                                                    dtype=torch.int32)], 1),
        values=torch.cat([b.values, torch.zeros(N, 3)], 1))
    loss = losses.LOGISTIC
    base = [sagg.value_and_gradient(loss, tw, b)[0],
            sagg.value_and_gradient(loss, tw, b)[1],
            sagg.hessian_vector(loss, tw, tv, b),
            sagg.hessian_diagonal(loss, tw, b)]
    for other in (p, wide):
        got = [sagg.value_and_gradient(loss, tw, other)[0],
               sagg.value_and_gradient(loss, tw, other)[1],
               sagg.hessian_vector(loss, tw, tv, other),
               sagg.hessian_diagonal(loss, tw, other)]
        for g, want in zip(got, base):
            assert bool(torch.isfinite(g).all())
            torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)


def test_one_ell_matvec_for_models_and_objectives():
    assert models_ell_matvec is sagg.ell_matvec
