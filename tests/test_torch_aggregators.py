"""The port's aggregators against the reference's, flat and lane-batched.

Same numpy inputs through ``photon_ml_tpu.ops.aggregators`` (the
lane-batched case under ``jax.vmap``, as the reference runs a bucket)
and ``photon_ml_torch.ops.aggregators`` (over its explicit lane axis),
with a normalization context carrying factors, shifts and an intercept,
and large garbage in the zero-weight padding rows. Tolerance: 1e-5 of
each output's largest magnitude; the sums differ only in their order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.normalization import build_normalization
from photon_ml_torch.ops import aggregators as agg
from photon_ml_torch.ops import losses
from photon_ml_tpu.data.batch import LabeledBatch as RefBatch
from photon_ml_tpu.normalization import \
    build_normalization as ref_build_normalization
from photon_ml_tpu.ops import aggregators as ref_agg
from photon_ml_tpu.ops import losses as ref_losses

RTOL = 1e-5
FUNCS = ["margins", "value_and_gradient", "value_only", "hessian_vector",
         "hessian_diagonal", "hessian_matrix", "scores"]


def _inputs(rng, lanes, n=24, d=6):
    shape = (n,) if lanes is None else (lanes, n)
    X = rng.normal(size=shape + (d,)).astype(np.float32)
    X[..., -1] = 1.0  # intercept column
    y = (rng.random(shape) < 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    o = (0.1 * rng.normal(size=shape)).astype(np.float32)
    pad = rng.random(shape) < 0.25
    X[pad] = 3e5  # garbage: inert only through the hard mask
    y[pad] = 37.0
    o[pad] = 1e4
    w[pad] = 0.0
    means_shape = (d,) if lanes is None else (lanes, d)
    means = (0.3 * rng.normal(size=means_shape)).astype(np.float32)
    v = rng.normal(size=means_shape).astype(np.float32)
    stats = dict(means=rng.normal(size=d), variances=rng.uniform(0.5, 2, d),
                 intercept_index=d - 1)
    return X, y, w, o, means, v, stats


def _port(name, loss, X, y, w, o, means, v, norm):
    t = torch.from_numpy
    batch = LabeledBatch(t(X), t(y), t(w), t(o))
    m = t(means)
    if name == "scores":
        return [agg.scores(batch.features, m, batch.offsets)]
    if name == "margins":
        return [agg.margins(batch, m, norm)]
    if name == "hessian_vector":
        return [agg.hessian_vector(loss, m, t(v), batch, norm)]
    out = getattr(agg, name)(loss, m, batch, norm)
    return list(out) if isinstance(out, tuple) else [out]


def _ref(name, loss, X, y, w, o, means, v, norm):
    def one(X, y, w, o, means, v):
        batch = RefBatch(X, y, w, o)
        if name == "scores":
            return ref_agg.scores(X, means, o)
        if name == "margins":
            return ref_agg.margins(batch, means, norm)
        if name == "hessian_vector":
            return ref_agg.hessian_vector(loss, means, v, batch, norm)
        return getattr(ref_agg, name)(loss, means, batch, norm)

    args = [jnp.asarray(a) for a in (X, y, w, o, means, v)]
    out = (one if X.ndim == 2 else jax.vmap(one))(*args)
    return [np.asarray(a) for a in
            (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("lanes", [None, 5], ids=["flat", "lanes"])
@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("loss_name", ["logistic", "poisson"])
def test_aggregator_matches_reference(name, lanes, loss_name):
    rng = np.random.default_rng(len(name) + (lanes or 0))
    X, y, w, o, means, v, stats = _inputs(rng, lanes)
    if loss_name == "poisson":
        y = np.where(w > 0, np.round(2 * np.abs(y)), y).astype(np.float32)
    norm = build_normalization("STANDARDIZATION", **stats)
    ref_norm = ref_build_normalization("STANDARDIZATION", **stats)
    got = _port(name, losses.get_loss(loss_name), X, y, w, o, means, v,
                norm)
    want = _ref(name, ref_losses.get_loss(loss_name), X, y, w, o, means, v,
                ref_norm)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        g = g.numpy()
        assert g.shape == r.shape and np.all(np.isfinite(g))
        if name != "scores":
            assert np.all(np.isfinite(r))
        scale = max(float(np.max(np.abs(r))), 1e-30)
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL * scale)


def test_identity_norm_and_padding_rows_inert():
    """With no normalization, padding rows change nothing: the same
    batch with them dropped gives the same value and gradient."""
    rng = np.random.default_rng(7)
    X, y, w, o, means, _, _ = _inputs(rng, None)
    live = w > 0
    t = torch.from_numpy
    full = agg.value_and_gradient(losses.LOGISTIC, t(means),
                                  LabeledBatch(t(X), t(y), t(w), t(o)))
    kept = agg.value_and_gradient(
        losses.LOGISTIC, t(means),
        LabeledBatch(t(X[live]), t(y[live]), t(w[live]), t(o[live])))
    for a, b in zip(full, kept):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_flat_batch_broadcasts_one_lane():
    """A flat (n, d) batch with (1, d) means is the one-lane problem the
    fixed effect solves: it equals the unbatched call."""
    rng = np.random.default_rng(8)
    X, y, w, o, means, _, _ = _inputs(rng, None)
    t = torch.from_numpy
    batch = LabeledBatch(t(X), t(y), t(w), t(o))
    f1, g1 = agg.value_and_gradient(losses.LOGISTIC, t(means)[None], batch)
    f0, g0 = agg.value_and_gradient(losses.LOGISTIC, t(means), batch)
    assert f1.shape == (1,) and g1.shape == (1, X.shape[1])
    np.testing.assert_allclose(f1[0].numpy(), f0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g1[0].numpy(), g0.numpy(), rtol=1e-6,
                               atol=1e-6)
