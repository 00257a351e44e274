"""The port's lane-batched L-BFGS / OWL-QN against the reference.

One lane against ``photon_ml_tpu.optim.lbfgs.minimize`` on an L2 and an
L1 logistic problem, and a batch of lanes against ``jax.vmap`` of it:
lanes of different sizes stop at different iterations, and an all-zero-
weight lane converges at once. The fixtures keep each stopping test
well clear of the tolerance: the relative value change is an f32
difference, and a borderline lane would stop one step apart in two
correct implementations. Per lane, ``w`` agrees within 1e-4 of
max|w| (the sums differ only in their order), the OWL-QN zero pattern
is equal, and ``iterations`` and ``converged`` are equal: the explicit
lane axis must reproduce ``vmap``'s per-lane freezing exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.ops import aggregators as agg
from photon_ml_torch.ops import losses
from photon_ml_torch.optim import (OptimizerConfig, OptimizerType, lbfgs,
                                   optimize, with_l2)
from photon_ml_torch.optim.regularization import l1_weights_vector
from photon_ml_tpu.data.batch import LabeledBatch as RefBatch
from photon_ml_tpu.ops import aggregators as ref_agg
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefConfig
from photon_ml_tpu.optim import lbfgs as ref_lbfgs
from photon_ml_tpu.optim.regularization import \
    l1_weights_vector as ref_l1_weights_vector
from photon_ml_tpu.optim.regularization import with_l2 as ref_with_l2

CFG = dict(max_iterations=40, tolerance=1e-6)
L2 = 0.5
L1 = 2.0


def _problem(rng, lanes, cap=48, d=6):
    X = rng.normal(size=(lanes, cap, d)).astype(np.float32)
    X[..., -1] = 1.0
    w_true = 1.5 * rng.normal(size=(lanes, d)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-np.einsum("lcd,ld->lc", X, w_true)))
    y = (rng.random((lanes, cap)) < p).astype(np.float32)
    w = np.ones((lanes, cap), np.float32)
    for lane in range(lanes):  # different sizes: different stops
        w[lane, 6 + 7 * lane:] = 0.0
    w[-1] = 0.0  # an all-padding lane
    o = (0.2 * rng.normal(size=(lanes, cap))).astype(np.float32)
    return X, y, w, o


def _port_solve(X, y, w, o, l1):
    t = torch.from_numpy
    batch = LabeledBatch(t(X), t(y), t(w), t(o))
    d = X.shape[-1]
    if l1:
        vg = (lambda v: agg.value_and_gradient(losses.LOGISTIC, v, batch))
        return lbfgs.minimize_owlqn(vg, torch.zeros(X.shape[0], d),
                                    l1_weights_vector(L1, d, d - 1),
                                    OptimizerConfig(**CFG))
    vg = with_l2(lambda v: agg.value_and_gradient(losses.LOGISTIC, v, batch),
                 L2)
    return lbfgs.minimize(vg, torch.zeros(X.shape[0], d),
                          OptimizerConfig(**CFG))


def _ref_solve_one(X, y, w, o, l1):
    batch = RefBatch(X, y, w, o)
    d = X.shape[-1]
    vg = (lambda v: ref_agg.value_and_gradient(ref_losses.LOGISTIC, v,
                                               batch))
    w0 = jnp.zeros((d,), jnp.float32)
    if l1:
        return ref_lbfgs.minimize_owlqn(vg, w0,
                                        ref_l1_weights_vector(L1, d, d - 1),
                                        RefConfig(**CFG))
    return ref_lbfgs.minimize(ref_with_l2(vg, L2), w0, RefConfig(**CFG))


def _assert_lanes_match(got, want, l1):
    w_ref = np.asarray(want.w)
    w_got = got.w.numpy()
    scale = max(float(np.max(np.abs(w_ref))), 1e-6)
    np.testing.assert_allclose(w_got, w_ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    if l1:
        np.testing.assert_array_equal(w_got == 0.0, w_ref == 0.0)


@pytest.mark.parametrize("l1", [False, True], ids=["lbfgs_l2", "owlqn_l1"])
def test_one_lane_matches_minimize(l1):
    X, y, w, o = _problem(np.random.default_rng(11), 1)
    w[:] = 1.0
    got = _port_solve(X, y, w, o, l1)
    want = _ref_solve_one(*(jnp.asarray(a[0]) for a in (X, y, w, o)), l1)
    want = jax.tree.map(lambda a: a[None], want)
    assert int(got.iterations[0]) > 3 and bool(got.converged[0])
    _assert_lanes_match(got, want, l1)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-5)


@pytest.mark.parametrize("l1", [False, True], ids=["lbfgs_l2", "owlqn_l1"])
def test_lanes_match_vmapped_minimize(l1):
    # Seed 17: no lane's last step sits on an f32 knife-edge. It agrees
    # with the reference at tolerance 1e-6 and 1e-5, on 1 and 8 threads;
    # at about half of all seeds one lane stops a step apart.
    X, y, w, o = _problem(np.random.default_rng(17), 6)
    got = _port_solve(X, y, w, o, l1)
    want = jax.vmap(lambda *a: _ref_solve_one(*a, l1))(
        *(jnp.asarray(a) for a in (X, y, w, o)))
    its = got.iterations.numpy()
    assert len(set(its[:-1].tolist())) > 1  # lanes stop at different steps
    assert its[-1] == 0 and bool(got.converged[-1])  # all-zero lane
    _assert_lanes_match(got, want, l1)
    # The histories freeze with their lane: NaN past each lane's end.
    vh = got.value_history.numpy()
    for lane, n_it in enumerate(its):
        assert np.all(np.isfinite(vh[lane, :n_it + 1]))
        assert np.all(np.isnan(vh[lane, n_it + 1:]))


def test_lane_equals_its_own_one_lane_solve():
    """Lane i of a batch takes exactly the steps of a one-lane solve of
    lane i: the explicit lane axis freezes lanes as vmap does."""
    X, y, w, o = _problem(np.random.default_rng(13), 4)
    batch = _port_solve(X, y, w, o, False)
    for lane in range(4):
        one = _port_solve(X[lane:lane + 1], y[lane:lane + 1],
                          w[lane:lane + 1], o[lane:lane + 1], False)
        assert int(one.iterations[0]) == int(batch.iterations[lane])
        np.testing.assert_allclose(one.w[0].numpy(), batch.w[lane].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_host_syncs_counted_per_loop_check():
    X, y, w, o = _problem(np.random.default_rng(14), 3)
    before = lbfgs.minimize.host_syncs
    res = _port_solve(X, y, w, o, False)
    syncs = lbfgs.minimize.host_syncs - before
    # One per outer check (iterations + the final one) and at least one
    # per line search, never one per lane.
    outer = int(res.iterations.max()) + 1
    assert syncs >= 2 * outer - 1
    assert syncs <= outer * (OptimizerConfig().max_line_search_steps + 2)


def test_optimize_dispatch():
    X, y, w, o = _problem(np.random.default_rng(16), 2)
    t = torch.from_numpy
    batch = LabeledBatch(t(X), t(y), t(w), t(o))
    vg = (lambda v: agg.value_and_gradient(losses.LOGISTIC, v, batch))
    w0 = torch.zeros(2, X.shape[-1])
    with pytest.raises(ValueError, match="requires a Hessian-vector"):
        optimize(vg, w0, OptimizerConfig(optimizer_type=OptimizerType.TRON))
    with pytest.raises(ValueError, match="does not support L1"):
        optimize(vg, w0, OptimizerConfig(optimizer_type=OptimizerType.TRON),
                 hvp=lambda w, v: v, l1_weights=torch.ones(6))
    with pytest.raises(ValueError, match="requires OWLQN"):
        optimize(vg, w0, OptimizerConfig(), l1_weights=torch.ones(6))
    with pytest.raises(ValueError, match="requires l1_weights"):
        optimize(vg, w0, OptimizerConfig(optimizer_type=OptimizerType.OWLQN))
