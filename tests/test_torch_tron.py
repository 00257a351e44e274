"""The port's lane-batched TRON against ``photon_ml_tpu.optim.tron``.

Dense objectives: a batch of lanes of different sizes (one all-padding)
against the reference's ``minimize`` run on each lane alone; the
explicit lane axis freezes a lane once it has stopped.
Sparse objectives: the config-5 shaped ELL objective of
``optim/sparse_problem.py`` against the reference's sparse objective on
a one-device mesh, through ``optimize`` (which now dispatches TRON) and
through ``sparse_problem.run``.

Tolerance: 5e-3 on coefficients (the band for full solves) and 1e-5
relative on the final value. TRON accepts a step only when the actual
decrease beats 1e-4 of the predicted one, and near the optimum that
decrease is a few float32 ulps of the value: one implementation accepts
a one-ulp decrease and stops converged where the other sees none and
shrinks its radius until it stalls a few 1e-4 away. Both are correct,
so iteration counts are not held, except where no step is possible.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import sparse
from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops import aggregators as agg
from photon_ml_torch.ops import losses
from photon_ml_torch.optim import (OptimizerConfig, OptimizerType, optimize,
                                   sparse_problem, tron, with_l2,
                                   with_l2_hvp)
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data.batch import LabeledBatch as RefBatch
from photon_ml_tpu.models.coefficients import Coefficients as RefCoef
from photon_ml_tpu.ops import aggregators as ref_agg
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefConfig
from photon_ml_tpu.optim import OptimizerType as RefType
from photon_ml_tpu.optim import tron as ref_tron
from photon_ml_tpu.optim import with_l2 as ref_with_l2
from photon_ml_tpu.optim import with_l2_hvp as ref_with_l2_hvp
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as RefRegularization
from photon_ml_tpu.optim.regularization import \
    RegularizationType as RefRegType
from photon_ml_tpu.parallel import sparse_problem as ref_sparse_problem
from photon_ml_tpu.parallel.mesh import make_mesh

L2 = 0.5
CFG = dict(optimizer_type=OptimizerType.TRON, max_iterations=30,
           tolerance=1e-6)
REF_CFG = RefConfig(optimizer_type=RefType.TRON, max_iterations=30,
                    tolerance=1e-6)
TOL = 5e-3


def _close_w(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL)


def _dense_problem(rng, lanes, cap=64, d=7):
    X = rng.normal(size=(lanes, cap, d)).astype(np.float32)
    X[..., -1] = 1.0
    w_true = 1.2 * rng.normal(size=(lanes, d)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-np.einsum("lcd,ld->lc", X, w_true)))
    y = (rng.random((lanes, cap)) < p).astype(np.float32)
    w = np.ones((lanes, cap), np.float32)
    for lane in range(lanes):  # different sizes: different stops
        w[lane, 10 + 9 * lane:] = 0.0
    w[-1] = 0.0  # an all-padding lane
    o = (0.2 * rng.normal(size=(lanes, cap))).astype(np.float32)
    return X, y, w, o


def test_dense_lanes_match_one_lane_reference_solves():
    X, y, w, o = _dense_problem(np.random.default_rng(4), 5)
    t = torch.from_numpy
    batch = LabeledBatch(t(X), t(y), t(w), t(o))
    vg = with_l2(lambda v: agg.value_and_gradient(losses.LOGISTIC, v,
                                                  batch), L2)
    hvp = with_l2_hvp(lambda v, u: agg.hessian_vector(losses.LOGISTIC, v, u,
                                                      batch), L2)
    res = optimize(vg, torch.zeros(X.shape[0], X.shape[-1]),
                   OptimizerConfig(**CFG), hvp=hvp)
    for lane in range(X.shape[0]):
        rb = RefBatch(jnp.asarray(X[lane]), jnp.asarray(y[lane]),
                      jnp.asarray(w[lane]), jnp.asarray(o[lane]))
        want = ref_tron.minimize(
            ref_with_l2(lambda v: ref_agg.value_and_gradient(
                ref_losses.LOGISTIC, v, rb), L2),
            ref_with_l2_hvp(lambda v, u: ref_agg.hessian_vector(
                ref_losses.LOGISTIC, v, u, rb), L2),
            jnp.zeros(X.shape[-1]), REF_CFG)
        _close_w(res.w[lane].numpy(), want.w)
        np.testing.assert_allclose(float(res.value[lane]),
                                   float(want.value), rtol=1e-5)
    # The all-padding lane has a zero gradient: it stops before any step.
    assert int(res.iterations[-1]) == 0 and bool(res.converged[-1])


def test_host_syncs_counted_per_loop_check():
    X, y, w, o = _dense_problem(np.random.default_rng(5), 3)
    t = torch.from_numpy
    batch = LabeledBatch(t(X), t(y), t(w), t(o))
    before = tron.minimize.host_syncs
    res = tron.minimize(
        with_l2(lambda v: agg.value_and_gradient(losses.LOGISTIC, v, batch),
                L2),
        with_l2_hvp(lambda v, u: agg.hessian_vector(losses.LOGISTIC, v, u,
                                                    batch), L2),
        torch.zeros(3, X.shape[-1]), OptimizerConfig(**CFG))
    outer = int(res.iterations.max())
    assert tron.minimize.host_syncs - before >= 2 * outer + 1


@pytest.fixture(scope="module")
def sparse_data():
    b, _ = sparse.synthetic_sparse(3000, 800, 12, seed=21)
    rb, _ = ref_sparse.synthetic_sparse(3000, 800, 12, seed=21)
    return b, rb


def test_sparse_objective_tron_matches_reference(sparse_data):
    b, rb = sparse_data
    stats = sparse_problem.SolveStats()
    vg = with_l2(sparse_problem.make_value_and_gradient(
        losses.LOGISTIC, b, stats), L2)
    hvp = with_l2_hvp(sparse_problem.make_hvp(losses.LOGISTIC, b, stats),
                      L2)
    res = optimize(vg, torch.zeros(1, 800), OptimizerConfig(**CFG),
                   hvp=hvp)
    rbj = jax.tree.map(jnp.asarray, rb)
    from photon_ml_tpu.ops import sparse_aggregators as ref_sagg
    want = ref_tron.minimize(
        ref_with_l2(lambda v: ref_sagg.value_and_gradient(
            ref_losses.LOGISTIC, v, rbj), L2),
        ref_with_l2_hvp(lambda v, u: ref_sagg.hessian_vector(
            ref_losses.LOGISTIC, v, u, rbj), L2),
        jnp.zeros(800), REF_CFG)
    _close_w(res.w[0].numpy(), want.w)
    np.testing.assert_allclose(float(res.value[0]), float(want.value),
                               rtol=1e-5)
    # One objective evaluation per outer iteration plus the start, one
    # H·v per CG step.
    assert stats.gradient_evaluations == int(res.iterations[0]) + 1
    assert stats.hessian_vector_products >= int(res.iterations[0])


def test_sparse_problem_run_with_tron_matches_reference(sparse_data):
    b, rb = sparse_data
    reg = RegularizationContext(RegularizationType.L2, L2)
    coef, res = sparse_problem.run(
        losses.LOGISTIC, b,
        GLMOptimizationConfiguration(OptimizerConfig(**CFG), reg),
        initial=Coefficients(torch.full((800,), 0.01)), intercept_index=3)
    ref_coef, ref_res = ref_sparse_problem.run(
        ref_losses.LOGISTIC, rb, make_mesh(num_data=1,
                                           devices=jax.devices()[:1]),
        RefGLMConfig(REF_CFG, RefRegularization(RefRegType.L2, L2)),
        initial=RefCoef(jnp.full((800,), 0.01)), intercept_index=3)
    _close_w(coef.means.numpy(), ref_coef.means)
    np.testing.assert_allclose(float(res.value[0]), float(ref_res.value),
                               rtol=1e-5)


def test_tron_rejects_l1_and_needs_hvp(sparse_data):
    b, _ = sparse_data
    reg = RegularizationContext(RegularizationType.L1, 1.0)
    with pytest.raises(ValueError, match="does not support L1"):
        sparse_problem.run(losses.LOGISTIC, b,
                           GLMOptimizationConfiguration(
                               OptimizerConfig(**CFG), reg))
    with pytest.raises(ValueError, match="Hessian-vector"):
        optimize(lambda w: (w.sum(-1), w), torch.zeros(1, 3),
                 OptimizerConfig(**CFG))
    with pytest.raises(NotImplementedError, match="slice 9"):
        sparse_problem.run(losses.LOGISTIC, b,
                           dataclasses.replace(
                               GLMOptimizationConfiguration(),
                               regularization=RegularizationContext()),
                           feature_sharded=True)
