"""The port's sparse fixed-effect coordinate against the reference.

A config-5 shaped fixture at CPU scale (Zipf(1.3) columns, 32 slots, an
intercept column in every row) goes through the reference's
``SparseFixedEffectCoordinate`` on a one-device mesh and the port's
(``device="cpu"``, the kernels' plain versions), on the ELL layout
(``hybrid=False``) and on the hybrid hot/cold layout (``hybrid=None``,
the default, and ``hybrid=True``): ``train_model`` from the same offsets
with L2 (L-BFGS), with L1 (OWL-QN), and with TRON, ``score``, and SIMPLE
variances. Tolerance 5e-3 on coefficients and variances (the band for
full solves): the scatter sums run in another order, and each solve
stops on float32 tests. Down-sampled fits (rate 0.5, seed 9) on both
layouts draw the reference's subsets and are held to the same band. A
model the reference
trained crosses into the port through ``game_model_from_arrays`` and
scores the shard identically. bfloat16 storage stores the hybrid hot
block in bfloat16 (the same band against the reference's bfloat16
coordinate) and leaves the ELL layout as it is. Every unported option
raises and names the slice that ports it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import sparse
from photon_ml_torch.data.game_data import from_sparse_batch
from photon_ml_torch.game.coordinates import SparseFixedEffectCoordinate
from photon_ml_torch.models import io as model_io
from photon_ml_torch.ops import losses
from photon_ml_torch.optim import (OptimizerConfig, OptimizerType,
                                   sparse_problem)
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data.game_data import \
    from_sparse_batch as ref_from_sparse_batch
from photon_ml_tpu.game.coordinates import \
    SparseFixedEffectCoordinate as RefCoordinate
from photon_ml_tpu.game.models import GameModel as RefGameModel
from photon_ml_tpu.models import io as ref_io
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim import OptimizerType as RefOptimizerType
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.optim.problem import \
    VarianceComputationType as RefVarianceType
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as RefRegularization
from photon_ml_tpu.optim.regularization import \
    RegularizationType as RefRegType
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import TaskType as RefTaskType

TOL = 5e-3
N, DIM, NNZ = 4000, 1500, 32


def _with_intercept(module, seed):
    """Zipf data with column DIM−1 set to 1.0 in slot 0 of every row, so
    the unregularized intercept is exercised (canonical rows kept: the
    generator's last column is a tail catch-all, which slot 0 rarely
    holds)."""
    b, _ = module.synthetic_sparse(N, DIM, NNZ, seed=seed)
    idx = np.array(b.indices)
    val = np.array(b.values)
    hit = (idx == DIM - 1)
    idx[hit], val[hit] = DIM, 0.0  # drop the catch-all's own entries
    idx[:, 0], val[:, 0] = DIM - 1, 1.0
    return idx, val, np.asarray(b.labels)


@pytest.fixture(scope="module")
def data():
    idx, val, y = _with_intercept(sparse, 9)
    ridx, rval, ry = _with_intercept(ref_sparse, 9)
    np.testing.assert_array_equal(idx, ridx)
    t = torch.from_numpy
    b = sparse.SparseBatch(t(idx), t(val), t(y), torch.ones(N),
                           torch.zeros(N), DIM)
    rb = ref_sparse.SparseBatch(ridx, rval, ry, np.ones(N, np.float32),
                                np.zeros(N, np.float32), DIM)
    ds, rds = from_sparse_batch(b), ref_from_sparse_batch(rb)
    ds.intercept_index["global"] = DIM - 1
    rds.intercept_index["global"] = DIM - 1
    offsets = (0.3 * np.random.default_rng(1).normal(size=N)).astype(
        np.float32)
    return ds, rds, offsets


def _configs(opt, reg_type, weight, variance="NONE"):
    port = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(OptimizerType(opt), max_iterations=80,
                                  tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType(reg_type),
                                             weight),
        variance_computation=VarianceComputationType(variance))
    ref = RefGLMConfig(
        optimizer=RefOptimizerConfig(RefOptimizerType(opt),
                                     max_iterations=80, tolerance=1e-7),
        regularization=RefRegularization(RefRegType(reg_type), weight),
        variance_computation=RefVarianceType(variance))
    return port, ref


def _mesh():
    return make_mesh(num_data=1, devices=jax.devices()[:1])


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("opt,reg,weight", [("LBFGS", "L2", 1.0),
                                            ("LBFGS", "L1", 2.0),
                                            ("TRON", "L2", 1.0)])
def test_train_model_matches_reference(data, opt, reg, weight):
    ds, rds, offsets = data
    cfg, ref_cfg = _configs(opt, reg, weight)
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=False, device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=False)
    model = coord.train_model(offsets)
    ref_model = ref.train_model(jnp.asarray(offsets))
    w = model.coefficients.means
    _close(w, ref_model.coefficients.means)
    _close(coord.score(model), ref.score(ref_model), tol=TOL * 10)
    solve = coord.last_solve
    assert solve["optimizer"] == ("OWLQN" if reg == "L1" else opt)
    assert solve["gradient_evaluations"] >= solve["iterations"] >= 1
    assert (solve["hessian_vector_products"] > 0) == (opt == "TRON")
    if reg == "L1":  # OWL-QN zeroes coefficients exactly
        assert int((w == 0).sum()) > DIM // 4
    # A warm start from the trained model barely moves.
    again = coord.train_model(offsets, initial=model)
    _close(again.coefficients.means, w)


def test_simple_variances_match_reference(data):
    ds, rds, offsets = data
    cfg, ref_cfg = _configs("LBFGS", "L2", 1.0, "SIMPLE")
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=False, device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=False)
    ref_model = ref.train_model(jnp.asarray(offsets))
    # Variances at the SAME coefficients: the reference's trained ones.
    model = model_io.game_model_from_arrays(
        "LOGISTIC_REGRESSION", {"ctr": (
            ref_io.coordinate_meta(ref_model),
            ref_io.coordinate_arrays(ref_model))}).models["ctr"]
    var = coord.compute_model_variances(model, offsets).coefficients
    ref_var = ref.compute_model_variances(
        ref_model, jnp.asarray(offsets)).coefficients.variances
    _close(var.variances, ref_var)
    assert bool((var.variances > 0).all())
    full = coord.with_optimization_config(dataclasses.replace(
        cfg, variance_computation=VarianceComputationType.FULL))
    with pytest.raises(NotImplementedError, match="SIMPLE"):
        full.compute_model_variances(model, offsets)


def test_reference_model_crosses_and_scores_identically(data):
    """A sparse fixed-effect model the reference trained (means and
    SIMPLE variances) loads into the port through
    ``game_model_from_arrays`` and scores the same SparseShard."""
    ds, rds, offsets = data
    _, ref_cfg = _configs("LBFGS", "L2", 1.0, "SIMPLE")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=False)
    ref_model = ref.compute_model_variances(
        ref.train_model(jnp.asarray(offsets)), jnp.asarray(offsets))
    game = RefGameModel(task=RefTaskType.LOGISTIC_REGRESSION,
                        models={"ctr": ref_model})
    ported = model_io.game_model_from_arrays(
        game.task, {cid: (ref_io.coordinate_meta(m),
                          ref_io.coordinate_arrays(m))
                    for cid, m in game.models.items()})
    m = ported.models["ctr"]
    np.testing.assert_array_equal(m.coefficients.means.numpy(),
                                  np.asarray(ref_model.coefficients.means))
    np.testing.assert_array_equal(
        m.coefficients.variances.numpy(),
        np.asarray(ref_model.coefficients.variances))
    np.testing.assert_allclose(ported.score(ds).numpy(),
                               np.asarray(game.score(rds)), rtol=0,
                               atol=1e-5)
    assert model_io.game_model_digest(ported) == ref_io.game_model_digest(
        game)


@pytest.mark.parametrize("hybrid", [None, True])
@pytest.mark.parametrize("opt,reg,weight", [("LBFGS", "L2", 1.0),
                                            ("LBFGS", "L1", 2.0),
                                            ("TRON", "L2", 1.0)])
def test_hybrid_train_model_matches_reference(data, hybrid, opt, reg,
                                              weight):
    """The hybrid layout (the default, and asked for) against the
    reference's hybrid coordinate: coefficients, a warm restart and the
    scores within TOL; the intercept is mapped into permuted space."""
    ds, rds, offsets = data
    cfg, ref_cfg = _configs(opt, reg, weight)
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=hybrid, device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=hybrid)
    assert coord.hybrid and ref.hybrid
    assert coord._ii_perm == ref._ii_perm is not None
    assert coord.staged.num_hot == ref._staged.num_hot > 0
    model = coord.train_model(offsets)
    ref_model = ref.train_model(jnp.asarray(offsets))
    w = model.coefficients.means
    _close(w, ref_model.coefficients.means)
    _close(coord.score(model), ref.score(ref_model), tol=TOL * 10)
    solve = coord.last_solve
    assert solve["optimizer"] == ("OWLQN" if reg == "L1" else opt)
    assert solve["gradient_evaluations"] >= solve["iterations"] >= 1
    assert (solve["hessian_vector_products"] > 0) == (opt == "TRON")
    assert coord.staging_seconds > 0
    if reg == "L1":
        assert int((w == 0).sum()) > DIM // 4
        assert float(w[DIM - 1]) != 0.0  # the intercept is not penalized
    again = coord.train_model(offsets, initial=model)
    _close(again.coefficients.means, w)


def test_hybrid_simple_variances_match_reference(data):
    ds, rds, offsets = data
    cfg, ref_cfg = _configs("LBFGS", "L2", 1.0, "SIMPLE")
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh())
    ref_model = ref.train_model(jnp.asarray(offsets))
    model = model_io.game_model_from_arrays(
        "LOGISTIC_REGRESSION", {"ctr": (
            ref_io.coordinate_meta(ref_model),
            ref_io.coordinate_arrays(ref_model))}).models["ctr"]
    var = coord.compute_model_variances(model, offsets).coefficients
    ref_var = ref.compute_model_variances(
        ref_model, jnp.asarray(offsets)).coefficients.variances
    _close(var.variances, ref_var)
    assert bool((var.variances > 0).all())
    # The solve's own SIMPLE variances (run_hybrid maps them back).
    coef, _ = sparse_problem.run_hybrid(
        losses.LOGISTIC, coord._batch(offsets), cfg,
        initial=model.coefficients,
        intercept_index_permuted=coord._ii_perm)
    _close(coef.variances, ref_var)
    full = coord.with_optimization_config(dataclasses.replace(
        cfg, variance_computation=VarianceComputationType.FULL))
    with pytest.raises(NotImplementedError, match="SIMPLE"):
        full.compute_model_variances(model, offsets)
    with pytest.raises(NotImplementedError, match="SIMPLE"):
        sparse_problem.run_hybrid(losses.LOGISTIC, coord._batch(offsets),
                                  full.config)


@pytest.mark.parametrize("hybrid", [None, True])
def test_hybrid_down_sampling_matches_reference(data, hybrid):
    """down_sampling_rate 0.5 on the hybrid layout (weights masked, the
    block as staged) against the reference's, seed 9: two draws, each
    within TOL of the reference's fit on the same subset."""
    ds, rds, offsets = data
    cfg, ref_cfg = _configs("LBFGS", "L2", 1.0)
    cfg = dataclasses.replace(cfg, down_sampling_rate=0.5)
    ref_cfg = dataclasses.replace(ref_cfg, down_sampling_rate=0.5)
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=hybrid, down_sampling_seed=9,
                                        device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=hybrid, down_sampling_seed=9)
    assert coord.hybrid and ref.hybrid
    for _ in range(2):
        model = coord.train_model(offsets)
        _close(model.coefficients.means,
               ref.train_model(jnp.asarray(offsets)).coefficients.means)
    assert coord.staged.weights.eq(1.0).all()  # the staged batch untouched
    assert 0 < coord.last_solve["sampled_rows"] < N


@pytest.mark.parametrize("hybrid", [None, True])
def test_hybrid_bfloat16_train_model_matches_reference(data, hybrid):
    """feature_dtype="bfloat16" on the hybrid layout against the
    reference's bfloat16 hybrid coordinate: a bfloat16 hot block of the
    reference's width (its n/4096 threshold), coefficients within TOL
    and scores within 10·TOL after 10 L-BFGS iterations. Rounding the
    coefficients to bfloat16 (both packages' route) makes the objective
    a step function of them, and two correct solvers part after about 20
    iterations (ROADMAP §C), so the full solve is not held here."""
    ds, rds, offsets = data
    cfg, ref_cfg = _configs("LBFGS", "L2", 1.0)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, max_iterations=10))
    ref_cfg = dataclasses.replace(ref_cfg, optimizer=dataclasses.replace(
        ref_cfg.optimizer, max_iterations=10))
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=hybrid,
                                        feature_dtype="bfloat16",
                                        device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=hybrid, feature_dtype="bfloat16")
    assert coord.staged.X_hot.dtype == torch.bfloat16
    assert ref._staged.X_hot.dtype == jnp.bfloat16
    assert coord.staged.num_hot == ref._staged.num_hot > 0
    model = coord.train_model(offsets)
    ref_model = ref.train_model(jnp.asarray(offsets))
    _close(model.coefficients.means, ref_model.coefficients.means)
    _close(coord.score(model), ref.score(ref_model), tol=TOL * 10)


def test_ell_ignores_feature_dtype(data):
    """As in the reference, the ELL layout reads no feature_dtype: a
    bfloat16 request stages and fits the float32 batch, bit for bit."""
    ds, _, offsets = data
    cfg, _ = _configs("LBFGS", "L2", 1.0)
    coords = [SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC,
                                          cfg, hybrid=False, device="cpu",
                                          feature_dtype=dtype)
              for dtype in ("float32", "bfloat16")]
    assert coords[1].staged.values.dtype == torch.float32
    a, b = (c.train_model(offsets).coefficients.means for c in coords)
    assert torch.equal(a, b)


def test_hybrid_with_feature_sharded_raises(data):
    """As in the reference: hybrid=True with feature_sharded is a
    ValueError; hybrid=None with it resolves to ELL, which is slice 9."""
    cfg, _ = _configs("LBFGS", "L2", 1.0)
    with pytest.raises(ValueError, match="incompatible with feature_sharded"):
        SparseFixedEffectCoordinate(data[0], "global", losses.LOGISTIC, cfg,
                                    hybrid=True, feature_sharded=True,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        SparseFixedEffectCoordinate(data[0], "global", losses.LOGISTIC, cfg,
                                    feature_sharded=True, device="cpu")


@pytest.mark.parametrize("option,slice_no", [
    ({"feature_sharded": True}, 9)])
def test_unported_options_raise(data, option, slice_no):
    ds = data[0]
    cfg, _ = _configs("LBFGS", "L2", 1.0)
    kw = {"hybrid": False}
    kw.update(option)
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                    device="cpu", **kw)


def test_ell_down_sampling_matches_reference(data):
    """down_sampling_rate 0.5 on ELL (the sampled rows gathered into a
    batch of their own) against the reference's, seed 9: two draws, each
    within TOL of the reference's fit on the same subset; the staged
    batch keeps every row."""
    ds, rds, offsets = data
    cfg, ref_cfg = _configs("LBFGS", "L2", 1.0)
    cfg = dataclasses.replace(cfg, down_sampling_rate=0.5)
    ref_cfg = dataclasses.replace(ref_cfg, down_sampling_rate=0.5)
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=False, down_sampling_seed=9,
                                        device="cpu")
    ref = RefCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                        _mesh(), hybrid=False, down_sampling_seed=9)
    for _ in range(2):
        model = coord.train_model(offsets)
        _close(model.coefficients.means,
               ref.train_model(jnp.asarray(offsets)).coefficients.means)
    y = np.asarray(ds.response)
    assert coord.last_solve["sampled_rows"] == \
        int((y > 0).sum()) + int(round(int((y <= 0).sum()) * 0.5))
    assert coord.staged.num_rows == N


def test_dense_shard_refused_and_cuda_default(data):
    ds = data[0]
    cfg, _ = _configs("LBFGS", "L2", 1.0)
    dense = dataclasses.replace(ds, feature_shards={
        "global": np.zeros((N, 3), np.float32)})
    with pytest.raises(TypeError, match="not sparse"):
        SparseFixedEffectCoordinate(dense, "global", losses.LOGISTIC, cfg,
                                    hybrid=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=False)
