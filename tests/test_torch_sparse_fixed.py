"""The port's ELL sparse fixed-effect coordinate against the reference.

A config-5 shaped fixture at CPU scale (Zipf(1.3) columns, 32 slots, an
intercept column in every row) goes through the reference's
``SparseFixedEffectCoordinate(hybrid=False)`` on a one-device mesh and the
port's (``device="cpu"``, the plain ``ell_scatter``): ``train_model``
from the same offsets with L2 (L-BFGS), with L1 (OWL-QN), and with TRON,
``score``, and SIMPLE variances. Tolerance 5e-3 on coefficients and
variances (the band for full solves): the scatter sums run in another
order, and each solve stops on float32 tests. A model the reference
trained crosses into the port through ``game_model_from_arrays`` and
scores the shard identically. Every unported option raises and names
the slice that ports it.
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
from photon_ml_torch.optim import OptimizerConfig, OptimizerType
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


@pytest.mark.parametrize("option,slice_no", [
    ({"hybrid": None}, 4), ({"hybrid": True}, 4),
    ({"feature_sharded": True}, 9), ({"feature_dtype": "bfloat16"}, 6),
    ("down_sampling", 6)])
def test_unported_options_raise(data, option, slice_no):
    ds = data[0]
    cfg, _ = _configs("LBFGS", "L2", 1.0)
    kw = {"hybrid": False}
    if option == "down_sampling":
        cfg = dataclasses.replace(cfg, down_sampling_rate=0.5)
    else:
        kw.update(option)
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                    device="cpu", **kw)


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
