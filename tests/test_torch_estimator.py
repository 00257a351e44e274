"""``GameEstimator.fit`` in the port against the reference's.

Two fixtures at CPU scale, each fitted by the reference's estimator (on
a one-device mesh for the sparse one, the 8-device virtual CPU mesh for
the dense one) and by the port's (``device="cpu"``):

- config 5 shaped: one ELL sparse fixed effect (``hybrid=False``) over a
  Zipf(1.3) shard, with a 2-point regularization-weight grid, validation
  AUC and logistic loss, and ``select_best_model``;
- config 4 shaped: a dense fixed effect and per-user and per-item random
  effects, one descent iteration, with a grouped AUC.

Tolerance 5e-3 on coefficients and metrics (the band for full solves
and descents). Unported estimator options raise and name their slice.
"""

import jax
import numpy as np
import pytest

from photon_ml_torch.api.configs import (
    CoordinateConfiguration, FactoredRandomEffectDataConfiguration,
    FixedEffectDataConfiguration, RandomEffectDataConfiguration)
from photon_ml_torch.api.estimator import GameEstimator
from photon_ml_torch.data import sparse, synthetic
from photon_ml_torch.data.game_data import from_sparse_batch, from_synthetic
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType
from photon_ml_tpu.api import configs as ref_configs
from photon_ml_tpu.api.estimator import GameEstimator as RefEstimator
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data import synthetic as ref_synthetic
from photon_ml_tpu.data.game_data import \
    from_sparse_batch as ref_from_sparse_batch
from photon_ml_tpu.data.game_data import from_synthetic as ref_from_synthetic
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
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
GRID = (1.0, 30.0)


def _opt(variance="NONE", iterations=60):
    return (GLMOptimizationConfiguration(
                optimizer=OptimizerConfig(max_iterations=iterations,
                                          tolerance=1e-7),
                regularization=RegularizationContext(RegularizationType.L2,
                                                     1.0),
                variance_computation=VarianceComputationType(variance)),
            RefGLMConfig(
                optimizer=RefOptimizerConfig(max_iterations=iterations,
                                             tolerance=1e-7),
                regularization=RefRegularization(RefRegType.L2, 1.0),
                variance_computation=RefVarianceType(variance)))


def _split(ds, n):
    cut = n - n // 10
    return ds.subset(np.arange(cut)), ds.subset(np.arange(cut, n))


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu()) if hasattr(got, "detach") \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def sparse_fits():
    n = 5000
    b, _ = sparse.synthetic_sparse(n, 2000, 32, seed=17)
    rb, _ = ref_sparse.synthetic_sparse(n, 2000, 32, seed=17)
    train, val = _split(from_sparse_batch(b), n)
    ref_train, ref_val = _split(ref_from_sparse_batch(rb), n)
    opt, ref_opt = _opt("SIMPLE")
    est = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"ctr": CoordinateConfiguration(
            FixedEffectDataConfiguration("global", hybrid=False), opt,
            reg_weight_grid=GRID)},
        ["ctr"], device="cpu",
        validation_evaluators=["AUC", "LOGISTIC_LOSS"])
    ref_est = RefEstimator(
        RefTaskType.LOGISTIC_REGRESSION,
        {"ctr": ref_configs.CoordinateConfiguration(
            ref_configs.FixedEffectDataConfiguration("global", hybrid=False),
            ref_opt, reg_weight_grid=GRID)},
        ["ctr"], make_mesh(num_data=1, devices=jax.devices()[:1]),
        validation_evaluators=["AUC", "LOGISTIC_LOSS"])
    return (est, est.fit(train, validation_data=val),
            ref_est, ref_est.fit(ref_train, validation_data=ref_val))


def test_sparse_fit_grid_matches_reference(sparse_fits):
    _, results, _, ref_results = sparse_fits
    assert len(results) == len(ref_results) == len(GRID)
    for r, rr, weight in zip(results, ref_results, GRID):
        assert r.configs["ctr"].regularization.reg_weight == weight
        got, want = r.model.models["ctr"], rr.model.models["ctr"]
        _close(got.coefficients.means, want.coefficients.means)
        _close(got.coefficients.variances, want.coefficients.variances)
        for key in ("AUC", "LOGISTIC_LOSS"):
            assert abs(r.evaluation.metrics[key]
                       - rr.evaluation.metrics[key]) <= TOL, key
        solve = r.history.records[-1]["solver"]
        assert solve["gradient_evaluations"] >= solve["iterations"] >= 1


def test_select_best_model_matches_reference(sparse_fits):
    est, results, ref_est, ref_results = sparse_fits
    best = est.select_best_model(results)
    ref_best = ref_est.select_best_model(ref_results)
    assert best.configs["ctr"].regularization.reg_weight == \
        ref_best.configs["ctr"].regularization.reg_weight
    assert best.evaluation.primary == "AUC"
    assert all(best.evaluation.primary_value >= r.evaluation.primary_value
               for r in results)
    with pytest.raises(ValueError, match="no results"):
        est.select_best_model([])


def test_refit_reuses_staged_coordinates(sparse_fits):
    """A second fit on the same dataset content swaps only the
    optimization config: the staged batch is the same object."""
    est = sparse_fits[0]
    staged = est.coordinates["ctr"].staged
    n = 5000
    b, _ = sparse.synthetic_sparse(n, 2000, 32, seed=17)
    train, _ = _split(from_sparse_batch(b), n)  # a fresh, equal dataset
    est.fit(train)
    assert est.coordinates["ctr"].staged is staged


def test_dense_game_fit_matches_reference():
    n = 3000

    def gen(module):
        return module.game_data(
            np.random.default_rng(2026), n=n, d_global=12,
            re_specs={"userId": (150, 4), "itemId": (90, 4)},
            task="logistic")

    train, val = _split(from_synthetic(gen(synthetic)), n)
    ref_train, ref_val = _split(ref_from_synthetic(gen(ref_synthetic)), n)
    opt, ref_opt = _opt(iterations=25)
    specs = ["AUC", "AUC@userId"]
    coords = {"fixed": CoordinateConfiguration(
        FixedEffectDataConfiguration("global"), opt)}
    ref_coords = {"fixed": ref_configs.CoordinateConfiguration(
        ref_configs.FixedEffectDataConfiguration("global"), ref_opt)}
    for re_type in ("userId", "itemId"):
        coords[re_type] = CoordinateConfiguration(
            RandomEffectDataConfiguration(re_type, f"re_{re_type}",
                                          active_data_upper_bound=16), opt)
        ref_coords[re_type] = ref_configs.CoordinateConfiguration(
            ref_configs.RandomEffectDataConfiguration(
                re_type, f"re_{re_type}", active_data_upper_bound=16),
            ref_opt)
    seq = ["fixed", "userId", "itemId"]
    r = GameEstimator(TaskType.LOGISTIC_REGRESSION, coords, seq,
                      device="cpu", validation_evaluators=specs).fit(
        train, validation_data=val)[0]
    rr = RefEstimator(RefTaskType.LOGISTIC_REGRESSION, ref_coords, seq,
                      make_mesh(), validation_evaluators=specs).fit(
        ref_train, validation_data=ref_val)[0]
    _close(r.model.models["fixed"].coefficients.means,
           rr.model.models["fixed"].coefficients.means)
    for spec in specs:
        assert abs(r.evaluation.metrics[spec]
                   - rr.evaluation.metrics[spec]) <= TOL, spec
    assert len(r.history.records) == 3
    assert all("validation" in rec for rec in r.history.records)


@pytest.mark.parametrize("option,slice_no", [
    ({"streaming": object()}, 5), ({"staging": object()}, 6),
    ({"staging_cache_dir": "cache"}, 6), ({"trace": object()}, 6),
    ({"ledger_dir": "ledger"}, 6), ({"watchdog": object()}, 6),
    ({"sweep": object()}, 8), ({"ingest": object()}, 9),
    ("checkpoint_dir", 6), ("factored", 8), ("random_projector", 8)])
def test_unported_options_raise(option, slice_no):
    opt, _ = _opt()
    coords = {"ctr": CoordinateConfiguration(
        FixedEffectDataConfiguration("global", hybrid=False), opt)}
    kw = option if isinstance(option, dict) else {}
    if option == "factored":
        coords = {"u": CoordinateConfiguration(
            FactoredRandomEffectDataConfiguration("userId", "re_userId"),
            opt)}
    elif option == "random_projector":
        coords = {"u": CoordinateConfiguration(
            RandomEffectDataConfiguration("userId", "re_userId",
                                          projector="RANDOM",
                                          projected_dimension=2), opt)}
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        est = GameEstimator(TaskType.LOGISTIC_REGRESSION, coords,
                            list(coords), device="cpu", **kw)
        b, _ = sparse.synthetic_sparse(50, 20, 4, seed=0)
        ds = from_sparse_batch(b)
        ds.entity_ids["userId"] = np.zeros(50, np.int32)
        ds.num_entities["userId"] = 1
        ds.feature_shards["re_userId"] = np.ones((50, 2), np.float32)
        est.fit(ds, checkpoint_dir="ckpt" if option == "checkpoint_dir"
                else None)
