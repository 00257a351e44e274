"""Config-4-shaped GAME training: the port against the reference.

A flagship-shaped dataset at CPU scale (d_global 32, d_re 8, a few
hundred users and items, ``upper_bound`` small enough that capping
draws) goes through the reference's coordinates (on the 8-device
virtual CPU mesh) and the port's (``device="cpu"``, plain row movers):

- ``FixedEffectCoordinate`` and ``RandomEffectCoordinate.train_model``
  on the same offsets, the latter also with the reference's Pallas row
  movers switched on in interpret mode;
- a 2-iteration ``descent.run`` with per-update validation AUC;
- a reference-trained model (means and variances) carried in through
  ``game_model_from_arrays`` as a warm start.

Tolerance 5e-3 on coefficients and AUC (the band for full solves and
descents): the fixed effect's sums run in another order than the
reference's 8-way psum, and every solve stops on f32 tests.

One exception is in the problem, not the port: an entity whose training
rows all carry one label has no finite optimum, because its intercept is
not regularized (as in the reference and photon-ml). Both solvers drive
that intercept towards ±∞ until ``max_iterations`` and stop at a point
that depends on the last bits of every step. For those entities the
regularized coefficients are held to 5e-3, and the intercept either to
5e-3 or, where it ran off, to the same sign and a magnitude past 3 on
both sides (an entity whose rows the other coordinates already
saturate barely moves its intercept).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import synthetic
from photon_ml_torch.data.game_data import from_synthetic
from photon_ml_torch.evaluation.evaluators import auc
from photon_ml_torch.game import descent
from photon_ml_torch.game.coordinates import (FixedEffectCoordinate,
                                              RandomEffectCoordinate)
from photon_ml_torch.models import io as model_io
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.kernels import re_rows
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType
from photon_ml_tpu.data import synthetic as ref_synthetic
from photon_ml_tpu.data.game_data import from_synthetic as ref_from_synthetic
from photon_ml_tpu.evaluation.evaluators import auc as ref_auc
from photon_ml_tpu.game import descent as ref_descent
from photon_ml_tpu.game.coordinates import \
    FixedEffectCoordinate as RefFixedEffectCoordinate
from photon_ml_tpu.game.coordinates import \
    RandomEffectCoordinate as RefRandomEffectCoordinate
from photon_ml_tpu.models import io as ref_io
from photon_ml_tpu.ops import kernels as ref_kernels
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.optim.problem import \
    VarianceComputationType as RefVarianceType
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as RefRegularizationContext
from photon_ml_tpu.optim.regularization import \
    RegularizationType as RefRegularizationType
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import TaskType as RefTaskType

TOL = 5e-3
SEED = 2026
N_ROWS = 3000
USERS, ITEMS = 200, 120
UPPER = 16  # capacity classes 8 and 16; Zipf-head entities get capped
SEQ = ["fixed", "per-user", "per-item"]

CFG = GLMOptimizationConfiguration(
    optimizer=OptimizerConfig(max_iterations=25, tolerance=1e-7),
    regularization=RegularizationContext(RegularizationType.L2, 1.0))
REF_CFG = RefGLMConfig(
    optimizer=RefOptimizerConfig(max_iterations=25, tolerance=1e-7),
    regularization=RefRegularizationContext(RefRegularizationType.L2, 1.0))


def _split(ds, n):
    n_val = n // 20
    return ds.subset(np.arange(n - n_val)), ds.subset(np.arange(n - n_val, n))


def _gen(module):
    return module.game_data(
        np.random.default_rng(SEED), n=N_ROWS, d_global=32,
        re_specs={"userId": (USERS, 8), "itemId": (ITEMS, 8)},
        task="logistic")


@pytest.fixture(scope="module")
def data():
    train, val = _split(from_synthetic(_gen(synthetic)), N_ROWS)
    ref_train, ref_val = _split(ref_from_synthetic(_gen(ref_synthetic)),
                                N_ROWS)
    np.testing.assert_array_equal(train.feature_shards["global"],
                                  ref_train.feature_shards["global"])
    return train, val, ref_train, ref_val


def _port_coords(train, cfg=CFG):
    return {
        "fixed": FixedEffectCoordinate(train, "global", losses.LOGISTIC, cfg,
                                       device="cpu"),
        "per-user": RandomEffectCoordinate(
            train, "userId", "re_userId", losses.LOGISTIC, cfg,
            upper_bound=UPPER, rng=np.random.default_rng(0), device="cpu"),
        "per-item": RandomEffectCoordinate(
            train, "itemId", "re_itemId", losses.LOGISTIC, cfg,
            upper_bound=UPPER, rng=np.random.default_rng(0), device="cpu"),
    }


@pytest.fixture(scope="module")
def coords(data):
    train, _, ref_train, _ = data
    mesh = make_mesh()
    ref = {
        "fixed": RefFixedEffectCoordinate(ref_train, "global",
                                          ref_losses.LOGISTIC, REF_CFG, mesh),
        "per-user": RefRandomEffectCoordinate(
            ref_train, "userId", "re_userId", ref_losses.LOGISTIC, REF_CFG,
            mesh, upper_bound=UPPER, seed=0),
        "per-item": RefRandomEffectCoordinate(
            ref_train, "itemId", "re_itemId", ref_losses.LOGISTIC, REF_CFG,
            mesh, upper_bound=UPPER, seed=0),
    }
    return _port_coords(train), ref


@pytest.fixture
def kernel_registry():
    reg = ref_kernels.registry()
    reg.reset()
    yield reg
    reg.reset()


def _port_auc(model, val):
    return float(auc(model.score(val), torch.from_numpy(val.response)))


def _ref_auc(model, val):
    return float(ref_auc(model.score(val), jnp.asarray(val.response)))


@pytest.fixture(scope="module")
def descents(data, coords):
    _, val, _, ref_val = data
    port, ref = coords
    model, hist = descent.run(
        TaskType.LOGISTIC_REGRESSION, port,
        descent.CoordinateDescentConfig(SEQ, iterations=2),
        validation_fn=lambda m: {"auc": _port_auc(m, val)})
    ref_model, ref_hist = ref_descent.run(
        RefTaskType.LOGISTIC_REGRESSION, ref,
        ref_descent.CoordinateDescentConfig(SEQ, iterations=2),
        validation_fn=lambda m: {"auc": _ref_auc(m, ref_val)})
    return model, hist, ref_model, ref_hist


def _offsets(n, seed):
    return (0.3 * np.random.default_rng(seed).normal(size=n)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _single_label(coord, response):
    """(E,) entities whose trained examples all carry one label."""
    out = np.zeros(coord.num_entities, bool)
    for b in coord.bucketing.buckets:
        live = b.example_idx >= 0
        y = response[np.maximum(b.example_idx, 0)]
        mixed = (live & (y > 0.5)).any(1) & (live & (y < 0.5)).any(1)
        lanes = b.entity_rows >= 0
        out[b.entity_rows[lanes]] = ~mixed[lanes]
    return out


def _re_close(coord, got, want):
    """Random-effect tables within 5e-3, unbounded entities excepted as
    the module docstring says."""
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    one = _single_label(coord, coord.dataset.response)
    assert 0 < one.sum() < coord.bucketing.trained_entities.sum()
    _close(got[~one], want[~one])
    _close(got[one, :-1], want[one, :-1])
    b_got, b_want = got[one, -1], want[one, -1]
    ran_off = (np.sign(b_got) == np.sign(b_want)) & (np.abs(b_got) > 3) \
        & (np.abs(b_want) > 3)
    assert ran_off.any()
    _close(b_got[~ran_off], b_want[~ran_off])


def test_buckets_have_three_capacity_classes(coords):
    port, ref = coords
    for cid in ("per-user", "per-item"):
        caps = [b.capacity for b in port[cid].bucketing.buckets]
        assert caps == [8, 16]
        assert port[cid].num_waves == 2
        assert port[cid].bucketing.num_passive_examples > 0  # capped
        for g, w in zip(port[cid].bucketing.buckets,
                        ref[cid].bucketing.buckets):
            np.testing.assert_array_equal(g.example_idx, w.example_idx)


def test_fixed_effect_matches_reference(data, coords):
    train = data[0]
    port, ref = coords
    off = _offsets(train.num_rows, 1)
    got = port["fixed"].train_model(off)
    want = ref["fixed"].train_model(jnp.asarray(off))
    _close(got.coefficients.means, want.coefficients.means)
    _close(port["fixed"].score(got), ref["fixed"].score(want), tol=2 * TOL)


@pytest.mark.parametrize("movers", ["xla", "pallas_interpret"])
def test_random_effect_matches_reference(data, coords, kernel_registry,
                                         movers):
    train = data[0]
    port, ref = coords
    ref_coord = ref["per-user"]
    if movers == "pallas_interpret":
        kernel_registry.set_enabled("re_gather_rows", True)
        kernel_registry.set_enabled("re_scatter_rows", True)
        kernel_registry.force_interpret()
        # The reference resolves its row movers when it builds programs.
        ref_coord = ref_coord.with_optimization_config(REF_CFG)
        assert ref_coord._row_movers()[0] is not None
    off = _offsets(train.num_rows, 2)
    before = (re_rows.gather_rows.launches, re_rows.scatter_rows_.launches)
    got = port["per-user"].train_model(off)
    want = ref_coord.train_model(jnp.asarray(off))
    _re_close(port["per-user"], got.means, want.means)
    # Untrained entities keep zero rows in both.
    untrained = ~port["per-user"].bucketing.trained_entities
    assert untrained.any() and not got.means[untrained].any()
    # The plain row movers ran: the CPU path launches no kernel.
    assert (re_rows.gather_rows.launches,
            re_rows.scatter_rows_.launches) == before


def test_descent_matches_reference(coords, descents):
    model, hist, ref_model, ref_hist = descents
    _close(model.models["fixed"].coefficients.means,
           ref_model.models["fixed"].coefficients.means)
    for cid in ("per-user", "per-item"):
        _re_close(coords[0][cid], model.models[cid].means,
                  ref_model.models[cid].means)
    assert [(r["iteration"], r["coordinate"]) for r in hist.records] == \
        [(r["iteration"], r["coordinate"]) for r in ref_hist.records]
    aucs = [r["validation"]["auc"] for r in hist.records]
    ref_aucs = [r["validation"]["auc"] for r in ref_hist.records]
    np.testing.assert_allclose(aucs, ref_aucs, rtol=0, atol=TOL)
    assert all(0.5 < a < 1.0 for a in aucs)


def test_warm_start_from_reference_model(data, coords, descents):
    """A reference-trained model, means and variances, comes into the
    port through ``game_model_from_arrays`` and warm-starts the same
    update as in the reference; the port's coefficients go out as numpy
    through ``coordinate_arrays``."""
    train, _, ref_train, _ = data
    port, ref = coords
    ref_model = descents[2]
    simple = dataclasses.replace(
        REF_CFG, variance_computation=RefVarianceType.SIMPLE)
    off = _offsets(train.num_rows, 3)
    ref_item = ref["per-item"].with_optimization_config(simple)
    with_var = ref_item.compute_model_variances(ref_model.models["per-item"],
                                                jnp.asarray(off))
    carried = model_io.game_model_from_arrays(
        RefTaskType.LOGISTIC_REGRESSION,
        {cid: (ref_io.coordinate_meta(m), ref_io.coordinate_arrays(m))
         for cid, m in {**ref_model.models, "per-item": with_var}.items()})
    init = carried.models["per-item"]
    assert init.variances is not None
    _close(init.variances, with_var.variances, tol=0.0)

    got = port["per-item"].train_model(off, initial=init)
    want = ref["per-item"].train_model(jnp.asarray(off),
                                       initial=ref_model.models["per-item"])
    out = model_io.coordinate_arrays(got)
    assert set(out) == {"means"}
    _re_close(port["per-item"], torch.from_numpy(out["means"]), want.means)

    port_var = port["per-item"].with_optimization_config(
        dataclasses.replace(
            CFG, variance_computation=VarianceComputationType.SIMPLE))
    got_var = port_var.compute_model_variances(init, off)
    scale = float(np.max(np.asarray(with_var.variances)))
    _close(got_var.variances / scale, np.asarray(with_var.variances) / scale)

    got_fixed = port["fixed"].train_model(off, initial=carried.models["fixed"])
    want_fixed = ref["fixed"].train_model(
        jnp.asarray(off), initial=ref_model.models["fixed"])
    _close(got_fixed.coefficients.means, want_fixed.coefficients.means)


def test_initial_model_unchanged_after_train(data, coords):
    """The row scatter writes in place, so train_model copies its warm
    start: the caller's model (already scored by the descent) keeps its
    values."""
    train = data[0]
    coord = coords[0]["per-user"]
    rng = np.random.default_rng(4)
    means = torch.from_numpy(
        rng.normal(size=(USERS, 8)).astype(np.float32))
    keep = means.clone()
    initial = dataclasses.replace(coord.initial_model(), means=means)
    trained = coord.train_model(_offsets(train.num_rows, 4), initial=initial)
    assert torch.equal(initial.means, keep)
    assert trained.means.data_ptr() != means.data_ptr()
    assert not torch.equal(trained.means, keep)


def test_locked_coordinate_keeps_its_model(data, coords):
    port = coords[0]
    fixed0 = port["fixed"].train_model(np.zeros(data[0].num_rows,
                                                np.float32))
    model, hist = descent.run(
        TaskType.LOGISTIC_REGRESSION, port,
        descent.CoordinateDescentConfig(SEQ, iterations=1),
        initial_models={"fixed": fixed0}, locked_coordinates={"fixed"})
    assert model.models["fixed"] is fixed0
    assert [r["coordinate"] for r in hist.records] == ["per-user",
                                                       "per-item"]
    with pytest.raises(ValueError, match="needs an initial model"):
        descent.run(TaskType.LOGISTIC_REGRESSION, port,
                    descent.CoordinateDescentConfig(SEQ),
                    locked_coordinates={"fixed"})
    with pytest.raises(ValueError, match="unknown coordinates"):
        descent.run(TaskType.LOGISTIC_REGRESSION, port,
                    descent.CoordinateDescentConfig(["nope"]))


def test_coordinates_raise_without_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs its absence")
    train = data[0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FixedEffectCoordinate(train, "global", losses.LOGISTIC, CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RandomEffectCoordinate(train, "userId", "re_userId",
                               losses.LOGISTIC, CFG)


@pytest.mark.parametrize("option", ["projection", "subspace", "ratio",
                                    "staging_cache", "bf16",
                                    "down_sampling"])
def test_unported_options_raise(data, option):
    train = data[0]
    kw = {"projection": {"projection": True},
          "subspace": {"subspace_model": True},
          "ratio": {"features_to_samples_ratio": 0.5},
          "staging_cache": {"staging_cache_dir": "cache"},
          "bf16": {"feature_dtype": "bfloat16"}}.get(option)
    with pytest.raises(NotImplementedError, match="slice 6"):
        if kw is None:
            FixedEffectCoordinate(
                train, "global", losses.LOGISTIC,
                dataclasses.replace(CFG, down_sampling_rate=0.5),
                device="cpu")
        else:
            RandomEffectCoordinate(train, "userId", "re_userId",
                                   losses.LOGISTIC, CFG, device="cpu", **kw)
