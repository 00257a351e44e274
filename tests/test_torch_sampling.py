"""Down-sampling in the port against the reference.

- The samplers (``game/sampling.py``) against the reference's over
  several seeds, rates and label mixes: the indices and multipliers are
  bit-equal (both draw from ``np.random.Generator`` on the host).
- ``draw_down_sample`` dispatches on the task's loss, and advancing the
  generator k steps equals k draws.
- Down-sampled fits of the dense ``FixedEffectCoordinate`` (float32 and
  bfloat16 storage) and of ``SparseFixedEffectCoordinate`` on ELL and on
  the hybrid layout, from the same seed, against the reference's: the
  same subsets, so the same objective. Tolerances: rtol 1e-4 and atol
  1e-5 on the converged dense fit (the checkpoint tests' band), 5e-3 on
  fits cut at 10 iterations (bfloat16; the band for unconverged solves),
  and on the sparse fits the 5e-3 band of full sparse solves with their
  objective values within 1e-6 relative (see that test).
- ``with_optimization_config`` reseeds the generator, and the hybrid
  layout's weight-masked objective equals ELL's row-gathered one.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import sparse, synthetic
from photon_ml_torch.data.game_data import from_sparse_batch, from_synthetic
from photon_ml_torch.game import sampling
from photon_ml_torch.game.coordinates import (FixedEffectCoordinate,
                                              SparseFixedEffectCoordinate)
from photon_ml_torch.game.coordinates._down_sampling import (
    _advance_down_sampling, draw_down_sample)
from photon_ml_torch.ops import losses, sparse_aggregators
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data import synthetic as ref_synthetic
from photon_ml_tpu.data.game_data import \
    from_sparse_batch as ref_from_sparse_batch
from photon_ml_tpu.data.game_data import from_synthetic as ref_from_synthetic
from photon_ml_tpu.game import sampling as ref_sampling
from photon_ml_tpu.game.coordinates import \
    FixedEffectCoordinate as RefFixedEffectCoordinate
from photon_ml_tpu.game.coordinates import \
    SparseFixedEffectCoordinate as RefSparseCoordinate
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as RefRegularization
from photon_ml_tpu.optim.regularization import \
    RegularizationType as RefRegType
from photon_ml_tpu.parallel.mesh import make_mesh

RTOL, ATOL = 1e-4, 1e-5  # converged fits
TOL = 5e-3  # fits cut short
RATE = 0.5


def _configs(iterations=100, rate=RATE):
    port = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=iterations, tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0),
        down_sampling_rate=rate)
    ref = RefGLMConfig(
        optimizer=RefOptimizerConfig(max_iterations=iterations,
                                     tolerance=1e-7),
        regularization=RefRegularization(RefRegType.L2, 1.0),
        down_sampling_rate=rate)
    return port, ref


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _labels(mix, n, seed):
    rng = np.random.default_rng(seed + 100)
    if mix == "balanced":
        return (rng.random(n) < 0.5).astype(np.float32)
    if mix == "rare":
        return (rng.random(n) < 0.03).astype(np.float32)
    if mix == "signed":  # ±1 labels: negatives are the non-positive ones
        return np.where(rng.random(n) < 0.3, 1.0, -1.0).astype(np.float32)
    return np.zeros(n, np.float32)  # "none": no positive at all


@pytest.mark.parametrize("seed", [0, 9, 2026])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.93])
def test_default_sampler_bit_equal(seed, rate):
    for n in (1, 7, 1000):
        idx, mult = sampling.default_down_sample(
            np.random.default_rng(seed), n, rate)
        ref_idx, ref_mult = ref_sampling.default_down_sample(
            np.random.default_rng(seed), n, rate)
        np.testing.assert_array_equal(idx, ref_idx)
        assert mult.dtype == ref_mult.dtype == np.float32
        assert mult.tobytes() == ref_mult.tobytes()
        assert len(idx) == max(1, int(round(n * rate)))
        assert len(np.unique(idx)) == len(idx)


@pytest.mark.parametrize("seed", [0, 9, 2026])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.93])
@pytest.mark.parametrize("mix", ["balanced", "rare", "signed", "none"])
def test_binary_sampler_bit_equal(seed, rate, mix):
    y = _labels(mix, 2000, seed)
    idx, mult = sampling.binary_classification_down_sample(
        np.random.default_rng(seed), y, rate)
    ref_idx, ref_mult = ref_sampling.binary_classification_down_sample(
        np.random.default_rng(seed), y, rate)
    np.testing.assert_array_equal(idx, ref_idx)
    assert mult.tobytes() == ref_mult.tobytes()
    pos = int((y > 0).sum())
    # Every positive kept at weight 1; the negatives sampled at 1/rate.
    np.testing.assert_array_equal(idx[:pos], np.where(y > 0)[0])
    assert np.all(mult[:pos] == 1.0)
    assert np.all(mult[pos:] == np.float32(1.0 / rate))


def _stub(loss, labels, rate=RATE, seed=3):
    return types.SimpleNamespace(
        loss=loss, _rng=np.random.default_rng(seed),
        dataset=types.SimpleNamespace(response=labels,
                                      num_rows=len(labels)),
        config=GLMOptimizationConfiguration(down_sampling_rate=rate))


@pytest.mark.parametrize("loss,binary", [
    (losses.LOGISTIC, True), (losses.SMOOTHED_HINGE, True),
    (losses.SQUARED, False), (losses.POISSON, False)])
def test_draw_dispatches_on_loss(loss, binary):
    y = _labels("rare", 500, 4)
    idx, mult = draw_down_sample(_stub(loss, y), RATE)
    if binary:
        want = ref_sampling.binary_classification_down_sample(
            np.random.default_rng(3), y, RATE)
    else:
        want = ref_sampling.default_down_sample(
            np.random.default_rng(3), len(y), RATE)
    np.testing.assert_array_equal(idx, want[0])
    assert mult.tobytes() == want[1].tobytes()


@pytest.mark.parametrize("loss", [losses.LOGISTIC, losses.SQUARED])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_advance_equals_k_draws(loss, k):
    y = _labels("balanced", 300, 1)
    advanced, drawn = _stub(loss, y), _stub(loss, y)
    _advance_down_sampling(advanced, k)
    for _ in range(k):
        draw_down_sample(drawn, RATE)
    a, b = draw_down_sample(advanced, RATE), draw_down_sample(drawn, RATE)
    np.testing.assert_array_equal(a[0], b[0])
    # At rate 1 the generator does not move.
    full = _stub(loss, y, rate=1.0)
    _advance_down_sampling(full, 5)
    assert full._rng.bit_generator.state == \
        np.random.default_rng(3).bit_generator.state


# -- dense fixed effect ----------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    def gen(module):
        return module.game_data(np.random.default_rng(5), n=1500,
                                d_global=12, re_specs={}, task="logistic")

    ds = from_synthetic(gen(synthetic))
    rds = ref_from_synthetic(gen(ref_synthetic))
    offsets = (0.2 * np.random.default_rng(6).normal(size=ds.num_rows)
               ).astype(np.float32)
    return ds, rds, offsets


@pytest.mark.parametrize("dtype,iterations", [("float32", 100),
                                              ("bfloat16", 10)])
def test_dense_down_sampled_fit_matches_reference(dense, dtype, iterations):
    """Two consecutive train_model calls (two draws) against the
    reference's. bfloat16 is held at 10 iterations: rounding makes the
    objective a step function, and two correct solvers part later."""
    ds, rds, offsets = dense
    cfg, ref_cfg = _configs(iterations)
    coord = FixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                  down_sampling_seed=11,
                                  feature_dtype=dtype, device="cpu")
    # The reference on one device, as the port runs: on the test suite's
    # 8-device mesh its psum reorders the sums, which alone moves its
    # coefficients by ~1e-4.
    ref = RefFixedEffectCoordinate(rds, "global", ref_losses.LOGISTIC,
                                   ref_cfg, _mesh1(),
                                   down_sampling_seed=11,
                                   feature_dtype=dtype)
    w = [coord.train_model(offsets).coefficients.means for _ in range(2)]
    rw = [ref.train_model(jnp.asarray(offsets)).coefficients.means
          for _ in range(2)]
    assert not torch.equal(w[0], w[1])  # two draws, two subsets
    for got, want in zip(w, rw):
        if dtype == "float32":
            np.testing.assert_allclose(_host(got), _host(want), rtol=RTOL,
                                       atol=ATOL)
        else:
            np.testing.assert_allclose(_host(got), _host(want), rtol=0,
                                       atol=TOL)


def test_dense_sampled_batch_keeps_bfloat16_storage(dense, monkeypatch):
    """The gathered subset keeps the stored dtype: no float32 copy of the
    sampled rows."""
    from photon_ml_torch.optim import problem

    ds, _, offsets = dense
    seen = []
    run = problem.run

    def spy(loss, batch, *a, **k):
        seen.append((batch.features.dtype, batch.num_rows,
                     float(batch.weights.max())))
        return run(loss, batch, *a, **k)

    monkeypatch.setattr(problem, "run", spy)
    cfg, _ = _configs(5)
    coord = FixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                  feature_dtype="bfloat16", device="cpu")
    coord.train_model(offsets)
    idx, _ = sampling.binary_classification_down_sample(
        np.random.default_rng(0), ds.response, RATE)
    assert seen == [(torch.bfloat16, len(idx), 2.0)]


def test_dense_grid_copies_reseed(dense):
    ds, _, offsets = dense
    cfg, _ = _configs(30)
    coord = FixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                  device="cpu")
    first = coord.train_model(offsets).coefficients.means
    copy = coord.with_optimization_config(cfg)
    assert torch.equal(copy.train_model(offsets).coefficients.means, first)
    # The original's generator moved on: its next draw is another subset.
    assert not torch.equal(coord.train_model(offsets).coefficients.means,
                           first)


# -- sparse fixed effect ---------------------------------------------------

@pytest.fixture(scope="module")
def sparse_data():
    """test_sparse_game.py's down-sampling fixture: 2048 Zipf rows over
    64 columns, 6 slots, seed 7."""
    b, _ = sparse.synthetic_sparse(2048, 64, 6, seed=7)
    rb, _ = ref_sparse.synthetic_sparse(2048, 64, 6, seed=7)
    np.testing.assert_array_equal(b.indices.numpy(), rb.indices)
    return from_sparse_batch(b), ref_from_sparse_batch(rb)


def _mesh1():
    return make_mesh(num_data=1, devices=jax.devices()[:1])


@pytest.mark.parametrize("hybrid", [False, True])
def test_sparse_down_sampled_fit_matches_reference(sparse_data, hybrid):
    """Two draws against the reference's. The subsampled objective is the
    same (the same masked weights); both solvers stop on its float32
    value, which resolves ~1e-4 of it, so their objective values are held
    to 1e-6 relative (the same minimum). On ELL the coefficients are held
    to the 5e-3 band of full sparse solves. On the hybrid layout two
    float32 L-BFGS runs stop at different points of a flat minimum, so
    the coefficients are held to that minimum itself: the port lies no
    farther from the float64 minimiser of the masked objective than the
    reference does."""
    ds, rds = sparse_data
    cfg, ref_cfg = _configs()
    off = np.zeros(ds.num_rows, np.float32)
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        down_sampling_seed=9,
                                        hybrid=hybrid, device="cpu")
    ref = RefSparseCoordinate(rds, "global", ref_losses.LOGISTIC, ref_cfg,
                              _mesh1(), down_sampling_seed=9, hybrid=hybrid)
    rng = np.random.default_rng(9)
    for _ in range(2):
        got = coord.train_model(off).coefficients.means
        want = ref.train_model(jnp.asarray(off)).coefficients.means
        idx, mult = sampling.binary_classification_down_sample(
            rng, ds.response, RATE)
        assert coord.last_solve["sampled_rows"] == len(idx)
        assert coord.last_solve["sample_seconds"] >= 0.0
        mask = np.zeros(ds.num_rows, np.float32)
        mask[idx] = ds.weights[idx] * mult
        if hybrid:
            w_star = _minimiser(ds, mask)
            gap = np.abs(_host(got).astype(np.float64) - w_star).max()
            ref_gap = np.abs(_host(want).astype(np.float64) - w_star).max()
            assert gap <= ref_gap, (gap, ref_gap)
        else:
            np.testing.assert_allclose(_host(got), _host(want), rtol=0,
                                       atol=TOL)
        f, f_ref = (_objective(ds, torch.from_numpy(np.array(_host(w))),
                               mask) for w in (got, want))
        assert abs(f - f_ref) <= 1e-6 * abs(f_ref), (f, f_ref)


def _objective(ds, w, weights):
    """The L2-regularized logistic objective over the ELL shard with the
    given per-row weights, in float64."""
    shard = ds.feature_shards["global"]
    b = sparse.SparseBatch(
        torch.from_numpy(shard.indices), torch.from_numpy(shard.values),
        torch.from_numpy(ds.response), torch.from_numpy(weights),
        torch.zeros(ds.num_rows), shard.num_features)
    z = sparse_aggregators.margins(b, w).double()
    y = b.labels.double()
    loss = torch.nn.functional.softplus(z) - y * z
    return float((b.weights.double() * loss).sum()
                 + 0.5 * (w.double() ** 2).sum())


def _minimiser(ds, weights, gtol=1e-10):
    """The float64 minimiser of ``_objective``'s masked objective, by
    Newton's method on the dense (n, d) matrix (d = 64: a few steps)."""
    shard = ds.feature_shards["global"]
    n, d = shard.shape
    X = np.zeros((n, d + 1))
    np.add.at(X, (np.arange(n)[:, None], shard.indices), shard.values)
    X = torch.from_numpy(X[:, :d])
    y = torch.from_numpy(ds.response.astype(np.float64))
    m = torch.from_numpy(weights.astype(np.float64))
    w = torch.zeros(d, dtype=torch.float64)
    for _ in range(100):
        p = torch.sigmoid(X @ w)
        g = X.T @ (m * (p - y)) + w
        if float(g.abs().max()) <= gtol:
            return w.numpy()
        H = X.T @ (X * (m * p * (1.0 - p))[:, None]) \
            + torch.eye(d, dtype=torch.float64)
        w = w - torch.linalg.solve(H, g)
    raise AssertionError(f"Newton did not reach {gtol}: "
                         f"{float(g.abs().max())}")


def test_hybrid_masked_objective_equals_ell(sparse_data):
    """Weight-masked down-sampling == ELL's row-gathered subsets: same
    seed, same draws, the same subsampled objective (relative 1e-5, the
    reference's test_hybrid_down_sampling_matches_ell)."""
    ds, _ = sparse_data
    cfg, _ = _configs()
    off = np.zeros(ds.num_rows, np.float32)
    w = {h: SparseFixedEffectCoordinate(
            ds, "global", losses.LOGISTIC, cfg, down_sampling_seed=9,
            hybrid=h, device="cpu").train_model(off).coefficients.means
         for h in (False, True)}
    idx, mult = sampling.binary_classification_down_sample(
        np.random.default_rng(9), ds.response, RATE)
    mask = np.zeros(ds.num_rows, np.float32)
    mask[idx] = ds.weights[idx] * mult
    f_e = _objective(ds, w[False], mask)
    f_h = _objective(ds, w[True], mask)
    assert abs(f_e - f_h) < 1e-5 * abs(f_e), (f_e, f_h)


@pytest.mark.parametrize("hybrid", [False, True])
def test_sparse_grid_copies_reseed(sparse_data, hybrid):
    ds, _ = sparse_data
    cfg, _ = _configs(20)
    off = np.zeros(ds.num_rows, np.float32)
    coord = SparseFixedEffectCoordinate(ds, "global", losses.LOGISTIC, cfg,
                                        hybrid=hybrid, device="cpu")
    first = coord.train_model(off).coefficients.means
    copy = coord.with_optimization_config(
        dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, max_iterations=20)))
    assert torch.equal(copy.train_model(off).coefficients.means, first)
    assert not torch.equal(coord.train_model(off).coefficients.means, first)
