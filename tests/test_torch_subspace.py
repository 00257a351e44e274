"""The projected and subspace random effect against the reference.

The port's ``RandomEffectCoordinate`` (``device="cpu"``) and the
reference's (on its 8-device virtual CPU mesh) fit the same seeded data:

- a dense shard with an intercept and the shard's STANDARDIZATION
  (factors and shifts, projected per lane), projected with and without
  the Pearson cap, and in subspace form;
- a sparse (ELL) shard at d = 100,000 in subspace form (the flagship's
  shape, cut to size) and as a projected (E, d) table.

Coefficients agree within 5e-3 (the band for full solves), the column
maps exactly, and one model's scores through either package's
coordinate within 1e-5. Warm starts (dense → subspace, subspace → dense,
a remap between two active sets) equal the reference's exactly, and the
fits from them within 5e-3; variances on the projected and the subspace
path within 5e-3 relative. The subspace path moves its rows through the
``re_rows`` wrappers, one gather and one scatter a wave, as many as its
``re.fit_wave`` spans; the projected (E, d) path through index ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch import obs
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.game.coordinates import RandomEffectCoordinate
from photon_ml_torch.game.models import (RandomEffectModel,
                                         SubspaceRandomEffectModel)
from photon_ml_torch.game.staging import StagingConfig
from photon_ml_torch.normalization import NormalizationContext
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.kernels import re_rows
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_tpu.data.game_data import GameDataset as RefGameDataset
from photon_ml_tpu.data.game_data import SparseShard as RefSparseShard
from photon_ml_tpu.game.coordinates import \
    RandomEffectCoordinate as RefRandomEffectCoordinate
from photon_ml_tpu.game.models import \
    RandomEffectModel as RefRandomEffectModel
from photon_ml_tpu.game.models import \
    SubspaceRandomEffectModel as RefSubspaceModel
from photon_ml_tpu.normalization import \
    NormalizationContext as RefNormalizationContext
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

TOL = 5e-3
SCORE_TOL = 1e-5


def _configs(iterations=50, variances=False):
    kind = "SIMPLE" if variances else "NONE"
    port = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=iterations, tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0),
        variance_computation=VarianceComputationType(kind))
    ref = RefGLMConfig(
        optimizer=RefOptimizerConfig(max_iterations=iterations,
                                     tolerance=1e-7),
        regularization=RefRegularizationContext(RefRegularizationType.L2,
                                                1.0),
        variance_computation=RefVarianceType(kind))
    return port, ref


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- data ---------------------------------------------------------------------

def _dense_arrays(n=1500, E=60, d=24, seed=0):
    """Each entity uses about half of the columns; column 0 is the
    intercept; ~25 rows an entity, so every intercept has a finite
    optimum."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, n).astype(np.int32)
    emask = rng.random((E, d)) < 0.5
    X = (rng.normal(0.5, 2.0, size=(n, d)) * (rng.random((n, d)) < 0.6)
         * emask[ids]).astype(np.float32)
    X[:, 0] = 1.0
    beta = rng.normal(size=(E, d)) * 0.3
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(X * beta[ids]).sum(1)))
         ).astype(np.float32)
    f = (1.0 / np.maximum(X.std(0), 1e-3)).astype(np.float32)
    s = X.mean(0).astype(np.float32)
    f[0], s[0] = 1.0, 0.0
    return dict(ids=ids, X=X, y=y, E=E, f=f, s=s)


def _sparse_arrays(n=6000, E=600, d=100_000, seed=7):
    """The flagship's generator (per-entity 16-column pools, 8 nonzeros a
    row, planted coefficients) at CPU size."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, size=n).astype(np.int32)
    pools = rng.integers(0, d, size=(E, 16)).astype(np.int32)
    slot = rng.integers(0, 16, size=(n, 8))
    idx = np.sort(pools[ids[:, None], slot], axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    idx[dup] = d
    vals[dup] = 0.0
    beta = rng.normal(size=(E, 16)).astype(np.float32)
    margin = (np.where(dup, 0.0, vals) * beta[ids[:, None], slot]).sum(1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return dict(ids=ids, idx=idx, vals=vals, y=y, E=E, d=d)


def _dense_ds(a, ref):
    GD = RefGameDataset if ref else GameDataset
    n = a["X"].shape[0]
    return GD(response=a["y"].copy(), offsets=np.zeros(n, np.float32),
              weights=np.ones(n, np.float32),
              feature_shards={"re": a["X"].copy()},
              entity_ids={"u": a["ids"].copy()}, num_entities={"u": a["E"]},
              intercept_index={"re": 0})


def _sparse_ds(a, ref):
    GD, SS = ((RefGameDataset, RefSparseShard) if ref
              else (GameDataset, SparseShard))
    n = a["ids"].shape[0]
    return GD(response=a["y"].copy(), offsets=np.zeros(n, np.float32),
              weights=np.ones(n, np.float32),
              feature_shards={"re": SS(a["idx"].copy(), a["vals"].copy(),
                                       a["d"])},
              entity_ids={"u": a["ids"].copy()}, num_entities={"u": a["E"]},
              intercept_index={})


def _pair(a, kind, variances=False, iterations=50, **kw):
    """The port's and the reference's coordinate on the same data."""
    cfg, ref_cfg = _configs(iterations, variances)
    norm = ref_norm = {}
    if kind == "dense":
        norm = {"norm": NormalizationContext(torch.from_numpy(a["f"]),
                                             torch.from_numpy(a["s"]), 0)}
        ref_norm = {"norm": RefNormalizationContext(
            jnp.asarray(a["f"]), jnp.asarray(a["s"]), 0)}
        ds, rds = _dense_ds(a, False), _dense_ds(a, True)
    else:
        ds, rds = _sparse_ds(a, False), _sparse_ds(a, True)
    port = RandomEffectCoordinate(ds, "u", "re", losses.LOGISTIC, cfg,
                                  lower_bound=2, device="cpu", **norm, **kw)
    ref = RefRandomEffectCoordinate(rds, "u", "re", ref_losses.LOGISTIC,
                                    ref_cfg, make_mesh(), lower_bound=2,
                                    **ref_norm, **kw)
    return port, ref


def _as_port(model):
    """A reference model as the port's type (the same arrays)."""
    if isinstance(model, RefSubspaceModel):
        return SubspaceRandomEffectModel(
            model.re_type, model.shard_id, model.num_features,
            torch.from_numpy(np.array(model.cols)),
            torch.from_numpy(np.array(model.means)))
    return RandomEffectModel(model.re_type, model.shard_id,
                             torch.from_numpy(np.array(model.means)))


def _as_ref(model):
    if isinstance(model, SubspaceRandomEffectModel):
        return RefSubspaceModel(model.re_type, model.shard_id,
                                model.num_features,
                                jnp.asarray(_host(model.cols)),
                                jnp.asarray(_host(model.means)))
    return RefRandomEffectModel(model.re_type, model.shard_id,
                                jnp.asarray(_host(model.means)))


def _check_fit(port, ref, offsets, initial=None, ref_initial=None):
    got = port.train_model(offsets, initial)
    want = ref.train_model(jnp.asarray(offsets), ref_initial)
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, SubspaceRandomEffectModel):
        np.testing.assert_array_equal(_host(got.cols), _host(want.cols))
    np.testing.assert_allclose(_host(got.means), _host(want.means), rtol=0,
                               atol=TOL)
    # One model, scored by each package's coordinate.
    np.testing.assert_allclose(_host(port.score(_as_port(want))),
                               _host(ref.score(want)), rtol=0,
                               atol=SCORE_TOL)
    return got, want


# -- fits ---------------------------------------------------------------------

@pytest.mark.parametrize("ratio,subspace", [(None, False), (0.3, False),
                                            (0.3, True)])
def test_projected_dense_fit_with_normalization(ratio, subspace):
    a = _dense_arrays()
    port, ref = _pair(a, "dense", projection=True,
                      features_to_samples_ratio=ratio,
                      subspace_model=subspace)
    assert port.projection and port.subspace == subspace
    assert not port.is_sparse
    off = (0.1 * np.random.default_rng(3).normal(
        size=a["y"].shape[0])).astype(np.float32)
    got, want = _check_fit(port, ref, off)
    # The per-lane transform folds each entity's shift into its intercept:
    # a second fit from the first keeps the band.
    _check_fit(port, ref, off, got, want)


@pytest.mark.parametrize("subspace", [True, False])
def test_sparse_fit_matches_reference(subspace):
    a = _sparse_arrays(d=100_000 if subspace else 2_000)
    port, ref = _pair(a, "sparse", iterations=12, subspace_model=subspace)
    assert port.is_sparse and port.projection
    assert port.subspace == subspace
    if subspace:
        np.testing.assert_array_equal(port.subspace_cols, ref.subspace_cols)
        np.testing.assert_array_equal(_host(port._sp_flatpos),
                                      _host(ref._sp_flatpos))
    _check_fit(port, ref, np.zeros(a["y"].shape[0], np.float32))


def test_subspace_is_automatic_above_the_dense_table_limit():
    a = _sparse_arrays(n=800, E=300, d=1_000_000)
    port, ref = _pair(a, "sparse", iterations=3)
    assert port.subspace and ref.subspace  # 3e8 entries > 2^28
    a = _sparse_arrays(n=800, E=300, d=100_000)
    port, ref = _pair(a, "sparse", iterations=3)
    assert not port.subspace and not ref.subspace
    with pytest.raises(ValueError, match="requires projection"):
        d = _dense_arrays()
        RandomEffectCoordinate(_dense_ds(d, False), "u", "re",
                               losses.LOGISTIC, _configs()[0],
                               subspace_model=True, device="cpu")


def test_sparse_shard_refuses_normalization():
    a = _sparse_arrays(n=500, E=50, d=1000)
    with pytest.raises(ValueError, match="normalization is not supported"):
        RandomEffectCoordinate(
            _sparse_ds(a, False), "u", "re", losses.LOGISTIC, _configs()[0],
            norm=NormalizationContext(torch.ones(1000)), device="cpu")


# -- warm starts --------------------------------------------------------------

def test_dense_to_subspace_and_back():
    a = _sparse_arrays(n=3000, E=300, d=2_000)
    port, ref = _pair(a, "sparse", iterations=12, subspace_model=True)
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(300, 2000)).astype(np.float32)
    got = port.adapt_initial(RandomEffectModel("u", "re",
                                               torch.from_numpy(dense)))
    want = ref.adapt_initial(RefRandomEffectModel("u", "re",
                                                  jnp.asarray(dense)))
    assert isinstance(got, SubspaceRandomEffectModel)
    np.testing.assert_array_equal(_host(got.cols), _host(want.cols))
    assert _host(got.means).tobytes() == _host(want.means).tobytes()
    off = np.zeros(a["y"].shape[0], np.float32)
    _check_fit(port, ref, off, got, want)
    # Subspace → the projected (E, d) coordinate: the dense table.
    flat, rflat = _pair(a, "sparse", iterations=12, subspace_model=False)
    back = flat.adapt_initial(got)
    rback = rflat.adapt_initial(want)
    assert isinstance(back, RandomEffectModel)
    assert _host(back.means).tobytes() == _host(rback.means).tobytes()
    _check_fit(flat, rflat, off, back, rback)


def test_subspace_remap_between_active_sets():
    """A subspace model over one coordinate's active sets, carried into
    a coordinate whose entities keep fewer rows (upper_bound): columns
    still active keep their coefficients, the rest drop."""
    a = _sparse_arrays(n=4000, E=300, d=50_000)
    src, rsrc = _pair(a, "sparse", iterations=8, subspace_model=True)
    off = np.zeros(a["y"].shape[0], np.float32)
    model, rmodel = _check_fit(src, rsrc, off)
    dst, rdst = _pair(a, "sparse", iterations=8, subspace_model=True,
                      upper_bound=6)
    assert not np.array_equal(dst.subspace_cols, src.subspace_cols)
    got = dst.adapt_initial(_as_port(rmodel))
    want = rdst.adapt_initial(rmodel)
    np.testing.assert_array_equal(_host(got.cols), dst.subspace_cols)
    assert _host(got.means).tobytes() == _host(want.means).tobytes()
    _check_fit(dst, rdst, off, got, want)


# -- variances ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_variances_on_both_paths(kind):
    if kind == "dense":
        a = _dense_arrays()
        port, ref = _pair(a, "dense", variances=True, projection=True,
                          features_to_samples_ratio=0.3)
        off = np.zeros(a["y"].shape[0], np.float32)
    else:
        a = _sparse_arrays(n=4000, E=400, d=100_000)
        port, ref = _pair(a, "sparse", variances=True, iterations=12,
                          subspace_model=True)
        off = np.zeros(a["y"].shape[0], np.float32)
    got, want = _check_fit(port, ref, off)
    # Variances at the reference's optimum on both sides: the Hessian
    # paths alone.
    vg = port.compute_model_variances(_as_port(want), off).variances
    vw = ref.compute_model_variances(want, jnp.asarray(off)).variances
    vg, vw = _host(vg), _host(vw)
    assert np.isfinite(vg).all()
    np.testing.assert_allclose(vg, vw, rtol=TOL, atol=1e-6)


# -- the row movers on the subspace path --------------------------------------

def _counting(monkeypatch):
    calls = {"gather": 0, "scatter": 0}
    gather, scatter = re_rows.gather_rows, re_rows.scatter_rows_

    def g(W, rows):
        calls["gather"] += 1
        return gather(W, rows)

    def s(W, rows, vals):
        calls["scatter"] += 1
        return scatter(W, rows, vals)

    monkeypatch.setattr(re_rows, "gather_rows", g)
    monkeypatch.setattr(re_rows, "scatter_rows_", s)
    return calls


@pytest.mark.parametrize("subspace", [True, False])
def test_row_movers_launch_once_a_wave(monkeypatch, subspace):
    a = _sparse_arrays(n=4000, E=2000, d=3_000)
    cfg, _ = _configs(5)
    coord = RandomEffectCoordinate(
        _sparse_ds(a, False), "u", "re", losses.LOGISTIC, cfg,
        lower_bound=1, subspace_model=subspace, device="cpu",
        staging=StagingConfig(shard_entities=256))
    calls = _counting(monkeypatch)
    tracer = obs.Tracer()
    with obs.activated(tracer):
        coord.train_model(np.zeros(4000, np.float32))
    spans = sum(1 for e in tracer.chrome_trace()["traceEvents"]
                if e.get("ph") == "X" and e["name"] == "re.fit_wave")
    assert spans == coord.num_waves > 3
    if subspace:
        assert calls == {"gather": spans, "scatter": spans}
    else:
        assert calls == {"gather": 0, "scatter": 0}
