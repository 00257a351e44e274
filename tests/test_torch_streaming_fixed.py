"""The port's row-streamed sparse fixed effect against the reference.

A config-5 shaped fixture at CPU scale (Zipf(1.3) columns, an intercept
column in every row, base offsets in the data) is staged into int8,
bfloat16 and float32 hot/cold chunks (three chunks, a short tail) and
fitted in a 2-iteration coordinate descent by the reference's
``StreamingSparseFixedEffectCoordinate`` and the port's (``device="cpu"``,
the plain kernels), and by the port's resident
``SparseFixedEffectCoordinate``: coefficients and scores within 5e-3 (the
band for full solves), under L2 (L-BFGS) and elastic net (OWL-QN); both
keep the optimum unique, which an L1-only fit over tail columns seen in
one or two rows need not. ``GameEstimator(streaming=...)`` routes the sparse
fixed effect onto the streamed path and fits; a descent killed mid-fit
resumes from the streamed coordinate's step checkpoint to the same bits;
every option this slice leaves out raises and names the slice that ports
it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                         FixedEffectDataConfiguration,
                                         StreamingConfig)
from photon_ml_torch.api.estimator import GameEstimator
from photon_ml_torch.data import sparse
from photon_ml_torch.data.game_data import from_sparse_batch
from photon_ml_torch.game import descent
from photon_ml_torch.game.coordinates import (
    SparseFixedEffectCoordinate, StreamingSparseFixedEffectCoordinate)
from photon_ml_torch.ops import losses
from photon_ml_torch.ops import streaming_sparse as ss
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType
from photon_ml_tpu.api.configs import StreamingConfig as RefStreamingConfig
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data.game_data import \
    from_sparse_batch as ref_from_sparse_batch
from photon_ml_tpu.game import descent as ref_descent
from photon_ml_tpu.game.coordinates import \
    StreamingSparseFixedEffectCoordinate as RefCoordinate
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as RefRegularization
from photon_ml_tpu.optim.regularization import \
    RegularizationType as RefRegType
from photon_ml_tpu.types import TaskType as RefTaskType

TOL = 5e-3
N, DIM, NNZ = 1200, 200, 8
STREAMING = dict(chunk_rows=512, num_hot=24, workers=2)
NOT_PORTED = type(not_ported("x", 0))


@pytest.fixture(scope="module")
def data():
    """Zipf data with column DIM−1 set to 1.0 in slot 0 of every row (the
    unregularized intercept) and base offsets in the dataset."""
    b, _ = ref_sparse.synthetic_sparse(N, DIM, NNZ, seed=21)
    idx, val = np.array(b.indices), np.array(b.values)
    hit = idx == DIM - 1
    idx[hit], val[hit] = DIM, 0.0
    idx[:, 0], val[:, 0] = DIM - 1, 1.0
    y = np.asarray(b.labels)
    off = (0.3 * np.random.default_rng(2).normal(size=N)).astype(np.float32)
    t = torch.from_numpy
    ds = from_sparse_batch(sparse.SparseBatch(
        t(idx), t(val), t(y), torch.ones(N), t(off), DIM))
    rds = ref_from_sparse_batch(ref_sparse.SparseBatch(
        idx, val, y, np.ones(N, np.float32), off, DIM))
    ds.intercept_index["global"] = DIM - 1
    rds.intercept_index["global"] = DIM - 1
    return ds, rds


def _configs(reg="L2", weight=1.0, **extra):
    """Solves run close to the optimum (relative change 1e-9), so the
    streamed Armijo L-BFGS and the resident strong-Wolfe one meet."""
    port = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=200, tolerance=1e-9),
        regularization=RegularizationContext(RegularizationType(reg),
                                             weight), **extra)
    ref = RefGLMConfig(
        optimizer=RefOptimizerConfig(max_iterations=200, tolerance=1e-9),
        regularization=RefRegularization(RefRegType(reg), weight))
    return port, ref


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _stage(ds, cfg, dtype, **kw):
    return StreamingSparseFixedEffectCoordinate.stage(
        ds, "global", losses.LOGISTIC, cfg, None,
        StreamingConfig(feature_dtype=dtype, **STREAMING, **kw),
        device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("reg,weight", [("L2", 1.0), ("ELASTIC_NET", 2.0)])
def test_descent_matches_reference_and_resident(data, dtype, reg, weight):
    ds, rds = data
    cfg, ref_cfg = _configs(reg, weight)
    coord = _stage(ds, cfg, dtype, pin_chunks=1)
    assert coord.chunked.num_chunks == 3 and coord.dim == DIM
    ref = RefCoordinate.stage(
        rds, "global", ref_losses.LOGISTIC, ref_cfg, None,
        RefStreamingConfig(feature_dtype=dtype, **STREAMING))
    model, hist = descent.run(
        TaskType.LOGISTIC_REGRESSION, {"fixed": coord},
        descent.CoordinateDescentConfig(["fixed"], iterations=2))
    ref_model, _ = ref_descent.run(
        RefTaskType.LOGISTIC_REGRESSION, {"fixed": ref},
        ref_descent.CoordinateDescentConfig(["fixed"], iterations=2))
    w = model.models["fixed"].coefficients.means
    _close(w, ref_model.models["fixed"].coefficients.means)
    _close(coord.score(model.models["fixed"]),
           ref.score(ref_model.models["fixed"]), tol=TOL * 10)
    solve = hist.records[-1]["solver"]
    l1 = reg == "ELASTIC_NET"
    assert solve["optimizer"] == ("OWLQN" if l1 else "LBFGS")
    assert solve["gradient_evaluations"] >= solve["iterations"] >= 1
    if l1:  # OWL-QN zeroes coefficients exactly
        assert int((w == 0).sum()) > DIM // 4
    if dtype == "float32":
        # The resident ELL coordinate fits the same objective.
        resident = SparseFixedEffectCoordinate(
            ds, "global", losses.LOGISTIC, cfg, hybrid=False, device="cpu")
        res_model, _ = descent.run(
            TaskType.LOGISTIC_REGRESSION, {"fixed": resident},
            descent.CoordinateDescentConfig(["fixed"], iterations=2))
        _close(w, res_model.models["fixed"].coefficients.means)


def test_score_is_pure_margins(data):
    """Chunks are staged with zero offsets: ``score`` gives Xw alone."""
    ds, _ = data
    cfg, _ = _configs()
    coord = _stage(ds, cfg, "float32")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=DIM).astype(np.float32))
    model = dataclasses.replace(coord.initial_model(), coefficients=type(
        coord.initial_model().coefficients)(w))
    shard = ds.feature_shards["global"]
    want = np.einsum("nk,nk->n", shard.values,
                     np.append(w.numpy(), 0.0)[shard.indices])
    np.testing.assert_allclose(coord.score(model).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert coord.stream.passes["margins"] == 1


def _estimator(streaming, data_config=None, **kw):
    cfg, _ = _configs()
    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinates={"ctr": CoordinateConfiguration(
            data=data_config or FixedEffectDataConfiguration(
                "global", hybrid=False),
            optimization=cfg, reg_weight_grid=(1.0, 3.0))},
        update_sequence=["ctr"], device="cpu",
        validation_evaluators=["AUC"], streaming=streaming, **kw)


def test_estimator_routes_and_fits(data):
    ds, _ = data
    est = _estimator(StreamingConfig(feature_dtype="int8", **STREAMING))
    results = est.fit(ds, validation_data=ds)
    assert len(results) == 2
    assert isinstance(est.coordinates["ctr"],
                      StreamingSparseFixedEffectCoordinate)
    best = est.select_best_model(results)
    assert 0.5 < best.evaluation.metrics["AUC"] <= 1.0
    plain = _estimator(None).fit(ds, validation_data=ds)
    for got, want in zip(results, plain):
        # int8 storage against the float32 resident fit.
        assert abs(got.evaluation.metrics["AUC"]
                   - want.evaluation.metrics["AUC"]) <= TOL
        _close(got.model.models["ctr"].coefficients.means,
               want.model.models["ctr"].coefficients.means, tol=0.05)


def test_estimator_refusals(data):
    ds, _ = data
    with pytest.raises(ValueError, match="no coordinate routed"):
        dense = dataclasses.replace(ds, feature_shards={
            "global": np.ones((N, 3), np.float32)})
        _estimator(StreamingConfig()).fit(dense)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _estimator(StreamingConfig(), FixedEffectDataConfiguration(
            "global", feature_sharded=True)).fit(ds)
    for solver in ("sdca", "sgd"):
        with pytest.raises(NOT_PORTED, match="slice 7"):
            _estimator(StreamingConfig(solver=solver)).fit(ds)
    with pytest.raises(ValueError, match="chunk_rows"):
        StreamingConfig(chunk_rows=0)


def test_coordinate_refusals(data):
    ds, _ = data
    cfg, _ = _configs()
    raws = list(ss.iter_shard_chunks(ds.feature_shards["global"],
                                     ds.response, ds.weights, 512))
    shifted = [dataclasses.replace(r, offsets=r.offsets + 1.0)
               for r in raws]
    chunked = ss.build_chunked(shifted, DIM, 512, num_hot=24)
    with pytest.raises(ValueError, match="ZERO offsets"):
        StreamingSparseFixedEffectCoordinate(
            ds, chunked, "global", losses.LOGISTIC, cfg, device="cpu")
    good = ss.build_chunked(raws, DIM, 512, num_hot=24)
    with pytest.raises(NOT_PORTED, match="slice 9"):
        StreamingSparseFixedEffectCoordinate(
            ds, good, "global", losses.LOGISTIC, cfg, mesh=object(),
            device="cpu")
    with pytest.raises(NOT_PORTED, match="slice 7"):
        StreamingSparseFixedEffectCoordinate(
            ds, good, "global", losses.LOGISTIC, cfg, solver="sdca",
            device="cpu")
    coord = StreamingSparseFixedEffectCoordinate(
        ds, good, "global", losses.LOGISTIC, cfg, device="cpu")
    with pytest.raises(ValueError, match="down-sampling"):
        coord.with_optimization_config(dataclasses.replace(
            cfg, down_sampling_rate=0.5))
    with pytest.raises(ValueError, match="variance"):
        coord.with_optimization_config(dataclasses.replace(
            cfg, variance_computation=VarianceComputationType.SIMPLE))
    with pytest.raises(ValueError, match="rows"):
        StreamingSparseFixedEffectCoordinate(
            ds.subset(np.arange(N - 1)), good, "global", losses.LOGISTIC,
            cfg, device="cpu")


def test_config_swap_shares_the_stream(data):
    ds, _ = data
    cfg, _ = _configs()
    coord = _stage(ds, cfg, "int8")
    swapped = coord.with_optimization_config(_configs(weight=3.0)[0])
    assert swapped.stream is coord.stream
    assert swapped.config.regularization.reg_weight == 3.0
    model = swapped.train_model(torch.zeros(N))
    assert bool(torch.isfinite(model.coefficients.means).all())
    solve, passes = swapped.last_solve, coord.stream.passes
    assert solve["gradient_evaluations"] == passes["value_grad"] >= 1
    assert solve["value_evaluations"] == passes["value"]


class Killed(Exception):
    """A simulated kill (an exception of its own: an interrupt escaping a
    test would stop the whole pytest run)."""


def test_bind_step_checkpoint_resumes_mid_fit(data, tmp_path, monkeypatch):
    """descent.run with a checkpoint manager binds the streamed fit's
    per-step store (bind_step_checkpoint): killed in the first update
    after 3 accepted iterations, the descent resumes that update mid-fit
    and runs the second, to the bits of an uninterrupted run; the
    reference's descent reads the final checkpoint as complete, and its
    own streamed descent lands within TOL."""
    from photon_ml_torch.game.checkpoint import (CheckpointManager,
                                                 StreamingStateStore)
    from photon_ml_tpu.game.checkpoint import \
        CheckpointManager as RefCheckpointManager

    ds, rds = data
    cfg, ref_cfg = _configs()
    seq = descent.CoordinateDescentConfig(["fixed"], iterations=2)
    clean, clean_hist = descent.run(TaskType.LOGISTIC_REGRESSION,
                                    {"fixed": _stage(ds, cfg, "int8")}, seq)
    coord = _stage(ds, cfg, "int8")
    saves = []
    save = StreamingStateStore.save

    def failing_save(store, state, **kw):
        saves.append(os.path.basename(store.directory))
        if saves.count("stream-step-1") == 4:
            raise Killed("simulated kill")
        save(store, state, **kw)

    manager = CheckpointManager(str(tmp_path / "ck"))
    with monkeypatch.context() as m:
        m.setattr(StreamingStateStore, "save", failing_save)
        with pytest.raises(Killed):
            descent.run(TaskType.LOGISTIC_REGRESSION, {"fixed": coord}, seq,
                        checkpoint_manager=manager)
    assert manager.load(device="cpu") is None  # no step committed
    assert os.path.isdir(tmp_path / "ck" / "stream-step-1")
    model, hist = descent.run(TaskType.LOGISTIC_REGRESSION,
                              {"fixed": coord}, seq,
                              checkpoint_manager=manager)
    w = model.models["fixed"].coefficients.means
    assert w.numpy().tobytes() == \
        clean.models["fixed"].coefficients.means.numpy().tobytes()
    # The resumed leg skipped the 3 committed iterations' gradient passes
    # and the initial one.
    solves = [r["solver"] for r in hist.records]
    clean_solves = [r["solver"] for r in clean_hist.records]
    assert solves[0]["gradient_evaluations"] == \
        clean_solves[0]["gradient_evaluations"] - 4
    assert solves[1] == clean_solves[1]
    assert not [p for p in os.listdir(tmp_path / "ck")
                if p.startswith("stream-step")]
    assert RefCheckpointManager(str(tmp_path / "ck")).load().complete
    ref = RefCoordinate.stage(
        rds, "global", ref_losses.LOGISTIC, ref_cfg, None,
        RefStreamingConfig(feature_dtype="int8", **STREAMING))
    ref_model, _ = ref_descent.run(
        RefTaskType.LOGISTIC_REGRESSION, {"fixed": ref},
        ref_descent.CoordinateDescentConfig(["fixed"], iterations=2))
    _close(w, ref_model.models["fixed"].coefficients.means)
