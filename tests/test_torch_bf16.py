"""bfloat16 feature storage: the port against the reference.

The same numpy inputs are stored in bfloat16 by both packages (the
reference's from ``jnp.asarray(x).astype(jnp.bfloat16)`` or its own
staging) and go through both packages' functions on the CPU (the
port's kernels in their plain versions):

- stored bits (compared as uint16): ``LabeledBatch.build``, the hybrid
  hot block of ``build_hybrid``, and a streamed chunk's ``X_hot`` and
  ``cold_vals``, each bit for bit; the hybrid threshold, hot columns and
  permutation equal;
- the dense aggregators (flat, lane-batched, and one shared batch under
  several lanes), the hybrid objective and a streamed chunk pass: the
  port rounds what the reference rounds (the small operand before each
  product, never X's square), so each output is within rtol 1e-5 of
  the reference's, with an absolute floor of 1e-5 of its largest entry
  (float32 sums in another order; the kernels' 1e-3 gate is the
  ceiling);
- trap 1 of ROADMAP §C: multiplying the bfloat16 features by float32
  coefficients (the Pallas kernel's choice) lands outside that band;
- a bfloat16 chunk store round-trips, and crosses between the packages.

Coordinate updates and fits in bfloat16 are held to 5e-3 (the band for
full solves) in ``test_torch_train.py``, ``test_torch_sparse_fixed.py``
and ``test_torch_streaming_fixed.py``; a hybrid ``GameEstimator.fit`` in
bfloat16 is here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                         FixedEffectDataConfiguration)
from photon_ml_torch.api.estimator import GameEstimator
from photon_ml_torch.data import sparse
from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.data.game_data import from_sparse_batch
from photon_ml_torch.normalization import build_normalization
from photon_ml_torch.ops import aggregators as agg
from photon_ml_torch.ops import hybrid_sparse as hs
from photon_ml_torch.ops import losses
from photon_ml_torch.ops import streaming_sparse as ss
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType
from photon_ml_tpu.api import configs as ref_configs
from photon_ml_tpu.api.estimator import GameEstimator as RefEstimator
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data.batch import LabeledBatch as RefBatch
from photon_ml_tpu.data.game_data import \
    from_sparse_batch as ref_from_sparse_batch
from photon_ml_tpu.normalization import \
    build_normalization as ref_build_normalization
from photon_ml_tpu.ops import aggregators as ref_agg
from photon_ml_tpu.ops import hybrid_sparse as ref_hs
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops import streaming_sparse as ref_ss
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as RefRegularization
from photon_ml_tpu.optim.regularization import \
    RegularizationType as RefRegType
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import TaskType as RefTaskType

RTOL = 1e-5
TOL = 5e-3
FUNCS = ["margins", "value_and_gradient", "value_only", "hessian_vector",
         "hessian_diagonal", "hessian_matrix", "scores"]
N, DIM, NNZ, CHUNK = 3000, 600, 16, 1024
LOSSES = {"logistic": (losses.LOGISTIC, ref_losses.LOGISTIC),
          "squared": (losses.SQUARED, ref_losses.SQUARED),
          "poisson": (losses.POISSON, ref_losses.POISSON)}


def _bits(a) -> np.ndarray:
    """A bfloat16 array of either package (or numpy's 2-byte void, as a
    chunk store loads it) as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    assert a.dtype.itemsize == 2 and a.dtype.kind in "Vf"
    return a.view(np.uint16)


def _near(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# -- dense batches ---------------------------------------------------------

def _inputs(rng, lanes, n=40, d=7):
    """X with an intercept column and garbage in zero-weight rows, as
    test_torch_aggregators builds it, and values that bfloat16 rounds."""
    shape = (n,) if lanes is None else (lanes, n)
    X = rng.normal(size=shape + (d,)).astype(np.float32)
    X[..., -1] = 1.0
    y = (rng.random(shape) < 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    o = (0.1 * rng.normal(size=shape)).astype(np.float32)
    pad = rng.random(shape) < 0.2
    X[pad] = 3e5
    y[pad] = 37.0
    o[pad] = 1e4
    w[pad] = 0.0
    means_shape = (d,) if lanes is None else (lanes, d)
    means = (0.3 * rng.normal(size=means_shape)).astype(np.float32)
    v = rng.normal(size=means_shape).astype(np.float32)
    stats = dict(means=rng.normal(size=d), variances=rng.uniform(0.5, 2, d),
                 intercept_index=d - 1)
    return X, y, w, o, means, v, stats


def _port_call(name, loss, batch, means, v, norm):
    if name == "scores":
        return [agg.scores(batch.features, means, batch.offsets)]
    if name == "margins":
        return [agg.margins(batch, means, norm)]
    if name == "hessian_vector":
        return [agg.hessian_vector(loss, means, v, batch, norm)]
    out = getattr(agg, name)(loss, means, batch, norm)
    return list(out) if isinstance(out, tuple) else [out]


def _ref_call(name, loss, X, y, w, o, means, v, norm):
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
    args[0] = args[0].astype(jnp.bfloat16)
    out = (one if X.ndim == 2 else jax.vmap(one))(*args)
    return [np.asarray(a, np.float32) for a in
            (out if isinstance(out, tuple) else (out,))]


def _port_batch(X, y, w, o):
    return LabeledBatch.build(X, y, w, o, feature_dtype="bfloat16")


@pytest.mark.parametrize("lanes", [None, 3], ids=["flat", "lanes"])
def test_labeled_batch_stores_reference_bits(lanes):
    X, y, w, o, *_ = _inputs(np.random.default_rng(1), lanes)
    port = _port_batch(X, y, w, o)
    ref = RefBatch.build(X, y, w, o, feature_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(_bits(port.features), _bits(ref.features))
    for name in ("labels", "weights", "offsets"):
        t = getattr(port, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), getattr(ref, name))
    # Rounded once: the float32 input, to nearest even.
    want = torch.from_numpy(X).to(torch.bfloat16)
    assert torch.equal(port.features, want)


@pytest.mark.parametrize("norm_kind", ["identity", "standardization"])
@pytest.mark.parametrize("lanes", [None, 3], ids=["flat", "lanes"])
@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("loss_name", ["logistic", "poisson"])
def test_dense_aggregators_match_reference(name, lanes, loss_name,
                                           norm_kind):
    rng = np.random.default_rng(len(name) + (lanes or 0))
    X, y, w, o, means, v, stats = _inputs(rng, lanes)
    if loss_name == "poisson":
        y = np.where(w > 0, np.round(2 * np.abs(y)), y).astype(np.float32)
    kind = "STANDARDIZATION" if norm_kind == "standardization" else "NONE"
    norm = build_normalization(kind, **stats)
    ref_norm = ref_build_normalization(kind, **stats)
    t = torch.from_numpy
    got = _port_call(name, losses.get_loss(loss_name), _port_batch(X, y, w, o),
                     t(means), t(v), norm)
    want = _ref_call(name, ref_losses.get_loss(loss_name), X, y, w, o, means,
                     v, ref_norm)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        _near(g, r)


def test_shared_batch_under_lanes_matches_reference():
    """One flat bfloat16 batch under (L, d) coefficients, as a single
    fixed-effect solve (one lane) and a regularization grid (several)
    run it: each lane equals the reference's flat call."""
    X, y, w, o, _, _, _ = _inputs(np.random.default_rng(5), None)
    rng = np.random.default_rng(6)
    lanes = (0.3 * rng.normal(size=(3, X.shape[1]))).astype(np.float32)
    v = rng.normal(size=lanes.shape).astype(np.float32)
    batch = _port_batch(X, y, w, o)
    t = torch.from_numpy
    f, g = agg.value_and_gradient(losses.LOGISTIC, t(lanes), batch)
    hv = agg.hessian_vector(losses.LOGISTIC, t(lanes), t(v), batch)
    assert f.shape == (3,) and g.shape == lanes.shape == hv.shape
    for i in range(3):
        rf, rg = _ref_call("value_and_gradient", ref_losses.LOGISTIC, X, y,
                           w, o, lanes[i], v[i], ref_build_normalization(
                               "NONE"))
        (rh,) = _ref_call("hessian_vector", ref_losses.LOGISTIC, X, y, w, o,
                          lanes[i], v[i], ref_build_normalization("NONE"))
        _near(f[i], rf)
        _near(g[i], rg)
        _near(hv[i], rh)


def test_trap1_float32_coefficients_leave_the_band():
    """ROADMAP §C trap 1, decided: the reference's default route rounds
    the coefficients to bfloat16 before the product, and so does the
    port. Multiplying the same bfloat16 features by float32
    coefficients instead (the Pallas kernel's contract) gives margins
    outside the parity band, while the port's route stays inside."""
    X, y, w, o, means, _, _ = _inputs(np.random.default_rng(11), None)
    live = w > 0
    batch = _port_batch(X[live], y[live], w[live], o[live])
    t = torch.from_numpy
    (want,) = _ref_call("margins", ref_losses.LOGISTIC, X[live], y[live],
                        w[live], o[live], means, means,
                        ref_build_normalization("NONE"))
    _near(agg.margins(batch, t(means)), want)
    unrounded = batch.features.float() @ t(means) + batch.offsets
    scale = float(np.abs(want).max())
    assert float(np.abs(unrounded.numpy() - want).max()) > 10 * RTOL * scale


# -- the hybrid layout -----------------------------------------------------

LAYOUTS = {"default": {}, "ragged hot": {"max_hot": 37, "hot_threshold": 2}}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def hybrid(request):
    b, _ = sparse.synthetic_sparse(N, DIM, NNZ, seed=2)
    idx, val = b.indices.numpy(), b.values.numpy()
    rng = np.random.default_rng(3)
    y = (rng.random(N) < 0.3).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, N).astype(np.float32)
    wt[rng.random(N) < 0.05] = 0.0
    o = (0.2 * rng.normal(size=N)).astype(np.float32)
    t = torch.from_numpy
    port = sparse.SparseBatch(t(idx), t(val), t(y), t(wt), t(o), DIM)
    ref = ref_sparse.SparseBatch(idx, val, y, wt, o, DIM)
    kw = LAYOUTS[request.param]
    return (request.param,
            hs.build_hybrid(port, feature_dtype=torch.bfloat16,
                            device="cpu", **kw),
            ref_hs.build_hybrid(ref, feature_dtype=jnp.bfloat16,
                                device=False, **kw))


def test_build_hybrid_stores_reference_bits(hybrid):
    layout, hb, ref = hybrid
    assert hs._default_hot_threshold(N, "bfloat16") == \
        ref_hs._default_hot_threshold(N, jnp.bfloat16) == max(8, N // 4096)
    assert hb.num_hot == ref.num_hot > 0
    np.testing.assert_array_equal(hb.perm.numpy(), ref.perm)
    np.testing.assert_array_equal(hb.inv_perm.numpy(), ref.inv_perm)
    assert hb.class_starts == ref.class_starts
    k = hb.num_hot
    assert hb.X_hot.dtype == torch.bfloat16
    assert hb.X_hot.shape[1] % hs.hot_align(torch.bfloat16) == 0
    assert hb.X_hot.shape[1] - k < hs.hot_align(torch.bfloat16)
    np.testing.assert_array_equal(_bits(hb.X_hot[:, :k].contiguous()),
                                  _bits(ref.X_hot))
    assert not hb.X_hot[:, k:].any()
    # Cold values stay float32, as in the reference.
    for got, want in zip(hb.cold_vals, ref.cold_vals):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    big = 1 << 20  # the bfloat16 threshold widens the block: n/4096
    assert hs._default_hot_threshold(big, torch.bfloat16) == \
        ref_hs._default_hot_threshold(big, jnp.bfloat16) == big // 4096
    assert hs._default_hot_threshold(big) == \
        ref_hs._default_hot_threshold(big, jnp.float32) == big // 2048


def _ref_hybrid(ref):
    """The reference's layout as device arrays, as its coordinate holds
    it."""
    return jax.tree_util.tree_map(jnp.asarray, ref)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_hybrid_objective_matches_reference(hybrid, name):
    _, hb, ref = hybrid
    ref = _ref_hybrid(ref)
    loss, ref_loss = LOSSES[name]
    rng = np.random.default_rng(5)
    w = (0.1 * rng.normal(size=DIM)).astype(np.float32)
    v = rng.normal(size=DIM).astype(np.float32)
    t = torch.from_numpy
    val, grad = hs.value_and_gradient(loss, t(w), hb)
    rval, rgrad = ref_hs.value_and_gradient(ref_loss, jnp.asarray(w), ref)
    np.testing.assert_allclose(float(val), float(rval), rtol=RTOL)
    _near(grad, rgrad)
    _near(hs.margins(hb, t(w)), ref_hs.margins(ref, jnp.asarray(w)))
    _near(hs.hessian_vector(loss, t(w), t(v), hb),
          ref_hs.hessian_vector(ref_loss, jnp.asarray(w), jnp.asarray(v),
                                ref))
    _near(hs.hessian_diagonal(loss, t(w), hb, block_rows=700),
          ref_hs.hessian_diagonal(ref_loss, jnp.asarray(w), ref))


@pytest.mark.parametrize("iterations", [10, 300])
def test_hybrid_default_fit_matches_reference(iterations):
    """A default FixedEffectDataConfiguration with feature_dtype
    "bfloat16" fits the hybrid layout in bfloat16 in both estimators:
    coefficients within 5e-3 after 10 iterations, and validation AUC
    within 5e-3 after 10 and after a fit to the solver's stop. The
    coefficients of full fits are not held: rounding the coefficients to
    bfloat16 (both packages' route) makes the objective a step function
    of them, so L-BFGS stops at points that are not stationary (gradient
    norms 1.4 and 1.9 on this fixture) and two correct solvers part
    after about 20 iterations (ROADMAP §C)."""
    n = 4000
    b, _ = sparse.synthetic_sparse(n, 1500, 24, seed=19)
    rb, _ = ref_sparse.synthetic_sparse(n, 1500, 24, seed=19)
    cut = n - n // 10
    train, val = (from_sparse_batch(b).subset(np.arange(0, cut)),
                  from_sparse_batch(b).subset(np.arange(cut, n)))
    rds = ref_from_sparse_batch(rb)
    ref_train, ref_val = (rds.subset(np.arange(0, cut)),
                          rds.subset(np.arange(cut, n)))
    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=iterations,
                                  tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))
    ref_opt = RefGLMConfig(
        optimizer=RefOptimizerConfig(max_iterations=iterations,
                                     tolerance=1e-7),
        regularization=RefRegularization(RefRegType.L2, 1.0))
    est = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"ctr": CoordinateConfiguration(FixedEffectDataConfiguration(
            "global", feature_dtype="bfloat16"), opt)},
        ["ctr"], device="cpu", validation_evaluators=["AUC"])
    ref_est = RefEstimator(
        RefTaskType.LOGISTIC_REGRESSION,
        {"ctr": ref_configs.CoordinateConfiguration(
            ref_configs.FixedEffectDataConfiguration(
                "global", feature_dtype="bfloat16"), ref_opt)},
        ["ctr"], make_mesh(num_data=1, devices=jax.devices()[:1]),
        validation_evaluators=["AUC"])
    r = est.fit(train, validation_data=val)[0]
    rr = ref_est.fit(ref_train, validation_data=ref_val)[0]
    staged = est.coordinates["ctr"].staged
    assert staged.X_hot.dtype == torch.bfloat16 and staged.num_hot > 0
    if iterations == 10:
        np.testing.assert_allclose(
            r.model.models["ctr"].coefficients.means.numpy(),
            np.asarray(rr.model.models["ctr"].coefficients.means), rtol=0,
            atol=TOL)
    assert abs(r.evaluation.metrics["AUC"]
               - rr.evaluation.metrics["AUC"]) <= TOL


# -- streamed chunks -------------------------------------------------------

@pytest.fixture(scope="module")
def chunks():
    """3,000 rows over 1,024-row chunks (a short tail), bfloat16, staged by
    both packages."""
    b = ref_sparse.synthetic_sparse(N, DIM, NNZ, seed=3)[0]
    arrays = {name: np.asarray(getattr(b, name)) for name in
              ("indices", "values", "labels", "weights", "offsets")}
    arrays["offsets"] = arrays["offsets"] + 0.25

    def raw(make):
        for lo in range(0, N, CHUNK):
            yield make(**{k: a[lo:lo + CHUNK] for k, a in arrays.items()},
                       num_features=DIM)

    ref = ref_ss.build_chunked(raw(ref_sparse.SparseBatch), DIM, CHUNK,
                               num_hot=32, feature_dtype="bfloat16")
    port = ss.build_chunked(raw(ss._RawChunk), DIM, CHUNK, num_hot=32,
                            feature_dtype="bfloat16", workers=2)
    return ref, port


def _same_chunks(a, b):
    """Every field of every chunk the same: bfloat16 ones bit for bit,
    the rest equal in dtype and value (numpy or tensors)."""
    assert (a.num_rows, a.chunk_rows, a.num_chunks) == \
        (b.num_rows, b.chunk_rows, b.num_chunks)
    for ca, cb in zip(a.chunks, b.chunks):
        assert ca.num_features == cb.num_features
        for name in ss._CHUNK_FIELDS:
            x, y = getattr(ca, name), getattr(cb, name)
            if x is None:
                assert y is None, name
            elif name in ("X_hot", "cold_vals"):
                np.testing.assert_array_equal(_bits(x), _bits(y),
                                              err_msg=name)
            else:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


def test_streamed_chunks_store_reference_bits(chunks):
    ref, port = chunks
    assert port.num_chunks == 3 and port.num_rows == N
    assert ss.chunk_dtype(port.chunks[0]) == "bfloat16"
    for ch in port.chunks:
        assert ch.X_hot.dtype == ch.cold_vals.dtype == torch.bfloat16
    _same_chunks(ref, port)


@pytest.mark.parametrize("offsets", [False, True])
def test_streamed_passes_match_reference(chunks, offsets):
    ref, port = chunks
    rng = np.random.default_rng(7)
    w = rng.normal(size=DIM).astype(np.float32)
    off = (0.5 * rng.normal(size=3 * CHUNK)).astype(np.float32) \
        if offsets else None
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    joff = None if off is None else jnp.asarray(off)
    toff = None if off is None else torch.from_numpy(off)
    vr, gr = ref_ss.make_value_and_gradient(ref_losses.LOGISTIC, ref)(jw,
                                                                      joff)
    vp, gp = ss.make_value_and_gradient(losses.LOGISTIC, port,
                                        device="cpu")(tw, toff)
    np.testing.assert_allclose(float(vp), float(vr), rtol=RTOL)
    _near(gp, gr)
    _near(ss.margins_chunked(port, tw, toff, device="cpu"),
          ref_ss.margins_chunked(ref, jw, joff))
    v_only = ss.make_value_only(losses.LOGISTIC, port, device="cpu")
    np.testing.assert_allclose(float(v_only(tw, toff)), float(vr),
                               rtol=RTOL)


def test_chunk_store_round_trips_and_crosses(chunks, tmp_path):
    ref, port = chunks
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ss.save_chunked(port_dir, port)
    ref_ss.save_chunked(ref_dir, ref)
    again = ss.load_chunked(port_dir)
    assert ss.chunk_dtype(again.chunks[0]) == "bfloat16"
    _same_chunks(port, again)
    _same_chunks(port, ss.load_chunked(ref_dir))
    _same_chunks(ref_ss.load_chunked(ref_dir), ref_ss.load_chunked(port_dir))
