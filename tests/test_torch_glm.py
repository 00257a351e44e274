"""The GLM path's modules: the port against photon_ml_tpu.

Each check runs the reference's function and the port's (``device="cpu"``)
on the same inputs, made with numpy from a seed:

- ``read_libsvm``/``write_libsvm``: labels, values and text bit for bit
  (±1 labels, comment and blank lines, zero-based ids, CSR output), and
  the same error for an index outside a declared feature space;
- ``summarize`` within 1e-6 relative, ``normalization_from_statistics``
  for all four types within 1e-6;
- the validators: the same exception and message for NaN, Inf and bad
  labels at each level, and the same rows under VALIDATE_SAMPLE;
- ``GeneralizedLinearModel`` scores, means and classes for all four
  tasks within 1e-6, and the SVM threshold refusal;
- ``save_glm``/``load_glm`` across packages, both ways, bit for bit;
- ``glm_classification`` and ``a1a_like`` bit for bit;
- ``run_grid`` against the reference's vmapped grid for L-BFGS and TRON
  on a 3-point grid: coefficients within 5e-3 (the band for full
  solves) and the same ``converged``; and its three refusals.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data import libsvm as tlibsvm
from photon_ml_torch.data import statistics as tstats
from photon_ml_torch.data import synthetic as tsyn
from photon_ml_torch.data import validators as tval
from photon_ml_torch.data.batch import LabeledBatch as TBatch
from photon_ml_torch.models import glm as tglm
from photon_ml_torch.models import io as tio
from photon_ml_torch.models.coefficients import Coefficients as TCoef
from photon_ml_torch.normalization import NormalizationType as TNormType
from photon_ml_torch.ops import losses as tlosses
from photon_ml_torch.optim import OptimizerConfig as TOptCfg
from photon_ml_torch.optim import OptimizerType as TOptType
from photon_ml_torch.optim import problem as tproblem
from photon_ml_torch.optim.problem import \
    GLMOptimizationConfiguration as TGLMCfg
from photon_ml_torch.optim.problem import \
    VarianceComputationType as TVarType
from photon_ml_torch.optim.regularization import \
    RegularizationContext as TRegCtx
from photon_ml_torch.optim.regularization import \
    RegularizationType as TRegType
from photon_ml_torch.types import TaskType as TTask
from photon_ml_torch.utils import logging as tlogging
from photon_ml_tpu.data import libsvm as jlibsvm
from photon_ml_tpu.data import statistics as jstats
from photon_ml_tpu.data import synthetic as jsyn
from photon_ml_tpu.data import validators as jval
from photon_ml_tpu.data.batch import LabeledBatch as JBatch
from photon_ml_tpu.models import glm as jglm
from photon_ml_tpu.models import io as jio
from photon_ml_tpu.models.coefficients import Coefficients as JCoef
from photon_ml_tpu.normalization import NormalizationType as JNormType
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.optim import OptimizerConfig as JOptCfg
from photon_ml_tpu.optim import OptimizerType as JOptType
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as JGLMCfg
from photon_ml_tpu.optim.problem import \
    VarianceComputationType as JVarType
from photon_ml_tpu.optim.regularization import \
    RegularizationContext as JRegCtx
from photon_ml_tpu.optim.regularization import \
    RegularizationType as JRegType
from photon_ml_tpu.parallel import problem as jproblem
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import TaskType as JTask

SOLVE_TOL = 5e-3


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# -- LIBSVM ----------------------------------------------------------------

_HANDWRITTEN = """# a comment line, then a blank one

-1 1:0.5 3:-2.25 7:1e-3
+1 2:3.14159265358979 3:0.1 5:7
# another comment
1 4:-0.30000000000000004 6:1.0000001 7:65504.7
-1
-1 1:2.5e-8 2:-1E+3
"""


def _random_file(path, rng, zero_based=False, pm1=False):
    X = rng.normal(size=(40, 9)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.6] = 0.0
    y = rng.integers(0, 2, 40).astype(np.float32)
    if pm1:
        y = 2 * y - 1
    jlibsvm.write_libsvm(path, X, y, zero_based=zero_based)


@pytest.mark.parametrize("case,kwargs", [
    ("handwritten", {}),
    ("handwritten", {"dense": False}),
    ("handwritten", {"binary_labels_to_01": False}),
    ("handwritten", {"num_features": 12}),
    ("random", {}),
    ("random_pm1", {}),
    ("random_zero_based", {"zero_based": True}),
    ("random", {"dense": False}),
])
def test_read_libsvm_matches_reference_bit_for_bit(tmp_path, rng, case,
                                                   kwargs):
    path = str(tmp_path / "data.libsvm")
    if case == "handwritten":
        with open(path, "w") as f:
            f.write(_HANDWRITTEN)
    else:
        _random_file(path, rng, zero_based=case.endswith("zero_based"),
                     pm1=case.endswith("pm1"))
    got = tlibsvm.read_libsvm(path, **kwargs)
    want = jlibsvm.read_libsvm(path, **kwargs)
    assert got.num_features == want.num_features
    assert got.num_rows == want.num_rows
    np.testing.assert_array_equal(bits(got.labels), bits(want.labels))
    if kwargs.get("dense", True):
        assert got.dense.shape == want.dense.shape
        np.testing.assert_array_equal(bits(got.dense), bits(want.dense))
    else:
        for k in ("indptr", "indices"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        np.testing.assert_array_equal(bits(got.values), bits(want.values))
        np.testing.assert_array_equal(bits(got.to_dense()),
                                      bits(want.to_dense()))
    if case in ("handwritten", "random_pm1") and kwargs.get(
            "binary_labels_to_01", True):
        assert set(np.unique(got.labels)) <= {0.0, 1.0}


@pytest.mark.parametrize("labels", ["float", "int"])
def test_write_libsvm_writes_the_reference_text(tmp_path, rng, labels):
    X = rng.normal(size=(30, 7)).astype(np.float32) * 100
    X[rng.uniform(size=X.shape) < 0.5] = 0.0
    X[3] = 0.0  # a row with no features
    y = (rng.normal(size=30).astype(np.float32) if labels == "float"
         else rng.integers(-1, 2, 30))
    tlibsvm.write_libsvm(str(tmp_path / "t"), X, y)
    jlibsvm.write_libsvm(str(tmp_path / "j"), X, y)
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()


def test_read_libsvm_errors_match_reference(tmp_path):
    path = str(tmp_path / "data.libsvm")
    with open(path, "w") as f:
        f.write(_HANDWRITTEN)
    with pytest.raises(ValueError) as got:
        tlibsvm.read_libsvm(path, num_features=5)
    with pytest.raises(ValueError) as want:
        jlibsvm.read_libsvm(path, num_features=5)
    assert str(got.value) == str(want.value)
    assert "outside the declared feature space" in str(got.value)
    for bad in ("1 0:2.0\n", "1 3:1:2\n", "1 3\n", "1 :2\n"):
        with open(path, "w") as f:
            f.write(bad)
        with pytest.raises(ValueError):
            tlibsvm.read_libsvm(path)
        with pytest.raises(ValueError):
            jlibsvm.read_libsvm(path)
    with pytest.raises(FileNotFoundError):
        tlibsvm.read_libsvm(str(tmp_path / "missing"))


# -- statistics and normalization -------------------------------------------

def _stats_inputs(rng, n=300, d=6):
    X = rng.normal(size=(n, d)).astype(np.float32) * [1, 3, 0.1, 5, 1, 0]
    X[rng.uniform(size=X.shape) < 0.3] = 0.0
    X = X.astype(np.float32)
    X[:, -1] = 1.0
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w[::7] = 0.0
    X[::7, 0] = 1e6  # rows of weight 0 stay out of every statistic
    y = rng.integers(0, 2, n).astype(np.float32)
    return X, y, w


def test_summarize_matches_reference(rng):
    X, y, w = _stats_inputs(rng)
    got = tstats.summarize(TBatch.build(X, y, weights=w))
    want = jstats.summarize(JBatch.build(X, y, weights=w))
    for field in ("count", "mean", "variance", "min", "max", "num_nonzeros",
                  "max_magnitude"):
        g = getattr(got, field).numpy()
        e = np.asarray(getattr(want, field))
        np.testing.assert_allclose(g, e, rtol=1e-6,
                                   atol=1e-6 * np.abs(e).max(), err_msg=field)
    assert float(got.max[0]) < 1e6


@pytest.mark.parametrize("norm_type", [t.value for t in TNormType])
def test_normalization_from_statistics_matches_reference(rng, norm_type):
    X, y, w = _stats_inputs(rng)
    d = X.shape[1]
    got = tstats.normalization_from_statistics(
        tstats.summarize(TBatch.build(X, y, weights=w)),
        TNormType(norm_type), d - 1)
    want = jstats.normalization_from_statistics(
        jstats.summarize(JBatch.build(X, y, weights=w)),
        JNormType(norm_type), d - 1)
    for field in ("factors", "shifts"):
        g, e = getattr(got, field), getattr(want, field)
        assert (g is None) == (e is None), field
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6,
                                       atol=1e-6, err_msg=field)
    assert got.intercept_index == want.intercept_index


# -- validators -------------------------------------------------------------

def _corrupt(rng, kind, n):
    """(task, labels, weights, offsets, features) with one kind of fault
    at a few rows (or none)."""
    labels = rng.integers(0, 2, n).astype(np.float32)
    weights = np.ones(n, np.float32)
    offsets = np.zeros(n, np.float32)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    task = "LOGISTIC_REGRESSION"
    rows = rng.integers(0, n, 3)
    if kind == "label_nan":
        labels[rows] = np.nan
    elif kind == "label_inf":
        task = "LINEAR_REGRESSION"
        labels[rows] = np.inf
    elif kind == "label_binary":
        labels[rows] = 2.0
    elif kind == "label_negative":
        task = "POISSON_REGRESSION"
        labels[rows] = -1.0
    elif kind == "weight_negative":
        weights[rows] = -0.5
    elif kind == "offset_inf":
        offsets[rows] = -np.inf
    elif kind == "feature_nan":
        X[rows, 1] = np.nan
    return task, labels, weights, offsets, X


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("level", [v.value for v in tval.DataValidationLevel])
@pytest.mark.parametrize("kind", [
    "clean", "label_nan", "label_inf", "label_binary", "label_negative",
    "weight_negative", "offset_inf", "feature_nan"])
def test_validators_match_reference(rng, level, kind):
    n = 30_000  # above the 10,000-row sample
    task, labels, weights, offsets, X = _corrupt(rng, kind, n)
    for seed in (0, 3):
        got = _outcome(lambda: (
            tval.validate_arrays(TTask(task), labels, weights, offsets,
                                 level=tval.DataValidationLevel(level),
                                 seed=seed),
            tval.validate_features("train", X,
                                   level=tval.DataValidationLevel(level),
                                   seed=seed)))
        want = _outcome(lambda: (
            jval.validate_arrays(JTask(task), labels, weights, offsets,
                                 level=jval.DataValidationLevel(level),
                                 seed=seed),
            jval.validate_features("train", X,
                                   level=jval.DataValidationLevel(level),
                                   seed=seed)))
        assert got == want
        if kind != "clean" and level == "VALIDATE_FULL":
            assert got is not None


@pytest.mark.parametrize("kind", ["clean", "label_binary", "feature_nan"])
def test_validate_game_dataset_matches_reference(rng, kind):
    from types import SimpleNamespace

    task, labels, weights, offsets, X = _corrupt(rng, kind, 2_000)
    ds = SimpleNamespace(response=labels, weights=weights, offsets=offsets,
                         feature_shards={"global": X})
    got = _outcome(lambda: tval.validate_game_dataset(TTask(task), ds))
    want = _outcome(lambda: jval.validate_game_dataset(JTask(task), ds))
    assert got == want
    assert (got is None) == (kind == "clean")


def test_validators_sample_the_reference_rows():
    for n in (5, 10_000, 10_001, 1_000_000):
        for seed in (0, 1, 7):
            got = tval._rows(n, tval.DataValidationLevel.VALIDATE_SAMPLE,
                             np.random.default_rng(seed))
            want = jval._rows(n, jval.DataValidationLevel.VALIDATE_SAMPLE,
                              np.random.default_rng(seed))
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)


def test_validators_accept_tensors_and_warn_on_zero_weights(caplog):
    with caplog.at_level(logging.WARNING,
                         logger="photon_ml_torch.data.validators"):
        tval.validate_arrays(TTask.LINEAR_REGRESSION, torch.ones(4),
                             weights=torch.zeros(4))
    assert any("zero" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="binary"):
        tval.validate_labels(TTask.LOGISTIC_REGRESSION,
                             torch.tensor([0.0, 3.0]))


# -- GeneralizedLinearModel ---------------------------------------------------

@pytest.mark.parametrize("task", [t.value for t in TTask])
def test_glm_matches_reference(rng, task):
    w = rng.normal(size=5).astype(np.float32)
    X = rng.normal(size=(64, 5)).astype(np.float32)
    off = rng.normal(size=64).astype(np.float32) * 0.1
    tm = tglm.GeneralizedLinearModel(TTask(task), TCoef(torch.from_numpy(w)))
    jm = jglm.GeneralizedLinearModel(JTask(task), JCoef(jnp.asarray(w)))
    Xt, ot = torch.from_numpy(X), torch.from_numpy(off)
    for o_t, o_j in ((None, None), (ot, jnp.asarray(off))):
        np.testing.assert_allclose(tm.compute_score(Xt, o_t).numpy(),
                                   np.asarray(jm.compute_score(X, o_j)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tm.compute_mean(Xt, o_t).numpy(),
                                   np.asarray(jm.compute_mean(X, o_j)),
                                   rtol=1e-6, atol=1e-6)
        if TTask(task).is_classification:
            np.testing.assert_array_equal(
                tm.predict_class(Xt, offsets=o_t).numpy(),
                np.asarray(jm.predict_class(X, offsets=o_j)))
    if TTask(task) == TTask.LOGISTIC_REGRESSION:
        np.testing.assert_array_equal(
            tm.predict_class(Xt, threshold=0.8).numpy(),
            np.asarray(jm.predict_class(X, threshold=0.8)))
    elif TTask(task) == TTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        with pytest.raises(ValueError, match="raw margin"):
            tm.predict_class(Xt, threshold=0.8)
    else:
        with pytest.raises(ValueError, match="not a classification"):
            tm.predict_class(Xt)


def test_glm_constructors():
    c = TCoef(torch.zeros(3))
    assert [m(c).task for m in (
        tglm.logistic_regression_model, tglm.linear_regression_model,
        tglm.poisson_regression_model, tglm.smoothed_hinge_svm_model)] == [
        TTask.LOGISTIC_REGRESSION, TTask.LINEAR_REGRESSION,
        TTask.POISSON_REGRESSION, TTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM]


@pytest.mark.parametrize("variances", [False, True])
def test_glm_files_cross_packages_both_ways(tmp_path, rng, variances):
    means = rng.normal(size=9).astype(np.float32)
    var = np.abs(rng.normal(size=9)).astype(np.float32) if variances else None
    jio.save_glm(jglm.GeneralizedLinearModel(
        JTask.POISSON_REGRESSION,
        JCoef(jnp.asarray(means),
              None if var is None else jnp.asarray(var))),
        str(tmp_path / "ref" / "model-0"))
    got = tio.load_glm(str(tmp_path / "ref" / "model-0"))
    assert got.task == TTask.POISSON_REGRESSION
    np.testing.assert_array_equal(bits(got.coefficients.means), bits(means))
    assert (got.coefficients.variances is None) == (var is None)
    if var is not None:
        np.testing.assert_array_equal(bits(got.coefficients.variances),
                                      bits(var))
    tio.save_glm(got, str(tmp_path / "port" / "model-0.npz"))
    back = jio.load_glm(str(tmp_path / "port" / "model-0"))
    assert back.task == JTask.POISSON_REGRESSION
    np.testing.assert_array_equal(bits(back.coefficients.means), bits(means))
    if var is not None:
        np.testing.assert_array_equal(bits(back.coefficients.variances),
                                      bits(var))
    assert ((tmp_path / "port" / "model-0.json").read_text()
            == (tmp_path / "ref" / "model-0.json").read_text())


# -- generators ---------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    {"n": 200, "d": 8},
    {"n": 150, "d": 5, "intercept": False, "noise": 0.3,
     "weight_scale": 2.0}])
def test_glm_classification_matches_reference(kwargs):
    got = tsyn.glm_classification(np.random.default_rng(11), **kwargs)
    want = jsyn.glm_classification(np.random.default_rng(11), **kwargs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kwargs", [{}, {"n": 300, "d": 20, "density": 0.3}])
def test_a1a_like_matches_reference(kwargs):
    got = tsyn.a1a_like(np.random.default_rng(5), **kwargs)
    want = jsyn.a1a_like(np.random.default_rng(5), **kwargs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- run_grid ------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _grid_problem(n=1600, d=10):
    rng = np.random.default_rng(17)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n)
         < 1 / (1 + np.exp(-(X @ w_true)))).astype(np.float32)
    return X, y


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_run_grid_matches_reference(mesh, optimizer):
    X, y = _grid_problem()
    d = X.shape[1]
    lams = [0.01, 1.0, 100.0]
    W_t, res_t = tproblem.run_grid(
        tlosses.LOGISTIC, TBatch.build(X, y),
        TGLMCfg(optimizer=TOptCfg(optimizer_type=TOptType(optimizer),
                                  max_iterations=80, tolerance=1e-8),
                regularization=TRegCtx(TRegType.L2, 1.0)),
        lams, intercept_index=d - 1)
    W_j, res_j = jproblem.run_grid(
        jlosses.LOGISTIC, JBatch.build(X, y), mesh,
        JGLMCfg(optimizer=JOptCfg(optimizer_type=JOptType(optimizer),
                                  max_iterations=80, tolerance=1e-8),
                regularization=JRegCtx(JRegType.L2, 1.0)),
        lams, intercept_index=d - 1)
    assert tuple(W_t.shape) == (len(lams), d)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    # Each lane is its λ's own solve.
    for k, lam in enumerate(lams):
        coef, _ = tproblem.run(
            tlosses.LOGISTIC, TBatch.build(X, y),
            TGLMCfg(optimizer=TOptCfg(optimizer_type=TOptType(optimizer),
                                      max_iterations=80, tolerance=1e-8),
                    regularization=TRegCtx(TRegType.L2, lam)),
            intercept_index=d - 1)
        np.testing.assert_allclose(W_t[k].numpy(), coef.means.numpy(),
                                   rtol=0, atol=SOLVE_TOL)


@pytest.mark.parametrize("case,match", [
    ("l1", "L1"), ("owlqn", "OWL-QN"), ("variance", "variance")])
def test_run_grid_refusals(rng, case, match):
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.float32)
    cfg = TGLMCfg(
        optimizer=TOptCfg(max_iterations=5, optimizer_type=(
            TOptType.OWLQN if case == "owlqn" else TOptType.LBFGS)),
        regularization=TRegCtx(
            TRegType.L1 if case == "l1" else TRegType.L2, 0.1),
        variance_computation=(TVarType.SIMPLE if case == "variance"
                              else TVarType.NONE))
    with pytest.raises(ValueError, match=match):
        tproblem.run_grid(tlosses.LOGISTIC, TBatch.build(X, y), cfg,
                          [0.1, 1.0])


# -- logging -------------------------------------------------------------------

def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logger = tlogging.setup_logging(log_file=str(tmp_path / "log" / "run.log"))
    assert logger is logging.getLogger(tlogging.__name__.split(".")[0])
    with tlogging.profile_trace(None):
        pass
    trace_dir = tmp_path / "trace"
    with tlogging.profile_trace(str(trace_dir)):
        with tlogging.annotate("glm.step"):
            torch.ones(8).sum()
    text = (trace_dir / "trace.json").read_text()
    assert "glm.step" in text
    timer = tlogging.Timer()
    with timer.scope("read"):
        pass
    assert timer.durations["read"] >= 0.0
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
