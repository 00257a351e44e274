"""The GLM driver: ``photon_ml_torch.cli.train_glm`` against the reference CLI.

Both CLIs run on the same LIBSVM files (``--device cpu`` for the port),
built as ``tests/test_cli.py`` builds BASELINE configs 1–3 at small
scale: logistic L-BFGS with L2, linear TRON with L2, Poisson OWL-QN with
L1 (the CLI reads no offsets). Beside them: one STANDARDIZATION fit with
SIMPLE variances, exported to the original feature space, and one
3-point L2 grid, which both CLIs solve in one batched solve. Every model
is written (``--output-mode ALL``) and held to the reference's: the same
``best_index``, the same ``summary.json`` keys, coefficients, variances
and validation metrics within 5e-3 (the band for full solves).
``converged`` is not compared: TRON's acceptance test compares decreases
of a few float32 ulps, so on config 2 the reference's own fit converges
through its 8-way mesh and not through its one-device ``run``, at the
same value to 1e-7.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.cli import train_glm
from photon_ml_torch.data.libsvm import write_libsvm
from photon_ml_torch.models import io as tio
from photon_ml_tpu.cli import train_glm as ref_train_glm
from photon_ml_tpu.models import io as jio

SOLVE_TOL = 5e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _split(tmp_path, rng, X, y, name):
    split = int(0.8 * len(y))
    idx = rng.permutation(len(y))
    tr, va = str(tmp_path / f"{name}.tr"), str(tmp_path / f"{name}.va")
    write_libsvm(tr, X[idx[:split]], y[idx[:split]])
    write_libsvm(va, X[idx[split:]], y[idx[split:]])
    return tr, va


def _data(tmp_path, config):
    rng = np.random.default_rng(42)
    if config == "linear":
        X = rng.normal(size=(600, 8)).astype(np.float32)
        w = rng.normal(size=8)
        y = X @ w + 0.1 * rng.normal(size=600)
    elif config == "poisson":
        X = rng.normal(size=(600, 6)).astype(np.float32) * 0.4
        w = np.zeros(6)
        w[:3] = rng.normal(size=3)
        y = rng.poisson(np.exp(X @ w)).astype(float)
    else:
        X = rng.normal(size=(800, 10)).astype(np.float32)
        X[:, 3] = X[:, 3] * 5.0 + 2.0  # something to standardize
        w = rng.normal(size=10)
        y = (rng.uniform(size=800) < 1 / (1 + np.exp(-X @ w))).astype(int)
        y = 2 * y - 1  # a1a ships ±1 labels
    return _split(tmp_path, rng, X, y, config)


CASES = {
    "config1_logistic_lbfgs_l2": ("logistic", [
        "--task", "LOGISTIC_REGRESSION", "--optimizer", "LBFGS",
        "--reg-type", "L2", "--reg-weights", "1.0"]),
    "config2_linear_tron_l2": ("linear", [
        "--task", "LINEAR_REGRESSION", "--optimizer", "TRON",
        "--reg-type", "L2", "--reg-weights", "0.1"]),
    "config3_poisson_owlqn_l1": ("poisson", [
        "--task", "POISSON_REGRESSION", "--optimizer", "OWLQN",
        "--reg-type", "L1", "--reg-weights", "0.05"]),
    "standardization_simple_variance": ("logistic", [
        "--task", "LOGISTIC_REGRESSION", "--optimizer", "LBFGS",
        "--reg-type", "L2", "--reg-weights", "1.0",
        "--normalization", "STANDARDIZATION", "--variance", "SIMPLE"]),
    "l2_grid": ("logistic", [
        "--task", "LOGISTIC_REGRESSION", "--optimizer", "LBFGS",
        "--reg-type", "L2", "--reg-weights", "0.1,1,10"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_glm_matches_reference_cli(tmp_path, case):
    config, flags = CASES[case]
    tr, va = _data(tmp_path, config)
    common = ["--train", tr, "--validation", va, "--output-mode", "ALL",
              *flags]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    if case == "config1_logistic_lbfgs_l2":
        # The module entry point, as a user runs it.
        run = subprocess.run(
            [sys.executable, "-m", "photon_ml_torch.cli.train_glm",
             *common, "--output-dir", port_out, "--device", "cpu"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr
        with open(os.path.join(port_out, "summary.json")) as f:
            got = json.load(f)
    else:
        got = train_glm.run(train_glm.build_parser().parse_args(
            [*common, "--output-dir", port_out, "--device", "cpu"]))
    want = ref_train_glm.run(ref_train_glm.build_parser().parse_args(
        [*common, "--output-dir", ref_out]))

    assert got.keys() == want.keys()
    assert got["task"] == want["task"]
    assert got["best_index"] == want["best_index"]
    assert len(got["models"]) == len(want["models"])
    metric = {"logistic": "AUC", "linear": "RMSE",
              "poisson": "POISSON_LOSS"}[config]
    for i, (g, w) in enumerate(zip(got["models"], want["models"])):
        assert list(g) == list(w)
        assert g["reg_weight"] == w["reg_weight"]
        assert np.isfinite(g[metric])
        assert abs(g[metric] - w[metric]) <= SOLVE_TOL
        assert abs(g["final_loss"] - w["final_loss"]) <= SOLVE_TOL * max(
            1.0, abs(w["final_loss"]))
        tm = tio.load_glm(os.path.join(port_out, f"model-{i}"))
        jm = jio.load_glm(os.path.join(ref_out, f"model-{i}"))
        np.testing.assert_allclose(tm.coefficients.means.numpy(),
                                   np.asarray(jm.coefficients.means),
                                   rtol=0, atol=SOLVE_TOL)
        assert (tm.coefficients.variances is None) == (
            jm.coefficients.variances is None)
        if tm.coefficients.variances is not None:
            np.testing.assert_allclose(
                tm.coefficients.variances.numpy(),
                np.asarray(jm.coefficients.variances), rtol=SOLVE_TOL)
    if config == "logistic":
        assert got["models"][got["best_index"]]["AUC"] > 0.75


def test_train_glm_refuses_what_is_not_ported_and_cuda_without_a_card(
        tmp_path):
    tr, va = _data(tmp_path, "logistic")
    base = ["--train", tr, "--validation", va,
            "--output-dir", str(tmp_path / "out")]
    args = train_glm.build_parser().parse_args(
        [*base, "--device", "cpu", "--summarization-output-dir",
         str(tmp_path / "summaries")])
    with pytest.raises(NotImplementedError,
                       match=str(not_ported("x", 9)).split(": ", 1)[1]):
        train_glm.run(args)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs its absence")
    for argv in (base, [*base, "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_glm.run(train_glm.build_parser().parse_args(argv))
    assert not os.path.exists(str(tmp_path / "out"))
