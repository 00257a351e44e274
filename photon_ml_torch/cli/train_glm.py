"""Single-GLM training driver (the legacy Photon pipeline).

Port of ``photon_ml_tpu/cli/train_glm.py``. Reference parity:
photon-client ``Driver.scala`` + ``io/GLMSuite.scala``: stages INIT →
TRAIN → VALIDATE: read data, summarize/normalize, train one model per
regularization weight, evaluate each on validation data, select and save
the best model (``ModelOutputMode`` ALL/BEST). Runs on the CUDA card
unless ``--device cpu`` is given.

Usage:
    python -m photon_ml_torch.cli.train_glm \\
        --train a1a.libsvm --validation a1a.t.libsvm \\
        --task LOGISTIC_REGRESSION --optimizer LBFGS \\
        --reg-weights 0.1,1,10 --normalization STANDARDIZATION \\
        --output-dir /tmp/model
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.data.batch import LabeledBatch
from photon_ml_torch.data.libsvm import read_libsvm
from photon_ml_torch.data.statistics import (normalization_from_statistics,
                                             summarize)
from photon_ml_torch.data.validators import (DataValidationLevel,
                                             validate_arrays,
                                             validate_features)
from photon_ml_torch.device import resolve_device
from photon_ml_torch.evaluation import evaluators as ev
from photon_ml_torch.models import io as model_io
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.normalization import NormalizationType
from photon_ml_torch.ops import losses as losses_mod
from photon_ml_torch.optim import OptimizerConfig, OptimizerType
from photon_ml_torch.optim import problem
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils.logging import Timer, setup_logging

logger = logging.getLogger("photon_ml_torch.cli")

_DEFAULT_EVALUATOR = {
    TaskType.LOGISTIC_REGRESSION: "AUC",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "AUC",
    TaskType.LINEAR_REGRESSION: "RMSE",
    TaskType.POISSON_REGRESSION: "POISSON_LOSS",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", required=True, help="training LIBSVM file")
    p.add_argument("--validation", help="validation LIBSVM file")
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.value for t in TaskType])
    p.add_argument("--optimizer", default="LBFGS",
                   choices=[o.value for o in OptimizerType])
    p.add_argument("--reg-type", default="L2",
                   choices=[r.value for r in RegularizationType])
    p.add_argument("--reg-weights", default="1.0",
                   help="comma-separated regularization weight grid")
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--normalization", default="NONE",
                   choices=[n.value for n in NormalizationType])
    p.add_argument("--no-intercept", action="store_true")
    p.add_argument("--variance", default="NONE",
                   choices=[v.value for v in VarianceComputationType])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--output-mode", default="BEST", choices=["BEST", "ALL"])
    p.add_argument("--num-features", type=int,
                   help="fixed feature-space size (else inferred)")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.value for v in DataValidationLevel],
                   help="input sanity checks (reference DataValidators)")
    p.add_argument("--summarization-output-dir",
                   help="write per-feature FeatureSummarizationResultAvro "
                        "records here (reference summarization output)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the data and the solve live; cuda raises "
                        "when no card is available")
    return p


def _with_intercept(X: np.ndarray, no_intercept: bool) -> np.ndarray:
    if no_intercept:
        return X
    return np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], 1)


def _solve(args, loss, batch, norm, intercept_index, reg_weights):
    """One model per regularization weight: the coefficients in the
    transformed space, and (converged, iterations, final value) as
    tensors, one entry per weight, still on the device."""
    def make_cfg(lam):
        return GLMOptimizationConfiguration(
            optimizer=OptimizerConfig(
                optimizer_type=OptimizerType(args.optimizer),
                max_iterations=args.max_iterations,
                tolerance=args.tolerance),
            regularization=RegularizationContext(
                RegularizationType(args.reg_type), lam,
                args.elastic_net_alpha),
            variance_computation=VarianceComputationType(args.variance))

    # An eligible L2 grid solves every weight at once, one solver lane
    # each; L1/elastic-net grids and variance computation stay on the
    # sequential path.
    grid_eligible = (
        len(reg_weights) > 1
        and RegularizationType(args.reg_type) == RegularizationType.L2
        and VarianceComputationType(args.variance)
        == VarianceComputationType.NONE
        and OptimizerType(args.optimizer) != OptimizerType.OWLQN)
    if grid_eligible:
        W, result = problem.run_grid(
            loss, batch, make_cfg(reg_weights[0]), reg_weights,
            norm=norm, intercept_index=intercept_index)
        logger.info("solved %d-point reg grid in one lane-batched solve",
                    len(reg_weights))
        return ([Coefficients(W[k]) for k in range(len(reg_weights))],
                (result.converged, result.iterations, result.value))
    coefs, results = [], []
    for lam in reg_weights:
        coef, result = problem.run(loss, batch, make_cfg(lam), norm=norm,
                                   intercept_index=intercept_index)
        coefs.append(coef)
        results.append(result)
    return coefs, tuple(torch.cat([getattr(r, k) for r in results])
                        for k in ("converged", "iterations", "value"))


def run(args) -> dict:
    setup_logging()
    if args.summarization_output_dir:
        raise not_ported("--summarization-output-dir (the Avro feature "
                         "summaries)", 9)
    device = resolve_device(args.device)
    task = TaskType(args.task)
    loss = losses_mod.loss_for_task(task)
    t0 = time.perf_counter()
    # Seconds by stage, logged at the end. On the card each stage ends
    # in a read of the device (the solve in its last convergence check),
    # so the stages split the wall time.
    timer = Timer()

    with timer.scope("parse"):
        train = read_libsvm(args.train, num_features=args.num_features)
        X = _with_intercept(train.to_dense(), args.no_intercept)
        intercept_index = None if args.no_intercept else X.shape[1] - 1
        # INIT-stage sanity checks (reference:
        # DataValidators.sanityCheckData).
        vlevel = DataValidationLevel(args.data_validation)
        validate_arrays(task, train.labels, level=vlevel)
        validate_features("train", X, level=vlevel)
        logger.info("read %d x %d training examples", *X.shape)
        if args.validation:
            v = read_libsvm(args.validation, num_features=X.shape[1]
                            - (0 if args.no_intercept else 1))
            Xv = _with_intercept(v.to_dense(), args.no_intercept)
            # Validation data gets the same sanity checks: a NaN here
            # would otherwise turn every candidate's metric into NaN and
            # make select-best arbitrary.
            validate_arrays(task, v.labels, level=vlevel)
            validate_features("validation", Xv, level=vlevel)

    with timer.scope("stage"):
        batch = LabeledBatch.build(X, train.labels, device=device)
        val = None
        if args.validation:
            val = (torch.from_numpy(Xv).to(device),
                   torch.from_numpy(v.labels).to(device))
        stats = summarize(batch)
        norm = normalization_from_statistics(
            stats, NormalizationType(args.normalization), intercept_index)

    reg_weights = [float(w) for w in args.reg_weights.split(",") if w]
    evaluator = _DEFAULT_EVALUATOR[task]
    et = ev.EvaluatorType.parse(evaluator)

    with timer.scope("solve"):
        coefs, fit_stats = _solve(args, loss, batch, norm, intercept_index,
                                  reg_weights)

    with timer.scope("evaluate"):
        candidates = []
        val_scores = []
        for coef in coefs:
            # Export coefficients in the ORIGINAL feature space
            # (reference: models are transformed back before writing).
            raw_means = norm.model_to_original_space(coef.means)
            raw_vars = coef.variances
            if raw_vars is not None:
                raw_vars = norm.variances_to_original_space(raw_vars)
            model = GeneralizedLinearModel(
                task=task, coefficients=Coefficients(raw_means, raw_vars))
            if val is not None:
                # Device work only inside the sweep: the metrics evaluate
                # after it, and reach the host in one transfer.
                val_scores.append(model.compute_score(val[0]))
            candidates.append(model)

        records = [{"reg_weight": lam, "converged": c, "iterations": i,
                    "final_loss": f}
                   for lam, (c, i, f) in zip(reg_weights, zip(
                       *(t.tolist() for t in fit_stats)))]
        if val is not None:
            metrics = torch.stack([ev.evaluate(et, s, val[1])
                                   for s in val_scores]).tolist()
            for record, value in zip(records, metrics):
                record[evaluator] = value
    for record in records:
        logger.info("lambda=%g: %s", record["reg_weight"], record)

    if val is not None:
        best_i = max(range(len(records)),
                     key=lambda i: (records[i][evaluator]
                                    if et.direction == ev.MetricDirection.HIGHER_IS_BETTER
                                    else -records[i][evaluator]))
    else:
        best_i = int(np.argmin([r["final_loss"] for r in records]))

    os.makedirs(args.output_dir, exist_ok=True)
    to_save = (range(len(candidates)) if args.output_mode == "ALL"
               else [best_i])
    with timer.scope("save"):
        for i in to_save:
            model_io.save_glm(candidates[i],
                              os.path.join(args.output_dir, f"model-{i}"))
    summary = {
        "task": task.value,
        "models": records,
        "best_index": best_i,
        "wall_seconds": time.perf_counter() - t0,
    }
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("wrote %s", args.output_dir)
    logger.info("seconds by stage: %s", json.dumps(timer.durations))
    return summary


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
