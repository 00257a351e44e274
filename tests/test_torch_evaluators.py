"""The port's evaluators against the reference's.

AUC, unweighted and weighted: both compute the tie-averaged rank-sum
statistic in float32; the sums run in another order, so they agree to
1e-6. The pointwise metrics agree to 1e-5 relative; precision@k, the
grouped AUC and precision@k (with an empty and a one-class group) and
the suite to 1e-5, the port's segment sums being float64 prefix-sum
differences where the reference sums in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.evaluation.evaluators import auc
from photon_ml_tpu.evaluation.evaluators import auc as ref_auc


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_auc_matches_reference(weighted, ties):
    rng = np.random.default_rng(31 + 2 * weighted + ties)
    n = 500
    scores = rng.normal(size=n).astype(np.float32)
    if ties:
        scores = np.round(scores * 2) / 2  # many equal-score runs
    labels = (rng.random(n) < 1 / (1 + np.exp(-2 * scores))).astype(
        np.float32)
    weights = rng.uniform(0.1, 3.0, n).astype(np.float32) if weighted \
        else None
    got = auc(torch.from_numpy(scores), torch.from_numpy(labels),
              None if weights is None else torch.from_numpy(weights))
    want = ref_auc(jnp.asarray(scores), jnp.asarray(labels),
                   None if weights is None else jnp.asarray(weights))
    assert got.dtype == torch.float32
    assert 0.5 < float(got) < 1.0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_auc_extremes():
    s = torch.tensor([0.1, 0.2, 0.3, 0.4])
    assert float(auc(s, torch.tensor([0.0, 0.0, 1.0, 1.0]))) == 1.0
    assert float(auc(s, torch.tensor([1.0, 1.0, 0.0, 0.0]))) == 0.0
    assert float(auc(torch.zeros(4), torch.tensor([0.0, 1.0, 0.0, 1.0]))) \
        == 0.5


# -- the rest of the suite ---------------------------------------------------

from photon_ml_torch.evaluation import evaluators as ev  # noqa: E402
from photon_ml_tpu.evaluation import evaluators as ref_ev  # noqa: E402


def _scored(seed, n=400, groups=23, ties=True):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=n).astype(np.float32)
    if ties:
        scores = np.round(scores * 3) / 3
    labels = (rng.random(n) < 1 / (1 + np.exp(-2 * scores))).astype(
        np.float32)
    weights = rng.uniform(0.1, 3.0, n).astype(np.float32)
    gids = rng.integers(0, groups, n).astype(np.int32)
    gids[gids == 5] = 6  # an empty group
    labels[gids == 7] = 1.0  # a one-class group: not valid
    return scores, labels, weights, gids, groups


@pytest.mark.parametrize("name", ["rmse", "squared_loss", "poisson_loss",
                                  "logistic_loss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pointwise_metrics_match_reference(name, weighted):
    s, y, w, _, _ = _scored(1)
    w = w if weighted else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    got = float(getattr(ev, name)(t(s), t(y), t(w)))
    want = float(getattr(ref_ev, name)(j(s), j(y), j(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 10, 1000])
def test_precision_at_k_matches_reference(k):
    s, y, _, _, _ = _scored(2)
    got = float(ev.precision_at_k(torch.from_numpy(s), torch.from_numpy(y),
                                  k))
    want = float(ref_ev.precision_at_k(jnp.asarray(s), jnp.asarray(y), k))
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_grouped_metrics_match_reference(weighted):
    s, y, w, g, G = _scored(3)
    w = w if weighted else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    auc_g, valid = ev.grouped_auc(t(s), t(y), t(g), G, t(w))
    ref_auc_g, ref_valid = ref_ev.grouped_auc(j(s), j(y), j(g), G, j(w))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert not bool(valid[5]) and not bool(valid[7])
    np.testing.assert_allclose(auc_g.numpy()[valid.numpy()],
                               np.asarray(ref_auc_g)[valid.numpy()],
                               rtol=0, atol=1e-5)
    for k in (1, 5):
        prec, pv = ev.grouped_precision_at_k(t(s), t(y), t(g), G, k, t(w))
        ref_prec, ref_pv = ref_ev.grouped_precision_at_k(j(s), j(y), j(g),
                                                         G, k, j(w))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(ref_pv))
        np.testing.assert_allclose(prec.numpy(), np.asarray(ref_prec),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(ev.mean_grouped_auc(t(s), t(y), t(g), G, t(w))),
        float(ref_ev.mean_grouped_auc(j(s), j(y), j(g), G, j(w))),
        rtol=0, atol=1e-5)


def test_evaluator_types_parse_like_reference():
    for spec in ("AUC", "auc", "RMSE", "PRECISION@5", "precision@3@userId",
                 "AUC@itemId", "LOGISTIC_LOSS", "POISSON_LOSS",
                 "SQUARED_LOSS"):
        got, want = ev.EvaluatorType.parse(spec), \
            ref_ev.EvaluatorType.parse(spec)
        assert (got.name, got.k, got.group_column, str(got)) == \
            (want.name, want.k, want.group_column, str(want))
        assert got.direction.value == want.direction.value
    for bad in ("RMSE@userId", "F1", "PRECISION@"):
        with pytest.raises(ValueError):
            ev.EvaluatorType.parse(bad)


def test_evaluation_suite_matches_reference():
    s, y, w, g, G = _scored(4)
    specs = ["AUC", "RMSE", "LOGISTIC_LOSS", "PRECISION@10",
             "AUC@userId", "PRECISION@3@userId"]
    got = ev.evaluation_suite(specs, torch.from_numpy(s), y, w,
                              {"userId": g}, {"userId": G})
    want = ref_ev.evaluation_suite(specs, jnp.asarray(s), y, w,
                                   {"userId": g}, {"userId": G})
    assert got.primary == want.primary == "AUC"
    assert set(got.metrics) == set(want.metrics)
    for key, value in want.metrics.items():
        assert got.metrics[key] == pytest.approx(value, abs=1e-5), key
    worse = ev.EvaluationResults({"AUC": got.primary_value - 0.1}, "AUC")
    assert got.better_than(worse) and not worse.better_than(got)
    assert got.better_than(None)
    loss = ev.EvaluationResults({"RMSE": 1.0}, "RMSE")
    assert ev.EvaluationResults({"RMSE": 0.5}, "RMSE").better_than(loss)
    with pytest.raises(ValueError, match="needs group_ids"):
        ev.evaluation_suite(["AUC@itemId"], torch.from_numpy(s), y)
