"""The port's AUC against the reference's, unweighted and weighted.

Both compute the tie-averaged rank-sum statistic in float32; the sums
run in another order, so they agree to 1e-6.
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
