"""Down-samplers for fixed-effect coordinate throughput.

Port of ``photon_ml_tpu/game/sampling.py``. Reference parity: photon-api
``sampling/DownSampler.scala``, ``sampling/DefaultDownSampler.scala``
(uniform subsample, weights rescaled by 1/rate) and
``sampling/BinaryClassificationDownSampler.scala`` (keep all positives,
sample negatives at the rate, rescale negative weights).

The draws stay on the host with ``np.random.Generator``, the reference's
generator: the same seed gives the same indices and multipliers bit for
bit (``torch.Generator`` draws differently). A coordinate moves them to
its device once per draw.
"""

from __future__ import annotations

import numpy as np


def default_down_sample(
    rng: np.random.Generator,
    n: int,
    rate: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform subsample; returns (indices, weight_multipliers)."""
    k = max(1, int(round(n * rate)))
    idx = rng.choice(n, size=k, replace=False)
    mult = np.full(k, 1.0 / rate, np.float32)
    return idx, mult


def binary_classification_down_sample(
    rng: np.random.Generator,
    labels: np.ndarray,
    rate: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Keep all positives; sample negatives at ``rate`` with 1/rate weights.

    The index set has a deterministic size given (labels, rate):
    num_pos + round(num_neg*rate).
    """
    pos = np.where(labels > 0)[0]
    neg = np.where(labels <= 0)[0]
    k = max(1, int(round(len(neg) * rate)))
    sampled_neg = rng.choice(len(neg), size=min(k, len(neg)), replace=False)
    idx = np.concatenate([pos, neg[sampled_neg]])
    mult = np.concatenate([
        np.ones(len(pos), np.float32),
        np.full(len(sampled_neg), 1.0 / rate, np.float32),
    ])
    return idx, mult
