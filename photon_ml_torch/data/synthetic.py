"""Synthetic datasets (port of ``glm_classification``, ``a1a_like`` and
``game_data`` from ``photon_ml_tpu/data/synthetic.py``).

They stand in for BASELINE's public datasets, which are not fetched:
a1a's shape for the GLM configs and MovieLens-20M's for config 4, with
planted models, seeded and reproducible: each generator draws the same
numbers in the same order as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def glm_classification(
    rng: np.random.Generator,
    n: int,
    d: int,
    *,
    intercept: bool = True,
    noise: float = 0.0,
    weight_scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Balanced-ish binary data from a ground-truth logistic model.

    Returns (X, y, w_true); last column of X is the intercept if requested.
    """
    X = rng.normal(size=(n, d)).astype(np.float32)
    if intercept:
        X[:, -1] = 1.0
    w_true = (rng.normal(size=d) * weight_scale).astype(np.float32)
    logits = X @ w_true + noise * rng.normal(size=n).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y, w_true


def a1a_like(rng: np.random.Generator, n: int = 1605, d: int = 123,
             density: float = 0.11) -> tuple[np.ndarray, np.ndarray]:
    """Sparse binary features in the a1a regime (123 binary features,
    ~14 set per row) with a planted logistic model."""
    X = (rng.uniform(size=(n, d)) < density).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32) * 0.8
    logits = X @ w_true - np.mean(X @ w_true)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return X, y


@dataclasses.dataclass
class SyntheticGameData:
    """Columnar GAME dataset: global features + per-entity assignments."""

    # global shard
    X_global: np.ndarray  # (n, d_global)
    # per-RE-type: entity ids (n,) int32 and the RE feature shard (n, d_re)
    entity_ids: dict[str, np.ndarray]
    X_entity: dict[str, np.ndarray]
    num_entities: dict[str, int]
    response: np.ndarray  # (n,)
    offsets: np.ndarray
    weights: np.ndarray


def game_data(
    rng: np.random.Generator,
    n: int = 5000,
    d_global: int = 20,
    re_specs: Optional[dict[str, tuple[int, int]]] = None,  # name -> (E, d_re)
    task: str = "logistic",
    entity_skew: float = 1.2,
) -> SyntheticGameData:
    """GAME data with planted fixed + random effects.

    Entity assignment is Zipf-skewed (the per-user activity distribution
    of MovieLens-style data).
    """
    if re_specs is None:
        re_specs = {"userId": (200, 8), "itemId": (100, 6)}
    X_global = rng.normal(size=(n, d_global)).astype(np.float32)
    X_global[:, -1] = 1.0
    w_global = rng.normal(size=d_global).astype(np.float32) * 0.5
    logits = X_global @ w_global

    entity_ids: dict[str, np.ndarray] = {}
    X_entity: dict[str, np.ndarray] = {}
    num_entities: dict[str, int] = {}
    for name, (ne, d_re) in re_specs.items():
        p = (1.0 / np.arange(1, ne + 1) ** entity_skew)
        p /= p.sum()
        ids = rng.choice(ne, size=n, p=p).astype(np.int32)
        Xr = rng.normal(size=(n, d_re)).astype(np.float32)
        Xr[:, -1] = 1.0
        W_re = rng.normal(size=(ne, d_re)).astype(np.float32) * 0.7
        logits = logits + np.einsum("nd,nd->n", Xr, W_re[ids])
        entity_ids[name] = ids
        X_entity[name] = Xr
        num_entities[name] = ne

    if task == "logistic":
        p = 1.0 / (1.0 + np.exp(-logits))
        y = (rng.uniform(size=n) < p).astype(np.float32)
    elif task == "linear":
        y = (logits + 0.1 * rng.normal(size=n)).astype(np.float32)
    elif task == "poisson":
        y = rng.poisson(np.exp(np.clip(logits * 0.3, -5, 3))).astype(np.float32)
    else:
        raise ValueError(task)

    return SyntheticGameData(
        X_global=X_global,
        entity_ids=entity_ids,
        X_entity=X_entity,
        num_entities=num_entities,
        response=y,
        offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32),
    )
