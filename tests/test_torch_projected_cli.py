"""The projected and subspace random effect through the front doors:
``GameEstimator`` and ``cli/game_train``.

A per-user random effect over a sparse shard (d = 20,000, per-user
column pools) is fitted as a subspace model, and one over a dense shard
with the Pearson cap, each through ``GameEstimator.fit`` (the API's fit)
and through ``game_train`` with ``projector=INDEX_MAP``, ``subspace=``
and ``features_to_samples_ratio=``. Every run gives the API's model bit
for bit: with ``--staging workers=2``, with ``--staging-cache-dir`` (a
cold run that writes the cache, a warm one that reads it) and with
``GameEstimator(staging=, staging_cache_dir=)`` — staging decides where
and when the blocks are built, never what they hold.
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                         RandomEffectDataConfiguration,
                                         StagingConfig)
from photon_ml_torch.api.estimator import GameEstimator
from photon_ml_torch.cli import game_train
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.data.io import save_game_dataset
from photon_ml_torch.game.models import SubspaceRandomEffectModel
from photon_ml_torch.models import io as model_io
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType

N, E = 3000, 150


def _dataset(kind: str) -> GameDataset:
    rng = np.random.default_rng(21)
    ids = rng.integers(0, E, N).astype(np.int32)
    if kind == "sparse":
        d = 20_000
        pools = rng.integers(0, d, size=(E, 12))
        idx = np.sort(pools[ids[:, None], rng.integers(0, 12, (N, 6))],
                      axis=1)
        dup = np.zeros_like(idx, bool)
        dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
        vals = rng.normal(size=(N, 6)).astype(np.float32)
        idx[dup] = d
        vals[dup] = 0.0
        shard = SparseShard(idx.astype(np.int32), vals, d)
        margin = vals.sum(1)
        intercept = {}
    else:
        d = 16
        emask = rng.random((E, d)) < 0.5
        shard = (rng.normal(size=(N, d)) * emask[ids]).astype(np.float32)
        shard[:, 0] = 1.0
        margin = shard[:, 1:4].sum(1)
        intercept = {"re": 0}
    y = (rng.random(N) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return GameDataset(
        response=y, offsets=np.zeros(N, np.float32),
        weights=np.ones(N, np.float32), feature_shards={"re": shard},
        entity_ids={"userId": ids}, num_entities={"userId": E},
        intercept_index=intercept)


CASES = {
    "sparse_subspace": ("sparse", "projector=INDEX_MAP,subspace=true",
                        dict(projector="INDEX_MAP", subspace_model=True)),
    "dense_ratio": ("dense", "projector=INDEX_MAP,"
                             "features_to_samples_ratio=0.5",
                    dict(projector="INDEX_MAP",
                         features_to_samples_ratio=0.5)),
}


def _api_fit(kind, data_kw, **est_kw):
    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=20),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))
    coords = {"per-user": CoordinateConfiguration(
        RandomEffectDataConfiguration("userId", "re",
                                      active_data_lower_bound=2, **data_kw),
        opt)}
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, coords, ["per-user"],
                        device="cpu", validation_evaluators=["AUC"],
                        **est_kw)
    ds = _dataset(kind)
    return est.fit(ds, ds)[0].model.models["per-user"]


def _cli_fit(tmp_path, kind, spec, extra, tag):
    data = str(tmp_path / f"data-{kind}")
    if not os.path.isdir(data):
        save_game_dataset(_dataset(kind), data)
    out = str(tmp_path / f"out-{tag}")
    game_train.run(game_train.build_parser().parse_args([
        "--train", data, "--validation", data, "--coordinate",
        f"name=per-user,type=random,shard=re,re=userId,min_samples=2,{spec}",
        "--update-sequence", "per-user", "--evaluators", "AUC",
        "--opt-config", "per-user:optimizer=LBFGS,reg=L2,reg_weight=1.0,"
                        "max_iter=20",
        "--output-dir", out, "--device", "cpu", *extra]))
    return model_io.load_game_model(os.path.join(out, "best"),
                                    device="cpu").models["per-user"]


def _same(a, b):
    assert type(a) is type(b)
    assert torch.equal(a.means.cpu(), b.means.cpu())
    if isinstance(a, SubspaceRandomEffectModel):
        assert torch.equal(a.cols.cpu().long(), b.cols.cpu().long())


@pytest.mark.parametrize("case", sorted(CASES))
def test_game_train_equals_the_api_fit(tmp_path, case):
    kind, spec, data_kw = CASES[case]
    want = _api_fit(kind, data_kw)
    if kind == "sparse":
        assert isinstance(want, SubspaceRandomEffectModel)
    cache = str(tmp_path / "cache")
    runs = {
        "plain": [],
        "staging": ["--staging", "workers=2,shard_entities=32"],
        "cache_cold": ["--staging-cache-dir", cache],
        "cache_warm": ["--staging-cache-dir", cache],
    }
    for tag, extra in runs.items():
        _same(_cli_fit(tmp_path, kind, spec, extra, tag), want)
        if tag == "cache_cold":
            (key,) = os.listdir(cache)
            assert "meta.json" in os.listdir(os.path.join(cache, key))


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimator_staging_options_give_the_same_model(tmp_path, case):
    kind, _, data_kw = CASES[case]
    want = _api_fit(kind, data_kw)
    got = _api_fit(kind, data_kw,
                   staging=StagingConfig(workers=3, shard_entities=16),
                   staging_cache_dir=str(tmp_path))
    _same(got, want)
    # A second estimator reads the entry the first one wrote (fit()
    # returns after every cache write).
    (key,) = os.listdir(tmp_path)
    assert "meta.json" in os.listdir(tmp_path / key)
    _same(_api_fit(kind, data_kw,
                   staging=StagingConfig(workers=1, shard_entities=16),
                   staging_cache_dir=str(tmp_path)), want)
