"""Offline scoring: ``GameTransformer`` and ``cli/game_score`` against the
reference.

One GAME model (a dense fixed effect, an ELL fixed effect and a random
effect with unseen entities) is written by the port and read by the
reference, and both score the same dataset: ``transform``,
``transform_batched`` and ``transform_and_evaluate`` agree within 1e-6
on scores and 1e-5 on metrics, and both CLIs write the same
``scores.npz`` and ``summary.json``. On the CPU ``transform_batched``
gives ``transform``'s bits with a ragged last chunk, each scored batch
emits a ``ScoringBatch``, and the obs bridge counts the rows scored into
``photon_scoring_rows_total``.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_torch import obs
from photon_ml_torch.api.transformer import GameTransformer
from photon_ml_torch.cli import game_score
from photon_ml_torch.data.game_data import GameDataset, SparseShard
from photon_ml_torch.data.io import load_game_dataset, save_game_dataset
from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_ml_torch.models import io as tio
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils.events import (ScoringBatch, ScoringFinish,
                                          ScoringStart, default_emitter)
from photon_ml_tpu.api.transformer import GameTransformer as RefTransformer
from photon_ml_tpu.cli import game_score as ref_game_score
from photon_ml_tpu.data import io as jio
from photon_ml_tpu.models import io as jmio

SCORE_TOL = 1e-6
METRIC_TOL = 1e-5
N, D, D_RE, E, DIM, K = 203, 6, 3, 9, 50, 5


@pytest.fixture(autouse=True)
def _obs_off_after():
    yield
    obs.disable()


def _dataset(seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, DIM, size=(N, K)).astype(np.int32)
    idx[rng.random((N, K)) < 0.3] = DIM  # padding slots
    margin = rng.normal(size=N)
    return GameDataset(
        response=(rng.random(N) < 1 / (1 + np.exp(-margin))).astype(
            np.float32),
        offsets=(0.1 * rng.normal(size=N)).astype(np.float32),
        weights=rng.uniform(0.5, 2.0, size=N).astype(np.float32),
        feature_shards={
            "global": rng.normal(size=(N, D)).astype(np.float32),
            "re_userId": rng.normal(size=(N, D_RE)).astype(np.float32),
            "ctr": SparseShard(indices=idx,
                               values=rng.normal(size=(N, K)).astype(
                                   np.float32), num_features=DIM)},
        # ids past the table (E, E + 1) are unseen entities.
        entity_ids={"userId": rng.integers(0, E + 2, size=N).astype(
            np.int32)},
        num_entities={"userId": E + 2},
        intercept_index={"global": D - 1})


def _model(seed=1):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return GameModel(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectModel("global", Coefficients(t(D))),
        "ctr": FixedEffectModel("ctr", Coefficients(t(DIM))),
        "per-user": RandomEffectModel("userId", "re_userId", t(E, D_RE))})


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The model and dataset written by the port, and each package's
    reading of them."""
    root = tmp_path_factory.mktemp("carried")
    model_dir, data_dir = str(root / "model"), str(root / "data")
    tio.save_game_model(_model(), model_dir)
    save_game_dataset(_dataset(), data_dir)
    return {"model_dir": model_dir, "data_dir": data_dir,
            "model": tio.load_game_model(model_dir),
            "ref_model": jmio.load_game_model(model_dir),
            "data": load_game_dataset(data_dir),
            "ref_data": jio.load_game_dataset(data_dir)}


EVALUATORS = ["AUC", "LOGISTIC_LOSS", "AUC@userId"]
TRANSFORM_CASES = {
    "transform": ("transform", {}),
    "transform_as_mean": ("transform", {"as_mean": True}),
    "batched": ("transform_batched", {"batch_rows": 40}),
    "batched_as_mean": ("transform_batched", {"batch_rows": 64,
                                              "as_mean": True}),
    "evaluate": ("transform_and_evaluate", {}),
    "evaluate_batched_as_mean": ("transform_and_evaluate",
                                 {"batch_rows": 50, "as_mean": True}),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transformer_matches_reference(carried, case):
    method, kwargs = TRANSFORM_CASES[case]
    got = getattr(GameTransformer(carried["model"], EVALUATORS), method)(
        carried["data"], **kwargs)
    want = getattr(RefTransformer(carried["ref_model"], EVALUATORS), method)(
        carried["ref_data"], **kwargs)
    if method == "transform_and_evaluate":
        (got, got_eval), (want, want_eval) = got, want
        assert got_eval.metrics.keys() == want_eval.metrics.keys()
        assert got_eval.primary == want_eval.primary
        for k, v in want_eval.metrics.items():
            assert abs(got_eval.metrics[k] - v) <= METRIC_TOL, k
    assert got.scores.dtype == np.float32
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(got.uids, want.uids)
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("batch_rows,as_mean", [(37, False), (64, True),
                                                (N, False), (1000, False)])
def test_batched_scores_are_transforms_bits(carried, batch_rows, as_mean):
    tr = GameTransformer(carried["model"])
    one = tr.transform(carried["data"], as_mean=as_mean)
    batched = tr.transform_batched(carried["data"], batch_rows,
                                   as_mean=as_mean)
    assert np.array_equal(one.scores, batched.scores)
    assert batched.scores.shape == (N,)


def test_each_batch_emits_scoring_batch_and_counts_rows(carried):
    seen = []
    default_emitter.register(seen.append)
    try:
        with obs.activated(metrics_obj=obs.MetricsRegistry()) as (_, mx):
            GameTransformer(carried["model"]).transform_batched(
                carried["data"], 50)
            text = mx.render_text()
    finally:
        default_emitter.unregister(seen.append)
    batches = [e for e in seen if isinstance(e, ScoringBatch)]
    assert [e.rows for e in batches] == [50, 50, 50, 50, 3]
    assert all(e.source == "game_score" and e.padded_rows == e.rows
               for e in batches)
    parsed = obs.parse_prometheus_text(text)
    assert obs.metric_value(parsed, "photon_scoring_rows_total") == N


CLI_CASES = {
    "plain": [],
    "evaluators": ["--evaluators", ",".join(EVALUATORS)],
    "batched": ["--batch-rows", "40"],
    "batched_evaluators_as_mean": ["--batch-rows", "64", "--as-mean",
                                   "--evaluators", "AUC"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_game_score_cli_matches_reference(carried, tmp_path, case):
    common = ["--data", carried["data_dir"], "--model-dir",
              carried["model_dir"], *CLI_CASES[case]]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    seen = []
    default_emitter.register(seen.append)
    try:
        got = game_score.run(game_score.build_parser().parse_args(
            [*common, "--output-dir", port_out, "--device", "cpu"]))
    finally:
        default_emitter.unregister(seen.append)
    want = ref_game_score.run(ref_game_score.build_parser().parse_args(
        [*common, "--output-dir", ref_out]))
    assert got.keys() == want.keys()
    assert got["num_rows"] == want["num_rows"] == N
    for k, v in want.get("metrics", {}).items():
        assert abs(got["metrics"][k] - v) <= METRIC_TOL, k
    with open(os.path.join(port_out, "summary.json")) as f:
        assert json.load(f).keys() == want.keys()
    g = np.load(os.path.join(port_out, "scores.npz"))
    w = np.load(os.path.join(ref_out, "scores.npz"))
    assert sorted(g.files) == sorted(w.files)
    for name in w.files:
        assert g[name].dtype == w[name].dtype, name
        if name == "score":
            np.testing.assert_allclose(g[name], w[name], rtol=0,
                                       atol=SCORE_TOL)
        else:
            np.testing.assert_array_equal(g[name], w[name])
    # The lifecycle: one Start, one Finish after every batch.
    kinds = [type(e) for e in seen]
    assert kinds[0] is ScoringStart and kinds[-1] is ScoringFinish
    assert kinds.count(ScoringStart) == kinds.count(ScoringFinish) == 1
    assert sum(e.rows for e in seen if isinstance(e, ScoringBatch)) == N


def test_game_score_finishes_its_scope_when_writing_fails(carried, tmp_path):
    """ScoringFinish is emitted in a finally: a run that raises mid-write
    still closes its scoring scope."""
    seen = []
    out = tmp_path / "out"
    out.mkdir()
    (out / "scores.npz").mkdir()  # the writer cannot create the file
    default_emitter.register(seen.append)
    try:
        with pytest.raises(OSError):
            game_score.run(game_score.build_parser().parse_args([
                "--data", carried["data_dir"], "--model-dir",
                carried["model_dir"], "--output-dir", str(out),
                "--device", "cpu"]))
    finally:
        default_emitter.unregister(seen.append)
    assert isinstance(seen[-1], ScoringFinish)
    assert not (out / "summary.json").exists()
