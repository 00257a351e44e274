"""The port's serving path emits the reference's scoring lifecycle.

Both ScoringServices load one model directory and score the same
requests, each with its own emitter: a ``ScoringStart(source="serving",
num_rows=None)`` when the service comes up, one ``ScoringBatch`` a flush
(its rows and padded bucket), and a ``ScoringFinish`` with the rows
served at close — the same sequence, seconds aside. With observability
on, the obs bridge counts the rows served into
``photon_scoring_rows_total``, and ``cli/serve --metrics-dump`` writes
that count.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch import obs
from photon_ml_torch.cli import serve as tserve
from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_ml_torch.models import io as tio
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.serving import ScoringRequest, ScoringService
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils.events import EventEmitter
from photon_ml_tpu.models import io as jio
from photon_ml_tpu.serving import ScoringRequest as JRequest
from photon_ml_tpu.serving import ScoringService as JService
from photon_ml_tpu.utils.events import EventEmitter as JEmitter

D_GLOBAL, D_RE, E = 5, 3, 10


@pytest.fixture(autouse=True)
def _obs_off_after():
    yield
    obs.disable()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    rng = np.random.default_rng(4)
    path = str(tmp_path_factory.mktemp("serving-events") / "model")
    tio.save_game_model(GameModel(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectModel("global", Coefficients(torch.from_numpy(
            rng.normal(size=D_GLOBAL).astype(np.float32)))),
        "per-user": RandomEffectModel("userId", "re_userId",
                                      torch.from_numpy(rng.normal(
                                          size=(E, D_RE)).astype(
                                              np.float32)))}), path)
    return path


def _requests(cls, n):
    rng = np.random.default_rng(7)
    return [cls(features={
        "global": rng.normal(size=D_GLOBAL).astype(np.float32),
        "re_userId": rng.normal(size=D_RE).astype(np.float32)},
        entity_ids={"userId": int(rng.integers(0, E + 2))},
        offset=float(rng.normal()), uid=i) for i in range(n)]


def _sequence(events):
    """The events without their timings."""
    out = []
    for e in events:
        fields = {k: v for k, v in vars(e).items()
                  if k not in ("seconds", "wall_seconds")}
        out.append((type(e).__name__, fields))
    return out


@pytest.mark.parametrize("n,max_batch", [(11, 4), (16, 16), (1, 8)])
def test_scoring_events_match_reference(model_dir, n, max_batch):
    got, want = [], []
    port_emitter, ref_emitter = EventEmitter(), JEmitter()
    port_emitter.register(got.append)
    ref_emitter.register(want.append)
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        max_batch=max_batch, emitter=port_emitter) as svc:
        svc.score(_requests(ScoringRequest, n))
        # Requests through the micro-batcher flush too.
        svc.submit(_requests(ScoringRequest, 1)[0]).result(timeout=30)
    with JService(jio.load_game_model(model_dir), max_batch=max_batch,
                  emitter=ref_emitter) as ref:
        ref.score(_requests(JRequest, n))
        ref.submit(_requests(JRequest, 1)[0]).result(timeout=30)
    assert _sequence(got) == _sequence(want)
    assert got[0].source == "serving" and got[0].num_rows is None
    assert got[-1].num_rows == n + 1
    assert sum(e.rows for e in got[1:-1]) == n + 1


def test_serve_metrics_dump_counts_rows_served(model_dir, tmp_path):
    """The dump path ``cli/serve`` runs at shutdown, after a served
    session: the registry's scoring counter is the rows served."""
    args = tserve.build_parser().parse_args(
        ["--model-dir", model_dir, "--port", "0", "--device", "cpu",
         "--metrics-dump", str(tmp_path / "m.prom")])
    obs.enable(trace=False, metrics=True)
    try:
        server, svc = tserve.create_server(args)
        try:
            svc.score(_requests(ScoringRequest, 9))
            svc.submit(_requests(ScoringRequest, 1)[0]).result(timeout=30)
        finally:
            server.server_close()
            svc.close()
            tserve._dump_observability(svc, None, args.metrics_dump)
    finally:
        obs.disable()
    parsed = obs.parse_prometheus_text((tmp_path / "m.prom").read_text())
    assert obs.metric_value(parsed, "photon_scoring_rows_total") == 10
    assert parsed.get("photon_serving_rows_total") == 10
