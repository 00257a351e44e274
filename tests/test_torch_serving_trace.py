"""The port's serving path traced: request spans across the batcher's
thread boundary, stage attribution, the SLO tracker, queue depth and the
serve CLI's trace and metrics dumps.

Carries over ``tests/test_serving_trace.py`` against
``photon_ml_torch.serving`` on the CPU. The port's attribution ends a
request's queue wait where its flush's assembly starts (the wait for the
scoring lock included), so its four stage spans sum to the request span
exactly; they are held to 1 µs here, tighter than the reference's 10%,
and the ``summarize --serving`` percentiles to the service's own
latency histogram.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_torch import obs
from photon_ml_torch.cli.obs import (summarize_serving, summarize_trace,
                                     verify_trace)
from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.obs.metrics import Gauge
from photon_ml_torch.serving import (BatcherQueueFull, MicroBatcher,
                                     ScoringRequest, ScoringService,
                                     make_http_server)
from photon_ml_torch.serving.metrics import STAGES, SLOTracker
from photon_ml_torch.types import TaskType

STAGE_SPANS = ("serving.queue_wait", "serving.assemble",
               "serving.device_score", "serving.respond")


@pytest.fixture(autouse=True)
def _obs_off_after():
    yield
    obs.disable()


@pytest.fixture
def rng():
    return np.random.default_rng(8)


def _tiny_model(rng, d_global=6, d_re=4, num_entities=12):
    return GameModel(task=TaskType.LOGISTIC_REGRESSION, models={
        "fixed": FixedEffectModel("global", Coefficients(torch.from_numpy(
            rng.normal(size=d_global).astype(np.float32)))),
        "per-user": RandomEffectModel(
            "userId", "re_userId", torch.from_numpy(
                rng.normal(size=(num_entities, d_re)).astype(np.float32))),
    })


def _service(model, **kw):
    return ScoringService(model, device="cpu", **kw)


def _request(rng, model, eid=0):
    return ScoringRequest(
        features={"global": rng.normal(
            size=model.models["fixed"].dim).astype(np.float32),
            "re_userId": rng.normal(
                size=model.models["per-user"].dim).astype(np.float32)},
        entity_ids={"userId": int(eid)})


def _spans(trace, name=None):
    out = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    if name is not None:
        out = [e for e in out if e["name"] == name]
    return out


def _traced(rng, n, max_batch=4):
    """n requests through a traced service; (trace, service metrics)."""
    model = _tiny_model(rng)
    tracer = obs.Tracer()
    with obs.activated(trace_obj=tracer):
        with _service(model, max_batch=max_batch, max_wait_ms=1.0) as svc:
            futs = [svc.submit(_request(rng, model, i % 12))
                    for i in range(n)]
            for f in futs:
                f.result(timeout=30)
    assert tracer.open_spans() == 0  # close() leaked nothing
    return tracer.chrome_trace(), svc


# -- trace propagation across the batcher worker thread ---------------------


def test_request_spans_parent_into_flush_spans(rng):
    trace, _ = _traced(rng, 11)
    assert verify_trace(trace) == []
    flush_ids = {e["args"]["span_id"]
                 for e in _spans(trace, "serving.flush")}
    requests = _spans(trace, "serving.request")
    assert len(requests) == 11
    assert flush_ids, "no serving.flush spans in trace"
    for e in requests:
        assert e["args"]["parent_id"] in flush_ids
        assert e["args"]["request_id"] > 0
        assert e["args"]["crosses_queue"] is True


def test_attribution_children_sum_to_request_total(rng):
    trace, _ = _traced(rng, 9)
    children: dict = {}
    for name in STAGE_SPANS:
        for e in _spans(trace, name):
            children.setdefault(e["args"]["parent_id"], []).append(e)
    for req in _spans(trace, "serving.request"):
        kids = children[req["args"]["span_id"]]
        assert sorted(k["name"] for k in kids) == sorted(STAGE_SPANS)
        assert abs(sum(k["dur"] for k in kids) - req["dur"]) <= 1.0  # us
        # Children are contained in the request interval.
        for k in kids:
            assert k["ts"] >= req["ts"] - 1.0
            assert k["ts"] + k["dur"] <= req["ts"] + req["dur"] + 1.0


def test_untraced_path_has_attribution_but_no_spans(rng):
    model = _tiny_model(rng)
    with _service(model, max_batch=2, max_wait_ms=1.0) as svc:
        fut = svc.submit(_request(rng, model))
        fut.result(timeout=30)
        attr = fut.attribution
        assert attr is not None  # always measured
        stages = (attr["queue_wait_ms"] + attr["assemble_ms"]
                  + attr["device_score_ms"] + attr["respond_ms"])
        assert stages == pytest.approx(attr["total_ms"], rel=0.10)
        snap = svc.metrics.snapshot()
    assert snap["stage_requests_total"] == 1
    assert sum(snap["stage_seconds_total"].values()) == pytest.approx(
        snap["request_latency_sum_seconds"], rel=0.10)
    assert obs.tracer() is None  # nothing got enabled as a side effect


def test_summarize_serving_renders_stage_attribution(rng):
    trace, svc = _traced(rng, 9)
    summary = summarize_serving(trace)
    assert summary["requests"] == 9
    assert summary["flushes"] >= 1
    assert summary["request_latency_ms"]["p99"] > 0
    assert 0.85 <= summary["attributed_fraction"] <= 1.01
    fracs = [a["frac_of_request_time"]
             for a in summary["stage_attribution"].values()]
    assert sum(fracs) == pytest.approx(summary["attributed_fraction"],
                                       abs=1e-6)
    wf = summary["slowest_request"]["waterfall"]
    assert [w["stage"] for w in wf] == list(STAGE_SPANS)
    # The spans carry the latencies the service's own histogram holds:
    # over an odd count the nearest-rank median (summarize's) and the
    # interpolated one (the histogram's) are the same sample.
    own = svc.metrics.request_latency.percentile(50) * 1e3
    assert summary["request_latency_ms"]["p50"] == pytest.approx(
        own, rel=1e-6)
    assert summarize_trace(trace)["wall_seconds"] > 0


# -- SLO tracker -------------------------------------------------------------


def test_slo_tracker_window_and_burn_rate():
    slo = SLOTracker(window_s=10.0, availability_objective=0.99)
    t0 = 1000.0
    for i in range(98):
        slo.record_ok(0.001 * (i + 1), now=t0 + i * 0.01)
    slo.record_bad("shed", now=t0 + 1.0)
    slo.record_bad("deadline", now=t0 + 1.1)
    s = slo.snapshot(now=t0 + 2.0)
    assert s["requests_in_window"] == 100
    assert s["bad_in_window"] == 2
    assert s["bad_by_kind"] == {"shed": 1, "deadline": 1}
    assert s["availability"] == pytest.approx(0.98)
    assert s["budget_burn_rate"] == pytest.approx(2.0)
    assert s["p50_ms"] == pytest.approx(49.5, rel=0.05)
    s2 = slo.snapshot(now=t0 + 22.0)
    assert s2["requests_in_window"] == 0
    assert s2["budget_burn_rate"] == 0.0


def test_slo_tracker_latency_objective_burns_budget():
    slo = SLOTracker(window_s=60.0, availability_objective=0.9,
                     latency_objective_ms=10.0)
    t0 = 50.0
    slo.record_ok(0.001, now=t0)  # fast: fine
    slo.record_ok(0.5, now=t0)  # slow: burns budget
    s = slo.snapshot(now=t0 + 1.0)
    assert s["requests_in_window"] == 2
    assert s["bad_by_kind"] == {"slow": 1}
    assert s["availability"] == pytest.approx(0.5)


def test_service_slo_counts_shed_and_errors(rng):
    model = _tiny_model(rng)
    with _service(model, max_batch=2, max_queue=1,
                  max_wait_ms=200.0) as svc:
        svc.submit(_request(rng, model))  # occupies the queue
        with pytest.raises(BatcherQueueFull):
            svc.submit(_request(rng, model))
        svc.metrics.record_http_error(500)
        svc.metrics.record_http_error(503)  # NOT double-counted: shed
        s = svc.slo_snapshot()
    assert s["bad_by_kind"].get("shed") == 1
    assert s["bad_by_kind"].get("error") == 1
    assert s["lifetime"]["shed_total"] == 1


# -- queue depth observability ----------------------------------------------


def test_queue_depth_gauge_and_503_body():
    started = threading.Event()
    release = threading.Event()

    def slow_flush(entries):
        started.set()
        release.wait(timeout=30)
        return [0.0] * len(entries)

    gauge = Gauge()
    b = MicroBatcher(slow_flush, max_batch=1, max_wait_ms=1.0,
                     max_queue=3, depth_gauge=gauge)
    try:
        futs = [b.submit(0)]  # taken in flight (flush blocks on release)
        assert started.wait(timeout=10)
        futs += [b.submit(i) for i in (1, 2, 3)]  # exactly fills the queue
        with pytest.raises(BatcherQueueFull) as ei:
            b.submit(99)
        assert ei.value.depth == 3
        assert ei.value.max_queue == 3
        assert "3 pending, max 3" in str(ei.value)
        assert gauge.peak >= 3
        release.set()
        for f in futs:
            f.result(timeout=30)
    finally:
        release.set()
        b.close()
    assert gauge.value == 0  # drained


def test_metrics_text_has_queue_depth_stages_and_slo(rng):
    model = _tiny_model(rng)
    with _service(model, max_batch=2, max_wait_ms=1.0) as svc:
        svc.submit(_request(rng, model)).result(timeout=30)
        text = svc.metrics.render_text()
    assert "photon_serving_queue_depth " in text
    assert "photon_serving_queue_depth_peak 1" in text
    for stage in STAGES:
        assert f'photon_serving_stage_seconds_total{{stage="{stage}"}}' \
            in text
    assert "photon_serving_slo_requests_in_window 1" in text
    assert "photon_serving_slo_budget_burn_rate 0" in text
    assert 'photon_serving_slo_latency_ms{quantile="p99"}' in text


# -- HTTP: /slo endpoint + opt-in attribution -------------------------------


def _serve(svc):
    server = make_http_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_http_slo_endpoint_and_trace_flag(rng):
    model = _tiny_model(rng)
    svc = _service(model, max_batch=4, max_wait_ms=1.0)
    server, port = _serve(svc)
    try:
        def post(extra):
            body = json.dumps({"requests": [{
                "features": {
                    "global": [0.1] * model.models["fixed"].dim,
                    "re_userId": [0.2] * model.models["per-user"].dim},
                "entity_ids": {"userId": 3}, "uid": "r1"}], **extra})
            return json.loads(urllib.request.urlopen(
                urllib.request.Request(
                    f"http://127.0.0.1:{port}/score",
                    data=body.encode()), timeout=30).read())

        assert "attribution" not in post({})  # strictly opt-in
        attr = post({"trace": True})["attribution"][0]
        assert attr["request_id"] > 0
        stages = (attr["queue_wait_ms"] + attr["assemble_ms"]
                  + attr["device_score_ms"] + attr["respond_ms"])
        assert stages == pytest.approx(attr["total_ms"], rel=0.10)
        slo = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/slo", timeout=30).read())
        assert slo["requests_in_window"] == 2
        assert slo["bad_in_window"] == 0
        assert slo["p99_ms"] > 0
        assert slo["lifetime"]["rows_total"] == 2
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_http_503_body_reports_queue_depth(rng):
    model = _tiny_model(rng)
    # A lone queued request SITS in the queue waiting for batch-mates,
    # occupying the max_queue=1 budget when the HTTP request arrives.
    svc = _service(model, max_batch=2, max_queue=1, max_wait_ms=2000.0)
    server, port = _serve(svc)
    body = json.dumps({"requests": [{
        "features": {"global": [0.0] * model.models["fixed"].dim,
                     "re_userId": [0.0] * model.models["per-user"].dim},
        "entity_ids": {"userId": 1}}]}).encode()
    try:
        pending = svc.submit(ScoringRequest(
            features={"global": np.zeros(6, np.float32),
                      "re_userId": np.zeros(4, np.float32)},
            entity_ids={"userId": 0}))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/score", data=body), timeout=30)
        assert ei.value.code == 503
        payload = json.loads(ei.value.read())
        assert payload["queue_depth"] == 1
        assert payload["max_queue"] == 1
        assert "shedding load" in payload["error"]
        assert svc.metrics.shed_total == 1
        pending.result(timeout=30)  # flushes once the window closes
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


# -- the serve CLI's observability dumps ------------------------------------


def test_serve_cli_trace_and_metrics_dump(rng, tmp_path):
    """--trace-out/--metrics-dump: the dump path runs in run()'s finally;
    here the helper is driven directly against a traced, served request
    (the same code a crashed server runs), and /metrics carries the
    registry's lines."""
    from photon_ml_torch.cli import obs as obs_cli
    from photon_ml_torch.cli import serve
    from photon_ml_torch.models import io as model_io

    model_dir = str(tmp_path / "model")
    model_io.save_game_model(_tiny_model(rng), model_dir)
    args = serve.build_parser().parse_args([
        "--model-dir", model_dir, "--port", "0", "--device", "cpu",
        "--max-batch", "4", "--max-wait-ms", "1.0",
        "--slo-window-s", "30", "--slo-availability", "0.99",
        "--trace-out", str(tmp_path / "serve-trace.json"),
        "--metrics-dump", str(tmp_path / "serve-metrics.prom"),
    ])
    obs.enable(trace=True, metrics=True)
    try:
        server, svc = serve.create_server(args)
        try:
            assert svc.metrics.slo.window_s == 30.0
            assert svc.metrics.slo.availability_objective == 0.99
            svc.submit(_request(rng, model_io.load_game_model(
                model_dir, device="cpu"))).result(timeout=30)
            text = svc.metrics_text()
        finally:
            server.server_close()
            svc.close()
            serve._dump_observability(svc, args.trace_out,
                                      args.metrics_dump)
    finally:
        obs.disable()
    assert 'photon_boot_seconds{phase="total"}' in text
    trace = obs_cli.load_trace(args.trace_out)
    assert verify_trace(trace) == []
    names = {e["name"] for e in _spans(trace)}
    assert {"serving.request", "serving.flush", "serving.boot",
            "boot.map", "boot.compile"} <= names
    parsed = obs.parse_prometheus_text(
        (tmp_path / "serve-metrics.prom").read_text())
    assert parsed.get("photon_serving_rows_total") == 1.0
    assert "photon_serving_slo_budget_burn_rate" in parsed
    assert parsed['photon_boot_seconds{phase="total"}'] > 0
    assert obs_cli.main(["summarize", "--serving", args.trace_out]) == 0
