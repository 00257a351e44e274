"""The port's span tracing, metrics registry, event bridge and transfer
accounting, against themselves and the reference.

Carries over ``tests/test_obs.py`` against ``photon_ml_torch.obs``: the
tracer (nesting, exceptions, raw pairs, thread and spawn propagation,
``record_complete``), the registry, the bridge (with the port's events:
the Training and StreamStage pairs, CheckpointRecovered and
WatchdogAlert), the streamed transfer accounting, the estimator's
``trace=`` and the CLI's summarize/verify. Then, against the JAX package
in the same process: one streamed pass moves the same bytes and chunks
in both, an identically filled registry renders byte-equal Prometheus
text, and a fit with observability off gives the bits of the same fit
with it on.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from photon_ml_torch import obs
from photon_ml_torch.cli import obs as obs_cli
from photon_ml_torch.utils import events as ev_mod
from photon_ml_torch.utils import workers as wk

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(autouse=True)
def _obs_off_after():
    """Observability is process-global state; never leak it into other
    tests."""
    yield
    obs.disable()
    obs.set_ledger(None)
    obs.set_watchdog(None)


def _spans(trace, name=None):
    out = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    return out if name is None else [e for e in out if e["name"] == name]


# ---------------------------------------------------------------- tracer


def test_span_nesting_and_chrome_export():
    t = obs.Tracer()
    with t.span("root", cat="test", a=1):
        with t.span("child") as child:
            time.sleep(0.002)
        assert child.dur is not None and child.dur > 0
    trace = t.chrome_trace()
    spans = {e["name"]: e for e in _spans(trace)}
    assert spans["child"]["args"]["parent_id"] == \
        spans["root"]["args"]["span_id"]
    assert spans["root"]["args"]["a"] == 1
    assert trace["otherData"]["open_spans"] == 0
    # Chrome geometry: child interval inside parent interval.
    c, r = spans["child"], spans["root"]
    assert c["ts"] >= r["ts"] - 500 and \
        c["ts"] + c["dur"] <= r["ts"] + r["dur"] + 500


def test_span_exception_path_closes_and_tags():
    t = obs.Tracer()
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("x")
    [e] = _spans(t.chrome_trace())
    assert e["args"]["error"] == "RuntimeError"
    assert t.open_spans() == 0


def test_raw_start_end_pair_and_unfinished_export():
    t = obs.Tracer()
    sp = t.start("bridge-style")
    assert t.open_spans() == 1
    # An unfinished span exports flagged, not hidden.
    assert _spans(t.chrome_trace())[0]["args"]["unfinished"] is True
    sp.end(extra=1)
    sp.end()  # idempotent
    assert t.open_spans() == 0


def test_thread_pool_propagates_span_context():
    obs.enable(metrics=False)
    t = obs.tracer()
    got = {}

    def task():
        with obs.span("inner") as sp:
            got["parent"] = sp.parent_id

    with t.span("outer") as outer:
        pool = wk.make_pool("thread", 2, {})
        try:
            pool.submit(task).result()
        finally:
            pool.shutdown()
    assert got["parent"] == outer.span_id


def test_spawn_worker_spans_spill_and_reparent(tmp_path):
    spill = str(tmp_path / "spans.jsonl")
    obs.enable(spill=spill)
    t = obs.tracer()
    with t.span("main.submit") as outer:
        ctx = obs.worker_context()
        assert ctx == {"spill": spill, "parent": outer.span_id}
        # The spawn-pool worker's side of make_pool/init_worker, run in
        # a REAL fresh interpreter (the pickling-free equivalent of one
        # pool worker executing one task).
        code = (
            "import sys\n"
            "from photon_ml_torch.utils import workers\n"
            "from photon_ml_torch import obs\n"
            "workers.init_worker({'obs_trace': "
            "{'spill': sys.argv[1], 'parent': sys.argv[2]}})\n"
            "with obs.span('worker.task', cat='stage'):\n"
            "    pass\n")
        env = dict(os.environ, PYTHONPATH=REPO)
        subprocess.run([sys.executable, "-c", code, spill,
                        outer.span_id], cwd=REPO, env=env, check=True)
    worker = [e for e in t.chrome_trace()["traceEvents"]
              if e.get("name") == "worker.task"]
    assert len(worker) == 1
    assert worker[0]["args"]["parent_id"] == outer.span_id
    assert worker[0]["pid"] != os.getpid()
    # Rebased onto the main process's clock: lands inside its run.
    assert worker[0]["ts"] >= 0


def test_record_complete_manual_span_exports_and_parents():
    t = obs.Tracer()
    with t.span("flush", cat="serving") as fl:
        parent_id = fl.span_id
    base = time.time_ns()
    rid = t.record_complete("serving.request", cat="serving",
                            t0_epoch_ns=base, dur_s=0.02,
                            parent=parent_id, crosses_queue=True,
                            request_id=7)
    t.record_complete("serving.queue_wait", cat="serving",
                      t0_epoch_ns=base, dur_s=0.01, parent=rid)
    assert t.open_spans() == 0  # born closed, never live
    spans = {e["name"]: e for e in _spans(t.chrome_trace())}
    req = spans["serving.request"]
    assert req["args"]["parent_id"] == parent_id
    assert req["args"]["request_id"] == 7
    assert req["dur"] == pytest.approx(20000.0)  # us
    assert spans["serving.queue_wait"]["args"]["parent_id"] == \
        req["args"]["span_id"]


def test_record_complete_does_not_disturb_contextvar_nesting():
    t = obs.Tracer()
    with t.span("outer") as outer:
        t.record_complete("manual", t0_epoch_ns=time.time_ns(),
                          dur_s=0.001)
        with t.span("inner") as inner:
            assert inner.parent_id == outer.span_id  # not "manual"


def test_deferred_records_join_the_export_once():
    """Tracer.defer: the recording runs when the trace is exported (once),
    with the parent and thread captured when it was deferred."""
    t = obs.Tracer()
    with t.span("flush") as fl:
        t.defer(lambda parent: t.record_complete(
            "late", t0_epoch_ns=time.time_ns(), dur_s=0.001, parent=parent,
            tid=7), fl.span_id)
    assert [e["name"] for e in _spans(t.chrome_trace())] == \
        ["flush", "late"]
    late = _spans(t.chrome_trace(), "late")
    assert len(late) == 1 and late[0]["tid"] == 7
    assert late[0]["args"]["parent_id"] == fl.span_id


# --------------------------------------------------------------- metrics


def test_metrics_registry_render_parse_roundtrip():
    m = obs.MetricsRegistry()
    m.counter("photon_transfer_bytes_total", kind="stream").inc(4096)
    m.counter("photon_transfer_bytes_total", kind="pin").inc(100)
    g = m.gauge("photon_stream_inflight_chunks")
    g.inc(); g.inc(); g.inc(); g.dec()
    m.histogram("photon_coordinate_update_seconds").observe(0.25)
    parsed = obs.parse_prometheus_text(m.render_text())
    assert parsed['photon_transfer_bytes_total{kind="stream"}'] == 4096
    # metric_value sums a labeled family.
    assert obs.metric_value(parsed, "photon_transfer_bytes_total") == 4196
    assert parsed["photon_stream_inflight_chunks"] == 2
    assert parsed["photon_stream_inflight_chunks_peak"] == 3
    assert parsed["photon_coordinate_update_seconds_count"] == 1


def test_counter_rejects_negative_and_type_conflicts():
    m = obs.MetricsRegistry()
    with pytest.raises(ValueError):
        m.counter("c").inc(-1)
    m.counter("x")
    with pytest.raises(TypeError):
        m.gauge("x")


def test_histogram_is_servings_latency_reservoir():
    from photon_ml_torch.serving.metrics import LatencyHistogram

    assert LatencyHistogram is obs.Histogram
    h = LatencyHistogram(size=16)
    for v in (0.01, 0.02, 0.03):
        h.record(v)
    s = h.summary()
    assert s["count"] == 3 and s["p50_ms"] == pytest.approx(20.0)


def _fill(m):
    """One registry filling, applied to either package's registry."""
    m.counter("photon_transfer_bytes_total", kind="stream",
              dtype="int8").inc(335888)
    m.counter("photon_transfer_seconds_total", kind="stream",
              dtype="int8").inc(0.0123456789012)
    m.counter("photon_checkpoint_writes_total", kind="descent").inc(3)
    g = m.gauge("photon_stream_inflight_chunks")
    for _ in range(3):
        g.inc()
    g.dec(2)
    h = m.histogram("photon_coordinate_update_seconds")
    for v in (0.5, 0.125, 1.0 / 3.0, 7.0):
        h.observe(v)
    m.counter("photon_re_entities_refit_total", re_type="userId").inc(12)


def test_prometheus_text_is_byte_equal_to_the_reference():
    from photon_ml_tpu.obs.metrics import MetricsRegistry as RefRegistry
    from photon_ml_tpu.obs.metrics import \
        parse_prometheus_text as ref_parse

    port, ref = obs.MetricsRegistry(), RefRegistry()
    _fill(port)
    _fill(ref)
    assert port.render_text() == ref.render_text()
    assert port.snapshot() == ref.snapshot()
    text = port.render_text()
    assert obs.parse_prometheus_text(text) == ref_parse(text)


# ---------------------------------------------------------------- bridge


def test_bridge_turns_event_pairs_into_spans_and_counters():
    t, m = obs.enable()
    em = ev_mod.default_emitter
    em.emit(ev_mod.TrainingStart(task="LOGISTIC_REGRESSION",
                                 update_sequence=("fixed",),
                                 iterations=1))
    em.emit(ev_mod.StreamStageStart(shard_id="global", num_rows=10,
                                    chunk_rows=4, num_chunks=3, workers=1))
    em.emit(ev_mod.StreamStageFinish(shard_id="global", num_chunks=3,
                                     seconds=0.1))
    em.emit(ev_mod.CheckpointRecovered(directory="d", done_steps=1,
                                       reason="crc"))
    em.emit(ev_mod.WatchdogAlert(kind="stall", action="warn",
                                 detail="flat"))
    em.emit(ev_mod.TrainingFinish(task="LOGISTIC_REGRESSION",
                                  total_updates=3))
    trace = t.chrome_trace()
    spans = {e["name"]: e for e in _spans(trace)}
    assert spans["training"]["args"]["total_updates"] == 3
    # Nesting followed the event nesting: staging inside training.
    assert spans["stream_stage"]["args"]["parent_id"] == \
        spans["training"]["args"]["span_id"]
    assert spans["stream_stage"]["args"]["num_chunks"] == 3
    instants = {e["name"] for e in trace["traceEvents"]
                if e.get("ph") == "i"}
    assert {"checkpoint_recovered", "watchdog_alert"} <= instants
    parsed = obs.parse_prometheus_text(m.render_text())
    assert parsed["photon_checkpoint_recoveries_total"] == 1
    assert parsed['photon_watchdog_alerts_total{kind="stall"}'] == 1
    assert obs.installed_bridge().stats() == {
        "bridge_spans_opened": 2, "bridge_spans_closed": 2,
        "bridge_spans_leaked": 0}


def test_bridge_survives_finish_without_start_and_reopen():
    t, _ = obs.enable()
    em = ev_mod.default_emitter
    em.emit(ev_mod.StreamStageFinish(shard_id="g", num_chunks=0,
                                     seconds=0.0))
    for _ in range(2):
        em.emit(ev_mod.StreamStageStart(shard_id="g", num_rows=8,
                                        chunk_rows=4, num_chunks=2,
                                        workers=1))
    em.emit(ev_mod.StreamStageFinish(shard_id="g", num_chunks=2,
                                     seconds=0.1))
    assert obs.installed_bridge().stats()["bridge_spans_leaked"] == 0
    stale = [e for e in _spans(t.chrome_trace())
             if e["args"].get("stale")]
    assert len(stale) == 1  # the reopened scope closed its predecessor


def test_disable_closes_bridged_scopes():
    t, _ = obs.enable()
    ev_mod.default_emitter.emit(ev_mod.TrainingStart(
        task="LOGISTIC_REGRESSION", update_sequence=("fixed",),
        iterations=1))
    obs.disable()
    closed = _spans(t.chrome_trace(), "training")
    assert len(closed) == 1
    assert closed[0]["args"]["closed_at_shutdown"] is True


def test_tracing_off_is_inert():
    """Off = one None check: no tracer, no metrics, no ledger, no span
    objects."""
    assert obs.tracer() is None and obs.metrics() is None
    assert obs.ledger() is None and obs.watchdog_config() is None
    assert isinstance(obs.span("anything"),
                      contextlib.nullcontext().__class__)
    obs.instant("nothing")  # no-op, no error


# ------------------------------------------------- transfer accounting


def _tiny_chunked(n=96, d=64, chunk_rows=16, num_hot=8, dtype="float32"):
    """The same staged chunks in both packages (the reference's
    synthetic rows; staging is bit-identical between them)."""
    from photon_ml_torch.data import sparse
    from photon_ml_torch.data.game_data import from_sparse_batch
    from photon_ml_torch.ops import streaming_sparse as ss
    from photon_ml_tpu.data.game_data import \
        from_sparse_batch as ref_from_sparse_batch
    from photon_ml_tpu.data.sparse import synthetic_sparse
    from photon_ml_tpu.ops import streaming_sparse as ref_ss

    b, _ = synthetic_sparse(n, d, 5, seed=3)
    rds = ref_from_sparse_batch(b)
    t = torch.from_numpy
    ds = from_sparse_batch(sparse.SparseBatch(
        t(np.array(b.indices)), t(np.array(b.values)),
        t(np.array(b.labels)), t(np.array(b.weights)),
        t(np.array(b.offsets)), d))
    out = []
    for mod, data in ((ss, ds), (ref_ss, rds)):
        shard = data.feature_shards["global"]
        out.append((data, mod.build_chunked(
            mod.iter_shard_chunks(shard, data.response, data.weights,
                                  chunk_rows),
            d, chunk_rows, num_hot=num_hot,
            feature_dtype=mod.feature_dtype_name(dtype))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_transfer_bytes_match_analytic_sum_single_pass(dtype):
    """One streamed pass moves EXACTLY the analytic chunk-size sum, the
    stream's own count and the reference's accounting of the same
    chunks: no hidden copies, no dropped chunks."""
    import jax.numpy as jnp

    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops import streaming_sparse as ss
    from photon_ml_tpu import obs as ref_obs
    from photon_ml_tpu.ops import losses as ref_losses
    from photon_ml_tpu.ops import streaming_sparse as ref_ss

    (_, chunked), (_, ref_chunked) = _tiny_chunked(dtype=dtype)
    depth = 2
    stream = ss.ChunkStream(chunked, "cpu", depth)
    vg = ss.make_value_and_gradient(losses.LOGISTIC, chunked, stream=stream)
    _, m = obs.enable(trace=False)
    vg(torch.zeros(chunked.dim))
    parsed = obs.parse_prometheus_text(m.render_text())
    analytic = sum(ss._chunk_nbytes(ch) for ch in chunked.chunks)
    assert obs.metric_value(parsed, "photon_transfer_bytes_total") == \
        analytic == stream.bytes_moved
    assert parsed[f'photon_transfer_bytes_total{{dtype="{dtype}",'
                  f'kind="stream"}}'] == analytic
    assert obs.metric_value(parsed, "photon_transfer_chunks_total") == \
        chunked.num_chunks == stream.chunks_moved
    # Every streamed chunk was released: nothing in flight at rest, and
    # the window never exceeded its design bound.
    assert parsed["photon_stream_inflight_chunks"] == 0
    assert 1 <= parsed["photon_stream_inflight_chunks_peak"] <= depth + 1
    obs.disable()
    # The reference's accounting of the same chunks: equal exactly.
    ref_vg = ref_ss.make_value_and_gradient(ref_losses.LOGISTIC,
                                            ref_chunked,
                                            prefetch_depth=depth)
    _, ref_m = ref_obs.enable(trace=False)
    try:
        float(ref_vg(jnp.zeros((ref_chunked.dim,), jnp.float32))[0])
        ref_parsed = ref_obs.parse_prometheus_text(ref_m.render_text())
    finally:
        ref_obs.disable()
    for name in ("photon_transfer_bytes_total",
                 "photon_transfer_chunks_total"):
        assert obs.metric_value(parsed, name) == \
            ref_obs.metric_value(ref_parsed, name)


def test_streamed_fit_bounds_inflight_and_bytes():
    """A full multi-chunk streamed FIT (L-BFGS passes, probes, scoring)
    keeps the in-flight gauge within the prefetch bound, moves a whole
    number of stream payloads, and traces one stream.pass a pass with
    its chunk transfers inside."""
    from photon_ml_torch.game.coordinates import \
        StreamingSparseFixedEffectCoordinate
    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops import streaming_sparse as ss
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (
        RegularizationContext, RegularizationType)

    [(ds, chunked), _] = _tiny_chunked()
    depth = 2
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=3, tolerance=1e-6),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))
    coord = StreamingSparseFixedEffectCoordinate(
        ds, chunked, "global", losses.LOGISTIC, cfg, prefetch_depth=depth,
        device="cpu")
    t, m = obs.enable()
    model = coord.train_model(np.zeros(ds.num_rows, np.float32))
    coord.score(model)
    parsed = obs.parse_prometheus_text(m.render_text())
    per_pass = sum(ss._chunk_nbytes(ch) for ch in chunked.chunks)
    total = obs.metric_value(parsed, "photon_transfer_bytes_total")
    assert total == coord.stream.bytes_moved and total % per_pass == 0
    passes = sum(coord.stream.passes.values())
    assert total // per_pass == passes >= 3  # initial + probes + score
    assert parsed["photon_stream_inflight_chunks"] == 0
    assert parsed["photon_stream_inflight_chunks_peak"] <= depth + 1
    trace = t.chrome_trace()
    assert obs_cli.verify_trace(trace) == []
    pass_ids = {e["args"]["span_id"] for e in _spans(trace, "stream.pass")}
    assert len(pass_ids) == passes
    transfers = _spans(trace, "stream.chunk_transfer")
    assert len(transfers) == passes * chunked.num_chunks
    assert all(e["args"]["parent_id"] in pass_ids and
               e["args"]["dtype"] == "float32" for e in transfers)
    assert len(_spans(trace, "lbfgs.iteration")) == \
        coord.last_solve["iterations"]


# ------------------------------------------------------- product wiring


def _fixed_estimator(**kw):
    from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                             FixedEffectDataConfiguration)
    from photon_ml_torch.api.estimator import GameEstimator
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.types import TaskType

    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinates={"fixed": CoordinateConfiguration(
            data=FixedEffectDataConfiguration("global"),
            optimization=GLMOptimizationConfiguration())},
        update_sequence=["fixed"], device="cpu", **kw)


def _dense_data(n=128):
    from photon_ml_torch.data import synthetic
    from photon_ml_torch.data.game_data import from_synthetic

    return from_synthetic(synthetic.game_data(
        np.random.default_rng(0), n=n, d_global=5, re_specs={}))


def test_estimator_trace_param_produces_fit_timeline():
    tracer = obs.Tracer()
    results = _fixed_estimator(trace=tracer).fit(_dense_data())
    assert len(results) == 1
    assert obs.tracer() is None  # deactivated after fit
    spans = {e["name"]: e for e in _spans(tracer.chrome_trace())}
    assert {"estimator.fit", "training", "descent.update"} <= set(spans)
    # The bridged training lifecycle nests under the estimator root.
    assert spans["training"]["args"]["parent_id"] == \
        spans["estimator.fit"]["args"]["span_id"]


def test_observability_off_creates_nothing_and_keeps_the_bits(tmp_path):
    """Obs off is inert: a fit creates no tracer, registry or ledger;
    the same fit with all three on gives the same bits."""
    ds = _dense_data(n=256)
    plain = _fixed_estimator().fit(ds)[0].model
    assert obs.tracer() is None and obs.metrics() is None
    assert obs.ledger() is None and obs.installed_bridge() is None
    tracer = obs.Tracer()
    with obs.activated(metrics_obj=obs.MetricsRegistry()):
        traced = _fixed_estimator(
            trace=tracer, ledger_dir=str(tmp_path / "ledger"),
            watchdog=obs.WatchdogConfig()).fit(ds)[0].model
    a = plain.models["fixed"].coefficients.means
    b = traced.models["fixed"].coefficients.means
    assert torch.equal(a, b)
    assert obs.tracer() is None and obs.ledger() is None


def test_summarize_and_verify_cli():
    t = obs.Tracer()
    with t.span("descent", cat="train"):
        with t.span("stream.pass", cat="stream", kind="value_grad"):
            with t.span("stream.chunk_transfer", cat="transfer"):
                time.sleep(0.004)
            time.sleep(0.002)
    trace = t.chrome_trace()
    assert obs_cli.verify_trace(trace) == []
    s = obs_cli.summarize_trace(trace)
    assert s["wall_seconds"] > 0
    assert s["waterfall"][0]["name"] == "descent"
    a = s["attribution"]
    assert 0.0 < a["transfer_fraction_of_stream"] <= 1.0
    assert a["transfer_seconds"] == pytest.approx(0.004, rel=0.9)
    assert a["stream_pass_seconds"] == a["stream_pass_host_seconds"]
    text = obs_cli.render_summary(s)
    assert "transfer" in text and "descent" in text


def test_summarize_reads_device_timed_passes():
    """A card's trace: each transfer and each pass carries its device
    seconds; the attribution divides device by device."""
    t = obs.Tracer()
    with t.span("stream.pass", cat="stream") as sp:
        for i in range(3):
            with t.span("stream.chunk_transfer", cat="transfer", index=i,
                        bytes=10, dtype="int8") as cp:
                cp.set(device_seconds=0.001)
    sp.set(device_seconds=0.004)
    a = obs_cli.summarize_trace(t.chrome_trace())["attribution"]
    assert a["stream_pass_seconds"] == pytest.approx(0.004)
    assert a["transfer_seconds"] == pytest.approx(0.003)
    assert a["transfer_fraction_of_stream"] == pytest.approx(0.75)
    assert a["transfer_by_dtype"]["int8"]["chunks"] == 3
    assert a["transfer_by_dtype"]["int8"]["seconds"] == pytest.approx(0.003)


class _CompletedEvent:
    """A CUDA event's stand-in that has completed at ``ms`` on the card's
    clock."""

    def __init__(self, ms: float):
        self.ms = ms

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_CompletedEvent") -> float:
        return end.ms - self.ms


def test_device_timed_copies_nest_in_their_pass():
    """The host enqueues a pass's copies and closes the pass long before
    the card has run them (50 ms of copies after a pass of microseconds
    on the host): flush_timings sets each copy's device seconds on its
    span, which times the enqueue and so nests in the pass; the metrics
    and the attribution count the device seconds. A copy span stamped at
    its enqueue with its device duration ended after its pass, which
    cli/obs verify flags."""
    from photon_ml_torch.ops import streaming_sparse as ss

    t, mx = obs.Tracer(), obs.MetricsRegistry()
    st = object.__new__(ss.ChunkStream)  # the stream's timing state only
    st._timed_copies = collections.deque()
    st._timed_passes = collections.deque()
    with t.span("stream.pass", cat="stream") as sp:
        for i in range(2):
            with t.span("stream.chunk_transfer", cat="transfer", index=i,
                        bytes=8, dtype="int8") as cp:
                pass
            st._timed_copies.append((mx, cp, "int8", _CompletedEvent(
                30.0 * i), _CompletedEvent(30.0 * i + 25.0)))
    st._timed_passes.append((sp, _CompletedEvent(0.0),
                             _CompletedEvent(60.0)))
    st.flush_timings()
    trace = t.chrome_trace()
    assert obs_cli.verify_trace(trace) == []
    copies = [e for e in trace["traceEvents"]
              if e["name"] == "stream.chunk_transfer"]
    assert [e["args"]["device_seconds"] for e in copies] == \
        pytest.approx([0.025, 0.025])
    a = obs_cli.summarize_trace(trace)["attribution"]
    assert a["transfer_seconds"] == pytest.approx(0.05)
    assert a["transfer_fraction_of_stream"] == pytest.approx(0.05 / 0.06)
    parsed = obs.parse_prometheus_text(mx.render_text())
    assert parsed['photon_transfer_seconds_total{dtype="int8",'
                  'kind="stream"}'] == pytest.approx(0.05)


def test_verify_flags_unfinished_and_orphan_spans():
    t = obs.Tracer()
    t.start("leaky")  # never ended
    problems = obs_cli.verify_trace(t.chrome_trace())
    assert any("never closed" in p for p in problems)
    assert any("still open" in p for p in problems)
    trace = {"traceEvents": [
        {"name": "x", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 1,
         "tid": 1, "args": {"span_id": "a", "parent_id": "ghost"}}]}
    assert any("not in trace" in p for p in obs_cli.verify_trace(trace))


def test_verify_exempts_queue_crossing_spans_at_head_only():
    def ev(name, sid, ts, dur, parent=None, **args):
        a = {"span_id": sid, **args}
        if parent:
            a["parent_id"] = parent
        return {"name": name, "ph": "X", "ts": ts, "dur": dur,
                "pid": 1, "tid": 1, "args": a}

    flush = ev("serving.flush", "f", 5000.0, 4000.0)
    crossing = ev("serving.request", "r", 0.0, 8000.0, parent="f",
                  crosses_queue=True)
    assert obs_cli.verify_trace({"traceEvents": [flush, crossing]}) == []
    plain = ev("serving.request", "r", 0.0, 8000.0, parent="f")
    assert any("not contained" in p for p in obs_cli.verify_trace(
        {"traceEvents": [flush, plain]}))
    overhang = ev("serving.request", "r", 0.0, 20000.0, parent="f",
                  crosses_queue=True)
    assert any("not contained" in p for p in obs_cli.verify_trace(
        {"traceEvents": [flush, overhang]}))


def test_obs_cli_main_json(tmp_path, capsys):
    t = obs.Tracer()
    with t.span("root"):
        pass
    path = str(tmp_path / "trace.json")
    t.dump(path)
    assert obs_cli.main(["verify", path]) == 0
    assert obs_cli.main(["summarize", path, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert "attribution" in summary
    assert obs_cli.main(["verify", str(tmp_path / "missing.json")]) == 2


def test_serving_metrics_endpoint_appends_registry():
    from photon_ml_torch.serving.metrics import ServingMetrics
    from photon_ml_torch.serving.service import ScoringService

    _, m = obs.enable(trace=False)
    m.counter("photon_checkpoint_writes_total", kind="descent").inc()
    svc = object.__new__(ScoringService)
    svc.metrics = ServingMetrics()
    text = ScoringService.metrics_text(svc)
    assert "photon_serving_rows_total" in text
    assert 'photon_checkpoint_writes_total{kind="descent"} 1' in text
