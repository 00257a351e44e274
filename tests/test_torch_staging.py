"""The port's staging pipeline (``game/staging.py``) against the reference.

- ``ProjectionStager`` produces, shard for shard, the bytes of the serial
  build (the projector's whole-bucket functions, cut at the plan's lane
  slices) and of the reference's stager: thread mode with 1 and 3
  workers and process mode with 2 workers, on a dense shard with
  normalization and the Pearson cap and on a sparse (ELL) shard.
- The degradation ladder: a ``_phase_b`` that fails once is retried, one
  that stalls past the straggler deadline is re-staged serially; both
  give the same bytes and emit their events.
- The staging events, field for field the reference's, and what the obs
  bridge makes of them (the ``staging`` span, the shard counter).
- ``plan_shards``, ``split_shard_triplets``, ``project_buckets`` and the
  ``StagingConfig`` checks equal the reference's.
- Under thread stress (more workers than cores, a short switch
  interval) the stager still gives the serial bytes, in bounded time.
"""

import threading
import time

import numpy as np
import pytest

from photon_ml_torch import obs
from photon_ml_torch.data.game_data import SparseShard
from photon_ml_torch.game import buckets, projector, staging
from photon_ml_torch.utils import events
from photon_ml_tpu.data.game_data import SparseShard as RefSparseShard
from photon_ml_tpu.game import buckets as ref_buckets
from photon_ml_tpu.game import staging as ref_staging
from photon_ml_tpu.utils import events as ref_events

N, E, D, K = 900, 64, 40, 5
SHARD = 16  # lanes per shard: several shards a bucket


def _data(kind: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = ((rng.pareto(1.2, N) * 4).astype(np.int64) % E).astype(np.int32)
    y = (rng.random(N) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    if kind == "dense":
        emask = rng.random((E, D)) < 0.35
        X = (rng.normal(0.5, 2.0, size=(N, D))
             * (rng.random((N, D)) < 0.6) * emask[ids]).astype(np.float32)
        X[:, 0] = 1.0
        f = (1.0 / np.maximum(X.std(0), 1e-3)).astype(np.float32)
        s = X.mean(0).astype(np.float32)
        f[0], s[0] = 1.0, 0.0
        return dict(ids=ids, y=y, w=w, X=X, rX=X.copy(), ii=0, ratio=0.5,
                    f=f, s=s)
    pools = rng.integers(0, D, size=(E, 8))
    idx = np.sort(pools[ids[:, None], rng.integers(0, 8, (N, K))], axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    vals = rng.normal(size=(N, K)).astype(np.float32)
    idx[dup] = D
    vals[dup] = 0.0
    idx = idx.astype(np.int32)
    return dict(ids=ids, y=y, w=w, X=SparseShard(idx, vals, D),
                rX=RefSparseShard(idx.copy(), vals.copy(), D), ii=None,
                ratio=None, f=None, s=None)


def _bucketing(module, ids):
    return module.build_bucketing(ids, E, lower_bound=2, upper_bound=24,
                                  rng=np.random.default_rng(0))


def _stager(module, data, bucketing, config, ref=False, emitter=None,
            **kw):
    return module.ProjectionStager(
        bucketing=bucketing, X=data["rX" if ref else "X"],
        response=data["y"], weights=data["w"], intercept_index=data["ii"],
        features_to_samples_ratio=data["ratio"], factors=data["f"],
        shifts=data["s"], config=config, label="u:re",
        emitter=emitter, **kw)


def _drain(stager):
    out = [tuple(np.asarray(a) for a in t) for t in stager.shards()]
    stager.join()
    return out


def _serial(data, bucketing, plan):
    """The serial build: each whole bucket through the projector, cut at
    the plan's lane slices."""
    whole = []
    for b in bucketing.buckets:
        trip = projector.bucket_triplets(b, data["X"])
        proj = projector.build_bucket_projection(
            b, data["X"], data["ii"], labels=data["y"],
            features_to_samples_ratio=data["ratio"], triplets=trip)
        Xb = projector.gather_projected_features(b, proj, data["X"],
                                                 triplets=trip)
        (yb,) = buckets.gather_bucket_arrays(b, data["y"])
        t = [Xb, yb, buckets.bucket_weights(b, data["w"]),
             b.example_idx.astype(np.int32), b.entity_rows, proj.cols]
        f_p, s_p = projector.project_norm_arrays(proj, data["f"], data["s"])
        t += [a for a in (f_p, s_p) if a is not None]
        whole.append(t)
    return [tuple(a[lo:hi] for a in whole[bi]) for bi, lo, hi in plan]


def _same_shards(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), i
        for j, (a, b) in enumerate(zip(g, w)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (i, j)
            assert a.tobytes() == b.tobytes(), (i, j)


@pytest.mark.parametrize("mode,workers", [("thread", 1), ("thread", 3),
                                          ("process", 2)])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_stager_equals_serial_build_and_reference(kind, mode, workers):
    data = _data(kind)
    bk, rbk = _bucketing(buckets, data["ids"]), _bucketing(ref_buckets,
                                                          data["ids"])
    cfg = staging.StagingConfig(workers=workers, mode=mode,
                                shard_entities=SHARD)
    stager = _stager(staging, data, bk, cfg)
    assert stager.num_shards > len(bk.buckets)
    got = _drain(stager)
    _same_shards(got, _serial(data, bk, stager.plan))
    ref = _stager(ref_staging, data, rbk, ref_staging.StagingConfig(
        workers=2, shard_entities=SHARD), ref=True)
    _same_shards(got, _drain(ref))
    assert stager.fault_stats == {"retries": 0, "serial_restages": 0,
                                  "stragglers": 0, "quarantined": False}
    cols = stager.cols_list()
    assert all(np.array_equal(c, t[5]) for c, t in zip(cols, got))


def _patched_phase_b(monkeypatch, index, action):
    """``staging._phase_b`` doing ``action`` on its first call for shard
    ``index`` and the real work otherwise."""
    real = staging._phase_b
    seen = []
    lock = threading.Lock()

    def phase_b(task, *args):
        with lock:
            first = task.index == index and not seen
            if first:
                seen.append(task.index)
        if first:
            action()
        return real(task, *args)

    monkeypatch.setattr(staging, "_phase_b", phase_b)
    return seen


def test_retry_gives_the_same_bytes(monkeypatch):
    data = _data("sparse")
    bk = _bucketing(buckets, data["ids"])
    want = _drain(_stager(staging, data, bk, staging.StagingConfig(
        workers=2, shard_entities=SHARD)))

    def fail():
        raise RuntimeError("injected")

    seen = _patched_phase_b(monkeypatch, 1, fail)
    em = events.EventEmitter()
    got_events = []
    em.register(got_events.append)
    stager = _stager(staging, data, bk, staging.StagingConfig(
        workers=2, shard_entities=SHARD, retry_backoff_s=0.0), emitter=em)
    _same_shards(_drain(stager), want)
    assert seen == [1]
    assert stager.fault_stats["retries"] == 1
    (retry,) = [e for e in got_events if isinstance(e, events.StagingRetry)]
    assert (retry.label, retry.index, retry.attempt) == ("u:re", 1, 1)
    assert retry.error == "RuntimeError: injected"


def test_straggler_restages_serially_with_the_same_bytes(monkeypatch):
    data = _data("dense")
    bk = _bucketing(buckets, data["ids"])
    want = _drain(_stager(staging, data, bk, staging.StagingConfig(
        workers=2, shard_entities=SHARD)))
    _patched_phase_b(monkeypatch, 2, lambda: time.sleep(1.0))
    em = events.EventEmitter()
    got_events = []
    em.register(got_events.append)
    stager = _stager(staging, data, bk, staging.StagingConfig(
        workers=2, shard_entities=SHARD, straggler_timeout_s=0.2),
        emitter=em)
    _same_shards(_drain(stager), want)
    assert stager.fault_stats["stragglers"] == 1
    assert stager.fault_stats["serial_restages"] == 1
    (late,) = [e for e in got_events
               if isinstance(e, events.StagingStraggler)]
    assert late.index == 2 and late.waited_seconds > 0.2


def test_staging_events_match_the_reference_and_feed_the_bridge():
    data = _data("sparse")
    bk, rbk = _bucketing(buckets, data["ids"]), _bucketing(ref_buckets,
                                                          data["ids"])
    got, want = [], []
    em, rem = events.EventEmitter(), ref_events.EventEmitter()
    em.register(got.append)
    rem.register(want.append)
    cfg = dict(workers=2, shard_entities=SHARD)
    _drain(_stager(staging, data, bk, staging.StagingConfig(**cfg),
                   emitter=em))
    _drain(_stager(ref_staging, data, rbk, ref_staging.StagingConfig(**cfg),
                   ref=True, emitter=rem))

    def fields(e):
        # Seconds are timings, not content.
        return (type(e).__name__,
                {k: v for k, v in vars(e).items() if "seconds" not in k})

    assert sorted(map(str, map(fields, got))) == \
        sorted(map(str, map(fields, want)))
    start = got[0]
    assert isinstance(start, events.StagingStart)
    assert (start.num_shards, start.workers, start.mode,
            start.cached_shards) == (len(got) - 2, 2, "thread", 0)
    assert isinstance(got[-1], events.StagingFinish)

    tracer, metrics = obs.Tracer(), obs.MetricsRegistry()
    with obs.activated(tracer, metrics):
        _drain(_stager(staging, data, bk, staging.StagingConfig(**cfg)))
    spans = [e for e in tracer.chrome_trace()["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "staging"]
    assert len(spans) == 1
    snap = metrics.snapshot()
    assert snap['photon_staging_shards_total{source="staged"}'] == \
        start.num_shards


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_plan_split_and_project_buckets_match_the_reference(kind):
    data = _data(kind)
    bk, rbk = _bucketing(buckets, data["ids"]), _bucketing(ref_buckets,
                                                          data["ids"])
    plan = staging.plan_shards(bk, SHARD)
    assert plan == ref_staging.plan_shards(rbk, SHARD)
    tasks = staging.split_shard_triplets(bk, plan, data["X"],
                                         labels=data["y"])
    rtasks = ref_staging.split_shard_triplets(rbk, plan, data["rX"],
                                              labels=data["y"])
    for t, r in zip(tasks, rtasks):
        for f in ("index", "bucket", "lo", "hi", "y0"):
            assert getattr(t, f) == getattr(r, f)
        for f in ("entity_rows", "example_idx", "counts", "t_cols",
                  "t_vals", "t_lanes", "t_cappos", "t_y", "yb"):
            a, b = getattr(t, f), getattr(r, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    cfg = staging.StagingConfig(workers=3, shard_entities=SHARD)
    got = staging.project_buckets(bk, data["X"], data["ii"], data["y"],
                                  data["ratio"], cfg)
    want = ref_staging.project_buckets(
        rbk, data["rX"], data["ii"], data["y"], data["ratio"],
        ref_staging.StagingConfig(workers=3, shard_entities=SHARD))
    for b, p, r in zip(bk.buckets, got, want):
        assert p.d_active == r.d_active
        assert p.cols.tobytes() == r.cols.tobytes()
        serial = projector.build_bucket_projection(
            b, data["X"], data["ii"], labels=data["y"],
            features_to_samples_ratio=data["ratio"])
        assert p.cols.tobytes() == serial.cols.tobytes()


@pytest.mark.parametrize("kw", [
    {"mode": "fiber"}, {"workers": 0}, {"pipeline_depth": 0},
    {"shard_entities": 0}, {"max_retries": -1}, {"retry_backoff_s": -1.0},
    {"straggler_timeout_s": 0.0}])
def test_staging_config_checks_match_the_reference(kw):
    with pytest.raises(ValueError) as got:
        staging.StagingConfig(**kw)
    with pytest.raises(ValueError) as want:
        ref_staging.StagingConfig(**kw)
    assert str(got.value) == str(want.value)
    cfg = staging.StagingConfig(workers=5)
    assert (cfg.resolved_workers(), cfg.resolved_depth()) == (5, 7)
    assert staging.resolved_shard_entities(cfg, 8) == staging.LANE_CHUNK
    assert staging.resolved_shard_entities(
        staging.StagingConfig(shard_entities=13), 8) == 16


def test_stager_under_thread_stress_gives_the_same_bytes():
    """More workers than cores, one lane group a shard, and a short
    switch interval: the handoff, claims and cache-free scheduling still
    give the serial build's bytes, within a time bound."""
    import os
    import sys

    data = _data("sparse", seed=8)
    bk = _bucketing(buckets, data["ids"])
    cfg = staging.StagingConfig(workers=2 * (os.cpu_count() or 1) + 1,
                                shard_entities=8, pipeline_depth=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        stager = _stager(staging, data, bk, cfg)
        got = []
        t = threading.Thread(target=lambda: got.extend(_drain(stager)))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    _same_shards(got, _serial(data, bk, stager.plan))
