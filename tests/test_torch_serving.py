"""The port's serving path against photon_ml_tpu's, on one model directory.

Both ScoringServices load the same files and score the same requests:
dense and sparse features, unseen ids (beyond the table, negative,
missing, unknown keys), vocabulary keys and offsets. The port runs on the
CPU here, where the serving_score wrapper takes its plain version. Scores
agree to rtol 1e-5 / atol 1e-6 for f32 and for int8 caches (whose codes
are quantised on the host by the same function, so they are identical).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.cli import serve as tserve
from photon_ml_torch.models import io as tio
from photon_ml_torch.serving import (BatcherDied, BatcherQueueFull,
                                     DeadlineExceeded, HashShardedStore,
                                     MicroBatcher, ScoringRequest,
                                     ScoringService, bucket_batch,
                                     make_http_server,
                                     requests_from_dataset)
from photon_ml_torch.serving.model_store import quantize_rows_int8
from photon_ml_tpu.game.models import (FixedEffectModel, GameModel,
                                       RandomEffectModel,
                                       SubspaceRandomEffectModel,
                                       sort_subspace_rows)
from photon_ml_tpu.models import io as jio
from photon_ml_tpu.models.coefficients import Coefficients
from photon_ml_tpu.ops.streaming_sparse import \
    quantize_rows_int8 as ref_quantize
from photon_ml_tpu.serving import ScoringRequest as JRequest
from photon_ml_tpu.serving import ScoringService as JService
from photon_ml_tpu.types import TaskType

D_GLOBAL, D_RE, E = 6, 4, 12
TOL = dict(rtol=1e-5, atol=1e-6)
VOCABS = {"userId": {"alice": 5, "carol": 0}}


def _reference_model(rng, task=TaskType.LOGISTIC_REGRESSION):
    """Fixed effect + dense per-user RE + subspace per-item RE."""
    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    cols = np.stack([rng.choice(D_RE, 3, replace=False)
                     for _ in range(E)]).astype(np.int32)
    cols[2, -1] = -1
    cols_s, _, means_s = sort_subspace_rows(cols, f32(E, 3))
    return GameModel(task=task, models={
        "fixed": FixedEffectModel("global", Coefficients(
            jnp.asarray(f32(D_GLOBAL)))),
        "per-user": RandomEffectModel("userId", "re_userId",
                                      jnp.asarray(f32(E, D_RE))),
        "per-item": SubspaceRandomEffectModel(
            "itemId", "re_itemId", D_RE, jnp.asarray(cols_s),
            jnp.asarray(means_s)),
    })


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch-serving") / "model")
    jio.save_game_model(_reference_model(np.random.default_rng(21)), path)
    return path


def _request_dicts(rng, n=45):
    """One request list in plain Python/numpy form, for both packages."""
    out = []
    for i in range(n):
        feats = {"global": rng.normal(size=D_GLOBAL).astype(np.float32)}
        if i % 3 == 0:  # sparse form: ELL row with out-of-range padding
            idx = np.array([0, 2, D_RE, -1], np.int64)
            feats["re_userId"] = {"indices": idx, "values":
                                  rng.normal(size=4).astype(np.float32)}
        else:
            feats["re_userId"] = rng.normal(size=D_RE).astype(np.float32)
        if i % 4 != 1:  # some rows omit the item shard
            feats["re_itemId"] = rng.normal(size=D_RE).astype(np.float32)
        user = [int(rng.integers(0, E)), E + 3, -1, None, "alice", "bob",
                "carol"][i % 7]
        ids = {"itemId": int(rng.integers(0, E + 2))}
        if user is not None:
            ids["userId"] = user
        out.append({"features": feats, "entity_ids": ids,
                    "offset": float(rng.normal()), "uid": i})
    return out


def _port_requests(dicts):
    return [ScoringRequest(**d) for d in dicts]


def _ref_requests(dicts):
    return [JRequest(**d) for d in dicts]


def _both(model_dir, dicts, **kw):
    """Scores of the reference and the port service, same arguments."""
    with JService(jio.load_game_model(model_dir, host=True, mapped=False),
                  entity_vocabs=VOCABS, **kw) as ref:
        want = ref.score(_ref_requests(dicts))
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        entity_vocabs=VOCABS, **kw) as svc:
        got = svc.score(_port_requests(dicts))
        snap = svc.metrics.snapshot()
    return got, want, snap


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_scores_match_reference_service(model_dir, cache_dtype):
    dicts = _request_dicts(np.random.default_rng(1))
    got, want, snap = _both(model_dir, dicts, max_batch=8,
                            cache_entities=64, cache_dtype=cache_dtype)
    np.testing.assert_allclose(got, want, **TOL)
    users = snap["re_cache"]["per-user"]
    assert users["unseen"] > 0 and users["hits"] > 0


def test_as_mean_matches_reference_service(model_dir):
    dicts = _request_dicts(np.random.default_rng(2), n=20)
    got, want, _ = _both(model_dir, dicts, max_batch=16, as_mean=True)
    assert got.min() > 0.0 and got.max() < 1.0
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_cache_codes_equal_reference(model_dir):
    """Host quantisation: the device cache holds the reference's codes
    and scales byte for byte, and the fallback row stays exactly zero
    though every padded fill writes it."""
    dicts = _request_dicts(np.random.default_rng(3), n=30)
    kw = dict(max_batch=4, cache_entities=8, cache_dtype="int8")
    with JService(jio.load_game_model(model_dir, host=True, mapped=False),
                  entity_vocabs=VOCABS, **kw) as ref:
        ref.score(_ref_requests(dicts))
        ref_tables = {st.cid: (np.asarray(st.cache),
                               np.asarray(st.cache_scale))
                      for st in ref.store.random}
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        entity_vocabs=VOCABS, **kw) as svc:
        svc.score(_port_requests(dicts))
        for st in svc.store.random:
            codes, scale = ref_tables[st.cid]
            assert st.cache.dtype == torch.int8
            np.testing.assert_array_equal(st.cache.numpy(), codes)
            np.testing.assert_array_equal(st.cache_scale.numpy(), scale)
            assert np.all(st.cache[st.fallback_slot].numpy() == 0)
            assert st.cache_scale[st.fallback_slot].item() == 0.0


def test_f32_fallback_row_stays_zero(model_dir):
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        max_batch=4, cache_entities=4) as svc:
        svc.score(_port_requests(_request_dicts(np.random.default_rng(4),
                                                n=24)))
        for st in svc.store.random:
            assert st.cache.dtype == torch.float32
            assert torch.count_nonzero(st.cache[st.fallback_slot]) == 0
            assert st.cache_scale is None


def test_quantize_rows_int8_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 7)).astype(np.float32) * 3
    x[3] = 0.0
    x[5, 2] = 1e-30
    q, s = quantize_rows_int8(x)
    rq, rs = ref_quantize(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)


def test_bucket_invariance_across_batch_compositions(model_dir):
    dicts = _request_dicts(np.random.default_rng(6), n=53)
    requests = _port_requests(dicts)
    _, want, _ = _both(model_dir, dicts, max_batch=16, cache_entities=64)
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        max_batch=16, cache_entities=64,
                        entity_vocabs=VOCABS) as svc:
        whole = svc.score(requests)
        one_by_one = np.concatenate([svc.score([r]) for r in requests])
        ragged, i = [], 0
        for size in (1, 2, 3, 5, 7, 11, 16, 8):  # every bucket shape
            ragged.append(svc.score(requests[i: i + size]))
            i += size
        ragged = np.concatenate(ragged)
        shapes = svc.metrics.snapshot()["compiles_total"]
    np.testing.assert_allclose(whole, want, **TOL)
    np.testing.assert_allclose(one_by_one, whole, **TOL)
    np.testing.assert_allclose(ragged, whole[: ragged.shape[0]], **TOL)
    assert shapes == 5  # buckets 1, 2, 4, 8, 16 and no others


def test_bucket_batch_shapes():
    assert [bucket_batch(n, 16) for n in (1, 2, 3, 4, 5, 9, 16, 99)] \
        == [1, 2, 4, 4, 8, 16, 16, 16]


def test_lru_eviction_tiny_budget(model_dir):
    dicts = _request_dicts(np.random.default_rng(7), n=60)
    got, want, snap = _both(model_dir, dicts, max_batch=2,
                            cache_entities=2)
    np.testing.assert_allclose(got, want, **TOL)
    users = snap["re_cache"]["per-user"]
    assert users["evictions"] > 0
    assert users["misses"] > users["hits"]  # thrashing regime
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        max_batch=2, cache_entities=2) as svc:
        svc.score(_port_requests(dicts))
        assert all(len(st.cached_entities()) <= 2
                   for st in svc.store.random)


def test_hash_sharded_store_fetch_matches_entity_rows(model_dir):
    model = tio.load_game_model(model_dir)
    ids = np.random.default_rng(8).permutation(E)[:9]
    for cid in ("per-user", "per-item"):
        m = model.models[cid]
        store = HashShardedStore(m, num_shards=4)
        np.testing.assert_array_equal(store.fetch(ids), m.entity_rows(ids))
        assert store.dim == D_RE and store.num_entities == E


def test_unknown_shard_and_wrong_width_fail_the_flush(model_dir):
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        max_batch=4) as svc:
        with pytest.raises(ValueError, match="unknown feature shard"):
            svc.score([ScoringRequest({"nope": np.zeros(3)})])
        with pytest.raises(ValueError, match="expected 6 features"):
            svc.score([ScoringRequest({"global": np.zeros(3)})])


# -- HTTP front end and CLI -------------------------------------------------

def _serve_in_thread(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _post(port, body, path="/score"):
    return json.loads(urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode()),
        timeout=30).read())


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=30).read()


def _jsonable(dicts):
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
    return [conv(d) for d in dicts]


def test_http_score_metrics_slo_healthz(model_dir):
    dicts = _request_dicts(np.random.default_rng(9), n=10)
    _, want, _ = _both(model_dir, dicts, max_batch=4)
    svc = ScoringService(tio.load_game_model(model_dir), device="cpu",
                         max_batch=4, max_wait_ms=1.0, entity_vocabs=VOCABS)
    server = make_http_server(svc, port=0)
    port = server.server_address[1]
    t = _serve_in_thread(server)
    try:
        resp = _post(port, {"requests": _jsonable(dicts), "trace": True})
        np.testing.assert_allclose(resp["scores"], want, **TOL)
        assert resp["uids"] == list(range(10))
        attr = resp["attribution"][0]
        stages = sum(attr[k] for k in ("queue_wait_ms", "assemble_ms",
                                       "device_score_ms", "respond_ms"))
        assert stages == pytest.approx(attr["total_ms"], abs=0.01)
        text = _get(port, "/metrics").decode()
        assert "photon_serving_rows_total 10" in text
        assert "photon_serving_re_cache_hit_rate" in text
        slo = json.loads(_get(port, "/slo"))
        assert slo["lifetime"]["rows_total"] == 10
        assert json.loads(_get(port, "/healthz")) == {
            "status": "ok", "model_version": 0, "generation": None}
        for bad in (b"{}", b"not json"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/score", data=bad), timeout=30)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/nope")
        assert ei.value.code == 404
        assert 'photon_serving_http_errors_total{code="400"} 2' in \
            _get(port, "/metrics").decode()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(timeout=10)


def test_attribution_sums_to_total_when_the_flush_waits(model_dir):
    """A flush that waits for the scoring lock (another flush holds it,
    or the GIL goes elsewhere between the flush's start and assembly)
    still attributes every millisecond: the wait is queue_wait, and the
    four stages sum to total_ms up to their 4-decimal rounding."""
    svc = ScoringService(tio.load_game_model(model_dir), device="cpu",
                         max_batch=4, max_wait_ms=1.0, entity_vocabs=VOCABS)
    held, submitted = threading.Event(), threading.Event()

    def hold():  # the lock, until 20 ms after the request is queued
        with svc._lock:
            held.set()
            submitted.wait(timeout=5.0)
            time.sleep(0.02)

    try:
        threading.Thread(target=hold).start()
        held.wait(timeout=5.0)
        fut = svc.submit(_port_requests(_request_dicts(
            np.random.default_rng(4), n=1))[0])
        submitted.set()
        fut.result(timeout=30)
        attr = fut.attribution
    finally:
        svc.close()
    stages = sum(attr[k] for k in ("queue_wait_ms", "assemble_ms",
                                   "device_score_ms", "respond_ms"))
    assert attr["queue_wait_ms"] >= 20.0  # it waited for the lock
    assert stages == pytest.approx(attr["total_ms"], abs=0.01)


def test_metric_names_are_the_references(model_dir):
    """The port's /metrics exposition names only metrics the reference
    exposes too."""
    def names(text):
        return {line.split(" ")[0].split("{")[0]
                for line in text.splitlines() if line}

    dicts = _request_dicts(np.random.default_rng(10), n=6)
    with JService(jio.load_game_model(model_dir, host=True, mapped=False),
                  max_batch=4) as ref:
        ref.score(_ref_requests(dicts))
        want = names(ref.metrics.render_text())
    with ScoringService(tio.load_game_model(model_dir), device="cpu",
                        max_batch=4) as svc:
        svc.score(_port_requests(dicts))
        got = names(svc.metrics_text())
    assert got and got <= want


def test_serve_cli_create_server_on_cpu(model_dir, tmp_path):
    vocab_path = tmp_path / "vocabs.json"
    vocab_path.write_text(json.dumps(VOCABS))
    dicts = _request_dicts(np.random.default_rng(11), n=12)
    _, want, _ = _both(model_dir, dicts, max_batch=8, cache_dtype="int8")
    server, svc = tserve.create_server(tserve.build_parser().parse_args([
        "--model-dir", model_dir, "--port", "0", "--device", "cpu",
        "--max-batch", "8", "--max-wait-ms", "1.0", "--cache-dtype", "int8",
        "--entity-vocabs", str(vocab_path)]))
    port = server.server_address[1]
    t = _serve_in_thread(server)
    try:
        assert svc.device == torch.device("cpu")
        resp = _post(port, {"requests": _jsonable(dicts)})
        np.testing.assert_allclose(resp["scores"], want, **TOL)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(timeout=10)


# -- micro-batcher ----------------------------------------------------------

def test_batcher_flushes_full_batches_and_on_deadline():
    sizes = []
    done = threading.Event()

    def flush(entries):
        sizes.append(len(entries))
        if sum(sizes) >= 9:
            done.set()
        return [float(e.request) for e in entries]

    b = MicroBatcher(flush, max_batch=4, max_wait_ms=30.0)
    try:
        futs = [b.submit(i) for i in range(8)]  # two full flushes
        tail = b.submit(99)  # lone request: must flush on the deadline
        assert tail.result(timeout=5.0) == 99.0
        assert [f.result(timeout=5.0) for f in futs] == [float(i)
                                                         for i in range(8)]
        assert done.wait(timeout=5.0)
    finally:
        b.close()
    assert max(sizes) == 4 and sizes[-1] == 1


def test_batcher_propagates_flush_errors():
    def flush(entries):
        raise RuntimeError("boom")

    b = MicroBatcher(flush, max_batch=2, max_wait_ms=1.0)
    try:
        fut = b.submit(1)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=5.0)
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(2)


def test_batcher_sheds_when_full_and_expires_deadlines():
    gate = threading.Event()
    expired = []

    def flush(entries):
        gate.wait(timeout=10.0)
        return [0.0] * len(entries)

    b = MicroBatcher(flush, max_batch=1, max_wait_ms=0.0, max_queue=2,
                     on_deadline=expired.append)
    try:
        first = b.submit("a")  # taken by the worker, which blocks
        deadline = time.monotonic() + 5.0
        while b._inflight == [] and time.monotonic() < deadline:
            time.sleep(0.005)
        short = b.submit("b", deadline_s=0.01)
        b.submit("c")
        with pytest.raises(BatcherQueueFull) as ei:
            b.submit("d")
        assert ei.value.depth == 2 and ei.value.max_queue == 2
        time.sleep(0.05)  # "b" expires while the worker is blocked
        gate.set()
        assert first.result(timeout=5.0) == 0.0
        with pytest.raises(DeadlineExceeded):
            short.result(timeout=5.0)
    finally:
        gate.set()
        b.close()
    assert expired == [1] and b.expired == 1


def test_batcher_worker_death_fails_fast_and_restarts():
    deaths = []

    class Death(BaseException):
        pass

    calls = []

    def flush(entries):
        calls.append(len(entries))
        if len(calls) == 1:
            raise Death("worker killed")
        return [1.0] * len(entries)

    b = MicroBatcher(flush, max_batch=4, max_wait_ms=1.0,
                     on_worker_death=deaths.append)
    try:
        with pytest.raises(BatcherDied):
            b.submit(1).result(timeout=5.0)
        assert b.submit(2).result(timeout=5.0) == 1.0
    finally:
        b.close()
    assert b.restarts == 1 and len(deaths) == 1


def test_service_sheds_and_counts(model_dir):
    svc = ScoringService(tio.load_game_model(model_dir), device="cpu",
                         max_batch=1, max_queue=1, max_wait_ms=0.0)
    gate = threading.Event()
    real = svc._score_chunk

    def slow(requests):
        gate.wait(timeout=10.0)
        return real(requests)

    svc._score_chunk = slow
    req = ScoringRequest({"global": np.zeros(D_GLOBAL, np.float32)})
    try:
        first = svc.submit(req)
        deadline = time.monotonic() + 5.0
        while svc.batcher._inflight == [] and time.monotonic() < deadline:
            time.sleep(0.005)
        second = svc.submit(req)
        with pytest.raises(BatcherQueueFull):
            svc.submit(req)
        gate.set()
        assert first.result(timeout=5.0) == second.result(timeout=5.0)
        assert svc.metrics.snapshot()["shed_total"] == 1
        assert svc.slo_snapshot()["bad_by_kind"] == {"shed": 1}
    finally:
        gate.set()
        svc.close()


# -- the whole slice ---------------------------------------------------------

def test_movielens_shaped_toy_through_both_services(tmp_path):
    """One seed: MovieLens-shaped synthetic rows and a user/item GAME
    model, written by the reference, served by both services."""
    from photon_ml_torch.data import game_data as tgd
    from photon_ml_torch.data import synthetic as tsyn

    specs = {"userId": (40, 4), "itemId": (25, 4)}
    data = tgd.from_synthetic(tsyn.game_data(np.random.default_rng(12),
                                             n=96, d_global=8,
                                             re_specs=specs))
    data.entity_ids["userId"][::17] = 40 + 2  # unseen users
    rng = np.random.default_rng(13)
    ref = GameModel(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectModel("global", Coefficients(jnp.asarray(
            rng.normal(size=8).astype(np.float32)))),
        "per-user": RandomEffectModel("userId", "re_userId", jnp.asarray(
            rng.normal(size=(40, 4)).astype(np.float32))),
        "per-item": RandomEffectModel("itemId", "re_itemId", jnp.asarray(
            rng.normal(size=(25, 4)).astype(np.float32))),
    })
    path = str(tmp_path / "model")
    jio.save_game_model(ref, path)
    reqs = requests_from_dataset(data)
    dicts = [dict(features=r.features, entity_ids=r.entity_ids,
                  offset=r.offset, uid=r.uid) for r in reqs]
    for as_mean in (False, True):
        got, want, snap = _both(path, dicts, max_batch=32,
                                cache_entities=16, as_mean=as_mean)
        np.testing.assert_allclose(got, want, **TOL)
        assert snap["rows_total"] == 96
    port_model = tio.load_game_model(path)
    np.testing.assert_allclose(
        _both(path, dicts, max_batch=32)[0],
        port_model.score(data).numpy(), **TOL)
