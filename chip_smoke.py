#!/usr/bin/env python3
"""Smoke run of the PyTorch port (photon_ml_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the exit
code is non-zero:

1. device  — requires CUDA; the card's name and power limit (nvidia-smi)
             and the torch/CUDA versions.
2. build   — builds every kernel library from photon_ml_torch/csrc/,
             all nvcc processes at once.
3. kernels — holds serving_score against its plain PyTorch version on
             the card, at the shapes the serving path gives it and at
             the kernel-sweep shape, and times both with CUDA events: on
             the card alone (CUDA-graph replay, "ms") and per call from
             Python ("call_ms").
4. serve   — the serving path: a config-4 (MovieLens-20M width) GAME
             model from a seed, written with save_game_model and served
             through cli.serve.create_server on port 0, answering
             concurrent HTTP clients; every score is checked against a
             float64 numpy oracle. serving_score's launch count and the
             service metrics are read around the HTTP traffic alone; a
             direct pass around HTTP (with a profiled repeat) comes after
             they are read.
5. train   — the training path: config 4 at full width and MovieLens-20M's
             20,000,263 rows from a seed (5% held out), the three
             coordinates built as dev-scripts/flagship_movielens.py
             builds them, and a 2-iteration game.descent.run with the
             validation AUC after each update. The row movers' launch
             counts and the solver's host syncs are read around the
             descent alone and must equal 2 x the bucket waves.
6. kernels — holds re_rows' gather_rows and scatter_rows_ bit for bit
             against their plain versions at every wave shape the train
             phase gave them, on an all-padding wave and at a sweep
             shape, and times kernel, plain version and library call.
7. train_parity — the same descent at 300,000 rows (same widths and
             entity counts) on the card and on the CPU in one process.
             Within 5e-3: the validation AUC after each update and the
             mean validation probability of the two runs; and each
             update of the card's run replayed on the CPU from the same
             offsets and warm start, the fixed effect's coefficients and
             those of every random-effect entity the data determines
             (16+ rows, both labels).

Then it prints the kernel table ({"kernels": [...]}), nvidia-smi's
"name, power.limit" line, and as its last line
{"ok": true, "device": {...}}. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Config 4 at full width (dev-scripts/flagship_movielens.py: MovieLens-20M
# users and movies, d_global = 32, d_re = 8).
D_GLOBAL = 32
D_RE = 8
NUM_USERS = 138_493
NUM_ITEMS = 27_278
ZIPF_SKEW = 1.2
UNSEEN_FRAC = 0.02
SEED = 2026

# Config-4 training (dev-scripts/flagship_movielens.py): MovieLens-20M's
# rating count with 5% held out, L2 weight 1.0, 25 L-BFGS iterations,
# and at most 65,536 active rows per entity (numActiveDataPointsUpperBound).
TRAIN_ROWS = 20_000_263
PARITY_ROWS = 300_000
UPPER_BOUND = 65_536
DESCENT_ITERATIONS = 2
PARITY_TOL = 5e-3
# Random-effect entities with at least this many training rows (and both
# labels) have coefficients the data determines; train_parity holds those.
WELL_DETERMINED_ROWS = 16
SEQ = ["fixed", "per-user", "per-item"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, reps: int = 21, inner: int = 50) -> float:
    """Per-call time of ``inner`` back-to-back calls from Python, median
    over ``reps`` CUDA-event windows (warm): what a caller pays, host
    launch overhead included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_ms(torch, fn, reps: int = 21, inner: int = 100) -> float:
    """Per-call time on the card: ``inner`` calls captured once in a CUDA
    graph and replayed, median over ``reps`` CUDA-event windows. The
    host's launch overhead is out of the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# -- kernels ---------------------------------------------------------------

def _score_inputs(torch, rng, n, d, E, dtype):
    """Inputs at one shape. int8: integer features and power-of-two
    scales, so every partial sum is exact and kernel == plain bit for
    bit. The last row is the fallback row (zeros, scale 0). Slots mix
    in-range rows, the fallback row and out-of-range ids on both sides."""
    import numpy as np

    if dtype == "int8":
        mat = rng.integers(-4, 5, (n, d)).astype(np.float32)
        cache = rng.integers(-127, 128, (E, d)).astype(np.int8)
        scale = (2.0 ** rng.integers(-12, 3, E)).astype(np.float32)
        scale[E - 1] = 0.0
    else:
        mat = rng.normal(size=(n, d)).astype(np.float32)
        cache = rng.normal(size=(E, d)).astype(np.float32)
        scale = None
    cache[E - 1] = 0
    slots = rng.integers(0, E, n).astype(np.int32)
    slots[1::5] = E - 1
    slots[2::7] = E + 3
    slots[3::11] = -2
    dev = torch.device("cuda")
    put = (lambda a: None if a is None else torch.from_numpy(a).to(dev))
    return put(mat), put(slots), put(cache), put(scale)


def check_serving_score(torch, ss, rng, n, d, E, dtype) -> dict:
    mat, slots, cache, scale = _score_inputs(torch, rng, n, d, E, dtype)
    got = ss.score_rows(mat, slots, cache, scale)
    want = ss.score_rows_reference(mat, slots, cache, scale)
    torch.cuda.synchronize()
    s = torch.clamp(slots.long(), 0, E - 1)
    err = float((got - want).abs().max())
    if dtype == "int8":
        if not torch.equal(got, want):
            raise AssertionError(f"serving_score int8 n={n} d={d}: not "
                                 f"bit-exact (max |err| {err})")
    else:
        # A float32 sum's rounding error scales with the sum of its
        # terms' magnitudes, whatever the order of summation.
        mag = (mat * cache[s]).abs().sum(dim=1)
        bad = (got - want).abs() > 1e-5 * mag + 1e-30
        if bool(bad.any()):
            raise AssertionError(f"serving_score f32 n={n} d={d}: error "
                                 f"{err} beyond 1e-5 of sum |terms|")
    if bool((got[s == E - 1] != 0).any()):
        raise AssertionError("fallback-row scores are not exactly 0")
    kernel = (lambda: ss.score_rows(mat, slots, cache, scale))
    plain = (lambda: ss.score_rows_reference(mat, slots, cache, scale))
    # Bytes the call must move: features, each referenced cache row (and
    # its scale) once, slots, outputs. Its 2·n·d flops at the f32 rate.
    uniq = int(torch.unique(s).numel())
    b_cache = 1 if dtype == "int8" else 4
    nbytes = n * d * 4 + uniq * d * b_cache + n * 4 + n * 4 \
        + (uniq * 4 if scale is not None else 0)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * n * d / PEAK_F32_FLOP_PER_S * 1e3
    return {"n": n, "d": d, "E": E, "cache": dtype, "max_abs_err": err,
            "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain),
            "call_ms": call_ms(torch, kernel),
            "plain_call_ms": call_ms(torch, plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def phase_kernels(torch, np) -> list[dict]:
    from photon_ml_torch.ops.kernels import serving_score as ss

    rng = np.random.default_rng(SEED)
    buckets = [2 ** k for k in range(7)]  # 1 … 64, the serving buckets
    # Cache rows (entities + the fallback row) each serve config gives
    # the kernel: a and c a 4096-entity f32 cache; b int8 caches holding
    # the whole userId and itemId tables.
    shapes = [("float32", 4097), ("int8", 4097),
              ("int8", NUM_USERS + 1), ("int8", NUM_ITEMS + 1)]
    rows = [check_serving_score(torch, ss, rng, n, D_RE, E, dtype)
            for dtype, E in shapes for n in buckets]
    for dtype in ("float32", "int8"):
        # The kernel-sweep shape (bench.py's kernel sweep).
        rows.append(check_serving_score(torch, ss, rng, 4096, 512, 8192,
                                        dtype))
    emit("kernels", kernel="serving_score", checks=len(rows),
         max_abs_err=max(r["max_abs_err"] for r in rows),
         within_tolerance=True)
    return rows


# -- serve -----------------------------------------------------------------

def make_model(np, torch, rng):
    from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                             RandomEffectModel)
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.types import TaskType

    w = (rng.normal(size=D_GLOBAL) * 0.5).astype(np.float32)
    W_u = (rng.normal(size=(NUM_USERS, D_RE)) * 0.7).astype(np.float32)
    W_i = (rng.normal(size=(NUM_ITEMS, D_RE)) * 0.7).astype(np.float32)
    model = GameModel(task=TaskType.LOGISTIC_REGRESSION, models={
        "fixed": FixedEffectModel("global",
                                  Coefficients(torch.from_numpy(w))),
        "per-user": RandomEffectModel("userId", "re_userId",
                                      torch.from_numpy(W_u)),
        "per-item": RandomEffectModel("itemId", "re_itemId",
                                      torch.from_numpy(W_i)),
    })
    return model, (w, W_u, W_i)


def make_traffic(np, rng, count: int) -> dict:
    """Requests with Zipf(1.2) user and item ids and 2% unseen ids."""
    def ids(E):
        p = 1.0 / np.arange(1, E + 1) ** ZIPF_SKEW
        e = rng.choice(E, size=count, p=p / p.sum()).astype(np.int64)
        unseen = rng.random(count) < UNSEEN_FRAC
        e[unseen] = E + rng.integers(0, 1000, int(unseen.sum()))
        return e

    return {"x_g": rng.normal(size=(count, D_GLOBAL)).astype(np.float32),
            "x_u": rng.normal(size=(count, D_RE)).astype(np.float32),
            "x_i": rng.normal(size=(count, D_RE)).astype(np.float32),
            "u": ids(NUM_USERS), "i": ids(NUM_ITEMS),
            "offset": (rng.normal(size=count) * 0.1).astype(np.float32)}


def oracle(np, traffic, tables, int8: bool):
    """float64 scores and per-request tolerances: 1e-4 for f32 caches;
    for int8, the per-row quantisation bound Σ|x|·scale/2 on top."""
    w, W_u, W_i = (t.astype(np.float64) for t in tables)
    score = traffic["offset"].astype(np.float64) \
        + traffic["x_g"].astype(np.float64) @ w
    tol = np.full(score.shape, 1e-4)
    for key, ids, W in (("x_u", traffic["u"], W_u),
                        ("x_i", traffic["i"], W_i)):
        x = traffic[key].astype(np.float64)
        seen = ids < W.shape[0]
        rows = np.where(seen[:, None], W[np.minimum(ids, W.shape[0] - 1)],
                        0.0)
        score += np.einsum("nd,nd->n", x, rows)
        if int8:
            row_scale = np.abs(rows).max(axis=1) / 127.0
            tol += np.abs(x).sum(axis=1) * row_scale / 2
    return score, tol


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def direct_pass(np, torch, svc, traffic, want, tol, label) -> dict:
    """The same traffic through the service's flush path with no HTTP
    threads in the process: per-flush assemble and device walls, then
    the same pass again under torch.profiler for the card's busy time
    (kernels and copies) against the pass's wall."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_torch.serving import ScoringRequest

    count = traffic["u"].shape[0]
    reqs = [ScoringRequest(
        features={"global": traffic["x_g"][k], "re_userId": traffic["x_u"][k],
                  "re_itemId": traffic["x_i"][k]},
        entity_ids={"userId": int(traffic["u"][k]),
                    "itemId": int(traffic["i"][k])},
        offset=float(traffic["offset"][k])) for k in range(count)]
    chunks = [reqs[i:i + svc.max_batch]
              for i in range(0, count, svc.max_batch)]
    assemble, device, got = [], [], []
    for chunk in chunks:
        out, (t_a0, t_d0, t_d1) = svc._score_chunk(chunk)
        got.append(out)
        assemble.append((t_d0 - t_a0) * 1e3)
        device.append((t_d1 - t_d0) * 1e3)
    got = np.concatenate(got)
    if not np.all(np.abs(got - want) <= tol):
        raise AssertionError(f"{label}: direct scores disagree with the "
                             "oracle")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for chunk in chunks:
            svc._score_chunk(chunk)
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return {"direct_flushes": len(chunks),
            "direct_assemble_p50_ms": float(np.median(assemble)),
            "direct_device_p50_ms": float(np.median(device)),
            "direct_rows_per_s": count / (sum(assemble) + sum(device))
            * 1e3,
            "profiled_device_busy_us_per_flush": busy_us / len(chunks),
            "profiled_device_busy_share": busy_us * 1e-6 / wall}


def serve_config(np, torch, ss, label, model_dir, extra, traffic, want,
                 tol, clients=4, per_post=4) -> dict:
    from photon_ml_torch.cli import serve

    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--port", "0", "--device", "cuda",
         *extra])
    server, svc = serve.create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for st in svc.store.random:
            if st.cache.device.type != "cuda" or (
                    st.cache_scale is not None
                    and st.cache_scale.device.type != "cuda"):
                raise AssertionError(f"{label}: cache of {st.cid} is not "
                                     "on the card")
        url = f"http://127.0.0.1:{server.server_address[1]}"
        count = traffic["u"].shape[0]

        def body(lo, hi):
            return {"requests": [{
                "features": {"global": traffic["x_g"][k].tolist(),
                             "re_userId": traffic["x_u"][k].tolist(),
                             "re_itemId": traffic["x_i"][k].tolist()},
                "entity_ids": {"userId": int(traffic["u"][k]),
                               "itemId": int(traffic["i"][k])},
                "offset": float(traffic["offset"][k]), "uid": k}
                for k in range(lo, hi)]}

        ss.score_rows.launches = 0  # this config's main-path run starts
        warm = _post(url + "/score", body(0, 1))  # first flush: cold
        got = np.full(count, np.nan)
        got[0] = warm["scores"][0]
        posts = [(lo, min(lo + per_post, count))
                 for lo in range(1, count, per_post)]
        latencies = []
        lat_lock = threading.Lock()

        def client(chunk):
            for lo, hi in chunk:
                t0 = time.perf_counter()
                resp = _post(url + "/score", body(lo, hi))
                dt = time.perf_counter() - t0
                with lat_lock:
                    latencies.append(dt)
                    got[lo:hi] = resp["scores"]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            futures = [pool.submit(client, posts[c::clients])
                       for c in range(clients)]
            for f in futures:
                f.result()
        wall = time.perf_counter() - t0
        # The main path's counts end here: the direct pass below goes
        # around HTTP and the batcher, and is kept out of them.
        launches = ss.score_rows.launches
        snap = svc.metrics.snapshot()
        err = np.abs(got - want)
        if not np.all(err <= tol):
            k = int(np.argmax(err - tol))
            raise AssertionError(
                f"{label}: score {got[k]} vs oracle {want[k]} "
                f"(|err| {err[k]}, tolerance {tol[k]}) at request {k}")
        if launches < 2 * snap["batches_total"]:
            raise AssertionError(
                f"{label}: serving_score launched {launches} times for "
                f"{snap['batches_total']} flushes of two RE coordinates")
        metrics = _get(url + "/metrics").decode()
        if "photon_serving_rows_total" not in metrics:
            raise AssertionError(f"{label}: /metrics lacks rows_total")
        health = json.loads(_get(url + "/healthz"))
        if health.get("status") != "ok":
            raise AssertionError(f"{label}: /healthz said {health}")
        direct = direct_pass(np, torch, svc, traffic, want, tol, label)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=30)
    lat_ms = np.asarray(latencies) * 1e3
    return {"config": label, "requests": count, "posts": len(posts) + 1,
            "clients": clients, "flushes": snap["batches_total"],
            "launches": launches,
            "batch_fill_ratio": snap["batch_fill_ratio"],
            "max_abs_err": float(err.max()),
            "post_p50_ms": float(np.percentile(lat_ms, 50)),
            "post_p99_ms": float(np.percentile(lat_ms, 99)),
            "rows_per_s": (count - 1) / wall,
            "request_p50_ms": snap["request_latency"]["p50_ms"],
            "request_p99_ms": snap["request_latency"]["p99_ms"],
            "flush_device_p50_ms": snap["batch_latency"]["p50_ms"],
            "stage_ms_mean": {
                k: v / snap["stage_requests_total"] * 1e3
                for k, v in snap["stage_seconds_total"].items()},
            "re_cache": snap["re_cache"], **direct}


def phase_serve(np, torch, card: str) -> tuple[int, int]:
    from photon_ml_torch.models import io as model_io
    from photon_ml_torch.ops.kernels import serving_score as ss

    rng = np.random.default_rng(SEED)
    model, tables = make_model(np, torch, rng)
    traffic = make_traffic(np, rng, 641)
    want32, tol32 = oracle(np, traffic, tables, int8=False)
    want8, tol8 = oracle(np, traffic, tables, int8=True)
    mean_traffic = {k: v[:129] for k, v in traffic.items()}
    want_mean = 1.0 / (1.0 + np.exp(-want32[:129]))
    configs = [
        ("a: defaults (cache 4096, float32, max_batch 64)", [], traffic,
         want32, tol32),
        ("b: whole tables resident, int8",
         ["--cache-entities", str(NUM_USERS), "--cache-dtype", "int8"],
         traffic, want8, tol8),
        ("c: defaults, --as-mean", ["--as-mean"], mean_traffic, want_mean,
         tol32[:129]),
    ]
    with tempfile.TemporaryDirectory(prefix="photon-chip-smoke-") as tmp:
        model_dir = os.path.join(tmp, "model")
        model_io.save_game_model(model, model_dir)
        launches = flushes = 0
        for label, extra, tr, want, tol in configs:
            out = serve_config(np, torch, ss, label, model_dir, extra, tr,
                               want, tol)
            launches += out["launches"]
            flushes += out["flushes"]
            emit("serve", card=card, **out)
    return launches, flushes


# -- train -----------------------------------------------------------------

def make_train_data(np, rows: int):
    """Config-4 data at full width from the seed, the last 5% held out
    for validation (as the flagship does)."""
    from photon_ml_torch.data import synthetic
    from photon_ml_torch.data.game_data import from_synthetic

    ds = from_synthetic(synthetic.game_data(
        np.random.default_rng(SEED), n=rows, d_global=D_GLOBAL,
        re_specs={"userId": (NUM_USERS, D_RE), "itemId": (NUM_ITEMS, D_RE)},
        task="logistic"))
    n_val = max(rows // 20, 1)
    return (ds.subset(np.arange(rows - n_val)),
            ds.subset(np.arange(rows - n_val, rows)))


def build_coordinates(np, torch, train, device: str):
    """The three coordinates as the flagship builds them, and each one's
    staging seconds (bucketing and the copies onto the device)."""
    from photon_ml_torch.game.coordinates import (FixedEffectCoordinate,
                                                  RandomEffectCoordinate)
    from photon_ml_torch.ops import losses
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)

    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=25, tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))

    def random_effect(re_type):
        return RandomEffectCoordinate(
            train, re_type, f"re_{re_type}", losses.LOGISTIC, cfg,
            upper_bound=UPPER_BOUND, rng=np.random.default_rng(0),
            device=device)

    builders = (
        ("fixed", lambda: FixedEffectCoordinate(
            train, "global", losses.LOGISTIC, cfg, device=device)),
        ("per-user", lambda: random_effect("userId")),
        ("per-item", lambda: random_effect("itemId")))
    coords, seconds = {}, {}
    for cid, build in builders:
        t0 = time.perf_counter()
        coords[cid] = build()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[cid] = time.perf_counter() - t0
    return coords, seconds


def run_descent(torch, coords, val, device: str):
    """DESCENT_ITERATIONS outer iterations over SEQ, with the validation
    AUC after each update; returns (model, history, seconds)."""
    from photon_ml_torch.evaluation.evaluators import auc
    from photon_ml_torch.game import descent
    from photon_ml_torch.types import TaskType

    y_val = torch.as_tensor(val.response, device=device)

    def validation(model):
        return {"auc": float(auc(model.score(val), y_val))}

    t0 = time.perf_counter()
    model, history = descent.run(
        TaskType.LOGISTIC_REGRESSION, coords,
        descent.CoordinateDescentConfig(SEQ, iterations=DESCENT_ITERATIONS),
        validation_fn=validation)
    return model, history, time.perf_counter() - t0


def coefficient_tables(model) -> dict:
    return {"fixed": model.models["fixed"].coefficients.means,
            "per-user": model.models["per-user"].means,
            "per-item": model.models["per-item"].means}


def phase_train(np, torch, card: str) -> dict:
    from photon_ml_torch.ops.kernels import re_rows as rr
    from photon_ml_torch.optim import lbfgs

    t0 = time.perf_counter()
    train, val = make_train_data(np, TRAIN_ROWS)
    generate_s = time.perf_counter() - t0
    coords, staging_s = build_coordinates(np, torch, train, "cuda")
    waves = {cid: coords[cid].num_waves for cid in SEQ[1:]}
    torch.cuda.reset_peak_memory_stats()
    rr.gather_rows.launches = 0  # the training path's run starts
    rr.scatter_rows_.launches = 0
    lbfgs.minimize.host_syncs = 0
    model, history, descent_s = run_descent(torch, coords, val, "cuda")
    gathers = rr.gather_rows.launches  # ... and ends here
    scatters = rr.scatter_rows_.launches
    syncs = lbfgs.minimize.host_syncs
    peak = torch.cuda.max_memory_allocated()
    expected = DESCENT_ITERATIONS * sum(waves.values())
    if gathers != expected or scatters != expected:
        raise AssertionError(
            f"train: {gathers} gathers and {scatters} scatters launched, "
            f"expected {expected} each ({waves} waves x "
            f"{DESCENT_ITERATIONS} iterations)")
    for cid, table in coefficient_tables(model).items():
        if table.device.type != "cuda" or not bool(
                torch.isfinite(table).all()):
            raise AssertionError(f"train: {cid} coefficients are not "
                                 "finite, or not on the card")
    aucs = [r["validation"]["auc"] for r in history.records]
    if not aucs[-1] > aucs[0]:
        raise AssertionError(f"train: final validation AUC {aucs[-1]} is "
                             f"not above the fixed-effect-only {aucs[0]}")
    emit("train", card=card, rows=train.num_rows, val_rows=val.num_rows,
         generate_seconds=generate_s, staging_seconds=staging_s,
         waves=waves,
         buckets={cid: [[b.capacity, b.num_entities]
                        for b in coords[cid].bucketing.buckets]
                  for cid in SEQ[1:]},
         updates=[{"iteration": r["iteration"],
                   "coordinate": r["coordinate"],
                   "train_seconds": r["train_seconds"],
                   "auc": r["validation"]["auc"]} for r in history.records],
         descent_seconds=descent_s,
         launches={"gather_rows": gathers, "scatter_rows_": scatters},
         solver_host_syncs=syncs, max_memory_allocated=peak)
    return {"coords": coords, "model": model, "gathers": gathers,
            "scatters": scatters}


# -- re_rows kernels -------------------------------------------------------

def check_re_rows(torch, rr, W, rows, label: str, timed: bool) -> dict:
    """gather_rows and scatter_rows_ against their plain versions, bit
    for bit, on one wave; with ``timed``, the times of kernel, plain
    version and library call too."""
    B, d, E = int(rows.shape[0]), int(W.shape[1]), int(W.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(B * 31 + E)
    vals = torch.randn((B, d), generator=gen, device="cuda")
    if not torch.equal(rr.gather_rows(W, rows),
                       rr.gather_rows_reference(W, rows)):
        raise AssertionError(f"gather_rows {label} B={B}: not bit-exact")
    got, want = W.clone(), W.clone()
    ptr = got.data_ptr()
    out = rr.scatter_rows_(got, rows, vals)
    rr.scatter_rows_reference(want, rows, vals)
    torch.cuda.synchronize()
    if out.data_ptr() != ptr or not torch.equal(got, want):
        raise AssertionError(f"scatter_rows_ {label} B={B}: not bit-exact "
                             "or not in place")
    valid_mask = rows >= 0
    valid = int(valid_mask.sum())
    row = {"wave": label, "B": B, "d": d, "E": E, "valid": valid,
           "max_abs_err": 0.0}
    if not timed:
        return row
    clamped = rows.clamp(min=0).long()
    idx, vals_valid = rows[valid_mask].long(), vals[valid_mask]

    def bound(nbytes):
        return nbytes / PEAK_BYTES_PER_S * 1e3

    # Bytes each call must move: every lane's row read and written (the
    # gather) or each valid lane's (the scatter), and the B ids.
    row["gather"] = {
        "ms": device_ms(torch, lambda: rr.gather_rows(W, rows)),
        "call_ms": call_ms(torch, lambda: rr.gather_rows(W, rows)),
        "plain_ms": device_ms(torch,
                              lambda: rr.gather_rows_reference(W, rows)),
        "plain_call_ms": call_ms(torch,
                                 lambda: rr.gather_rows_reference(W, rows)),
        "library_ms": device_ms(torch,
                                lambda: torch.index_select(W, 0, clamped)),
        "bound_ms": bound(2 * B * d * 4 + B * 4), "bound_by": "bytes"}
    # The plain scatter compacts its valid lanes with a device read, so
    # it cannot be captured in a graph: its time is per call only.
    row["scatter"] = {
        "ms": device_ms(torch, lambda: rr.scatter_rows_(got, rows, vals)),
        "call_ms": call_ms(torch, lambda: rr.scatter_rows_(got, rows, vals)),
        "plain_ms": None,
        "plain_call_ms": call_ms(
            torch, lambda: rr.scatter_rows_reference(got, rows, vals)),
        # With no valid lane the library call launches nothing to time.
        "library_ms": device_ms(
            torch, lambda: got.index_copy_(0, idx, vals_valid))
        if valid else None,
        "bound_ms": bound(2 * valid * d * 4 + B * 4), "bound_by": "bytes"}
    return row


def phase_re_rows(np, torch, trained: dict) -> list[dict]:
    from photon_ml_torch.ops.kernels import re_rows as rr

    rows_out = []
    for cid in SEQ[1:]:
        W = trained["model"].models[cid].means.contiguous()
        seen = set()
        for k, rows in enumerate(trained["coords"][cid].wave_rows):
            B = int(rows.shape[0])
            rows_out.append(check_re_rows(torch, rr, W, rows,
                                          f"{cid} wave {k}", B not in seen))
            seen.add(B)
        # An all-padding wave: the gather reads row 0, the scatter writes
        # nothing.
        pad = torch.full((4096,), -1, dtype=torch.int32, device="cuda")
        rows_out.append(check_re_rows(torch, rr, W, pad,
                                      f"{cid} all-padding", True))
    # The sweep shape: 8,192 lanes of a 65,536 x 512 table, 10% padding.
    rng = np.random.default_rng(SEED)
    W = torch.from_numpy(rng.normal(size=(65536, 512)).astype(
        np.float32)).cuda()
    ids = rng.permutation(65536)[:8192].astype(np.int32)
    ids[rng.random(8192) < 0.1] = -1
    rows_out.append(check_re_rows(torch, rr, W, torch.from_numpy(ids).cuda(),
                                  "sweep", True))
    timed = [r for r in rows_out if "gather" in r]
    emit("kernels", kernel="re_rows", checks=len(rows_out),
         bit_exact=True, timed_shapes=len(timed), shapes=timed)
    return rows_out


# -- train_parity ----------------------------------------------------------

class RecordedCoordinate:
    """A coordinate whose train_model calls are recorded: the offsets,
    the warm start and the trained model of each update."""

    def __init__(self, coord):
        self.coord = coord
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.coord, name)

    def train_model(self, offsets, initial=None):
        model = self.coord.train_model(offsets, initial=initial)
        self.calls.append((offsets.cpu(), initial, model))
        return model


def well_determined(np, coord):
    """(E,) entities whose coefficients the data pins down: at least
    WELL_DETERMINED_ROWS training rows, with both labels. At 300,000 rows
    most entities have one to three rows, and their intercept (not
    regularized, as in the reference) is not pinned where those rows are,
    or given the offsets look, separable: the solver drives it towards
    ±inf until max_iterations and stops at a point set by the last bits
    of every step. Two CPU runs that differ only in their thread count
    disagree on those entities as much as cuda and cpu do."""
    out = np.zeros(coord.num_entities, bool)
    y = coord.dataset.response
    for b in coord.bucketing.buckets:
        live = b.example_idx >= 0
        lab = y[np.maximum(b.example_idx, 0)]
        mixed = (live & (lab > 0.5)).any(1) & (live & (lab < 0.5)).any(1)
        ok = (b.entity_rows >= 0) & mixed & (b.counts >= WELL_DETERMINED_ROWS)
        out[b.entity_rows[ok]] = True
    return out


def compare_update(np, coord, got, want) -> dict:
    """Largest coefficient difference of one update: over the whole
    table ("all") and over what the check holds ("held"): the fixed
    effect in full, a random effect's well-determined entities."""
    if hasattr(got, "coefficients"):
        diff = (got.coefficients.means.cpu()
                - want.coefficients.means.cpu()).abs().numpy()
        return {"all": float(diff.max()), "held": float(diff.max())}
    diff = (got.means.cpu() - want.means.cpu()).abs().numpy()
    held = well_determined(np, coord)
    return {"all": float(diff.max()), "held": float(diff[held].max()),
            "held_entities": int(held.sum()),
            "trained_entities": int(coord.bucketing.trained_entities.sum())}


def phase_train_parity(np, torch, card: str) -> None:
    """The descent on the card and on the CPU. Each update of the card's
    run is replayed on the CPU from the same offsets and warm start and
    compared there: the two descents' own paths may part at entities the
    data does not determine, and every later update would inherit that."""
    train, val = make_train_data(np, PARITY_ROWS)
    cuda_coords, _ = build_coordinates(np, torch, train, "cuda")
    recorded = {cid: RecordedCoordinate(c) for cid, c in cuda_coords.items()}
    cuda_model, cuda_hist, cuda_s = run_descent(torch, recorded, val, "cuda")
    cpu_coords, _ = build_coordinates(np, torch, train, "cpu")
    cpu_model, cpu_hist, cpu_s = run_descent(torch, cpu_coords, val, "cpu")
    updates = []
    for cid in SEQ:
        for k, (offsets, initial, got) in enumerate(recorded[cid].calls):
            want = cpu_coords[cid].train_model(offsets, initial=initial)
            updates.append({"coordinate": cid, "iteration": k,
                            **compare_update(np, cpu_coords[cid], got,
                                             want)})
    auc_cuda = [r["validation"]["auc"] for r in cuda_hist.records]
    auc_cpu = [r["validation"]["auc"] for r in cpu_hist.records]
    auc_diff = float(np.max(np.abs(np.subtract(auc_cuda, auc_cpu))))
    p_diff = (torch.sigmoid(cuda_model.score(val)).cpu()
              - torch.sigmoid(cpu_model.score(val)).cpu()).abs()
    emit("train_parity", card=card, rows=train.num_rows, updates=updates,
         auc_cuda=auc_cuda, auc_cpu=auc_cpu, max_auc_diff=auc_diff,
         val_probability_diff={"mean": float(p_diff.mean()),
                               "max": float(p_diff.max())},
         descent_seconds={"cuda": cuda_s, "cpu": cpu_s},
         tolerance=PARITY_TOL, well_determined_rows=WELL_DETERMINED_ROWS)
    bad = [u for u in updates if not u["held"] <= PARITY_TOL]
    if bad or not auc_diff <= PARITY_TOL \
            or not float(p_diff.mean()) <= PARITY_TOL:
        raise AssertionError(
            f"train_parity: cuda and cpu differ beyond {PARITY_TOL}: "
            f"updates {bad}, AUC {auc_diff}, mean validation probability "
            f"{float(p_diff.mean())}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import photon_ml_torch
    from photon_ml_torch.device import resolve_device
    from photon_ml_torch.ops.kernels import _build

    if os.path.dirname(os.path.dirname(photon_ml_torch.__file__)) != ROOT:
        raise ImportError(f"photon_ml_torch was imported from "
                          f"{photon_ml_torch.__file__}, not beside "
                          f"this script")
    resolve_device("cuda")
    card = nvidia_smi_line()
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build()
    emit("build", seconds=time.perf_counter() - t0, built=built,
         sources=_build.sources())

    checks = phase_kernels(torch, np)
    launches, flushes = phase_serve(np, torch, card)
    trained = phase_train(np, torch, card)
    re_checks = phase_re_rows(np, torch, trained)
    re_launches = {"gather": trained["gathers"],
                   "scatter": trained["scatters"]}
    del trained
    torch.cuda.empty_cache()
    phase_train_parity(np, torch, card)

    main_shape = next(c for c in checks if c["n"] == 64
                      and c["cache"] == "float32")
    table = [{
        "name": "serving_score", "route": "cuda",
        "source": "photon_ml_torch/csrc/serving_score.cu",
        "replaces": "photon_ml_tpu/ops/kernels/serving_score.py:45",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "call_ms": main_shape["call_ms"],
        "shape": "n=64 d=8 E=4097 float32 (serving, config a)",
        "flushes": flushes, "checks": checks}]
    # The re_rows entries report the largest per-user wave, the shape
    # that carries most of the training path's lanes.
    timed = [c for c in re_checks if "gather" in c]
    main_wave = max((c for c in timed if c["wave"].startswith("per-user")
                     and "padding" not in c["wave"]), key=lambda c: c["B"])
    shape = (f"B={main_wave['B']} d={main_wave['d']} E={main_wave['E']} "
             f"({main_wave['wave']}, {main_wave['valid']} valid lanes)")
    for name, key, line, plain_key in (
            ("re_gather_rows", "gather", 60, "plain_ms"),
            ("re_scatter_rows", "scatter", 90, "plain_call_ms")):
        m = main_wave[key]
        table.append({
            "name": name, "route": "cuda",
            "source": "photon_ml_torch/csrc/re_rows.cu",
            "replaces": f"photon_ml_tpu/ops/kernels/re_rows.py:{line}",
            "launches": re_launches[key], "max_abs_err": 0.0,
            "ms": m["ms"], "plain_ms": m[plain_key],
            "plain_timing": ("graph replay" if plain_key == "plain_ms" else
                             "per call from Python: the plain scatter reads "
                             "the device to compact its valid lanes"),
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "call_ms": m["call_ms"], "shape": shape,
            "checks": len(re_checks)})
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
