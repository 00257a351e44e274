#!/usr/bin/env python3
"""Smoke run of the PyTorch port (photon_ml_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the exit
code is non-zero:

1. device  — requires CUDA; the card's name and power limit (nvidia-smi)
             and the torch/CUDA versions.
2. build   — builds every kernel library from photon_ml_torch/csrc/,
             all nvcc processes at once.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, at the shapes the serving path gives it and at the
             kernel-sweep shape, and times both with CUDA events: on
             the card alone (CUDA-graph replay, "ms") and per call from
             Python ("call_ms").
4. serve   — the port's main path: a config-4 (MovieLens-20M width)
             GAME model from a seed, written with save_game_model and
             served through cli.serve.create_server on port 0, answering
             concurrent HTTP clients; every score is checked against a
             float64 numpy oracle. The kernels' launch counts and the
             service metrics are read around the HTTP traffic alone;
             a direct pass around HTTP (with a profiled repeat) comes
             after they are read.

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

    main_shape = next(c for c in checks if c["n"] == 64
                      and c["cache"] == "float32")
    print(json.dumps({"kernels": [{
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
        "flushes": flushes, "checks": checks}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
