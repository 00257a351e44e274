#!/usr/bin/env python3
"""The float32 ring route of csrc/stream_fused.cu, through the package's
wrappers, on one CUDA card.

    python3 dev-scripts/exp_ring_stream_fused.py [--rows N] [--cols H]

First it checks the ring route on the card at the main shape and at edge
shapes (fewer rows than a tile, rows not a multiple of a tile or of 512,
the narrowest and widest rows, a width with idle threads, and one width
for each template instantiation of the rmatvec kernel: 8, 4, 2 and 1
splits of a tile's rows, 1 to 16 column vectors a thread):
hot_margins bit for bit the direct route's (the same block read through
a view 4 bytes into a larger buffer, which the route rule sends direct),
both kernels within 1e-3 (parity_rel) of the plain versions, two launches
the same bits.

Then, at the main shape (by default the streamed chunk, 262,144 x 512),
it times the wrappers on the ring route at each ring depth that fits
(``MARGINS_STAGES`` / ``RMATVEC_STAGES`` set on the module), the direct
route (the misaligned copy) and the library calls (torch.addmv, torch.mv
on X.t()): the median of CUDA-graph replays of 20 calls. Under
torch.profiler it splits hot_rmatvec's time on the card between its two
launches (the partial rows, then their sum). Prints one JSON line per
result and, last, nvidia-smi's name and power limit. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PROFILED_CALLS = 50


def emit(kind: str, **fields) -> None:
    print(json.dumps({"result": kind, **fields}), flush=True)


def graph_ms(torch, fn, reps: int = 15, inner: int = 20) -> float:
    """Per-call time on the card: ``inner`` calls captured in a CUDA graph
    and replayed, median over ``reps`` event windows."""
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


def kernel_ms(torch, fn) -> dict:
    """Each kernel's mean time on the card over ``PROFILED_CALLS`` calls
    of ``fn``, by torch.profiler, keyed by the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def block(torch, gen, n: int, h: int):
    """X (n, h) float32 with 60% zeros, and a copy 4 bytes into a larger
    buffer (contiguous, not 16-byte aligned)."""
    X = torch.randn((n, h), generator=gen, device="cuda")
    X[torch.rand((n, h), generator=gen, device="cuda") < 0.6] = 0.0
    buf = torch.empty(n * h + 4, device="cuda")
    Xm = buf[1:1 + n * h].view(n, h)
    Xm.copy_(X)
    return X, Xm


def check(torch, sf, gen, n: int, h: int) -> dict:
    X, Xm = block(torch, gen, n, h)
    w, base, r = (torch.randn(s, generator=gen, device="cuda")
                  for s in (h, n, n))
    assert sf.route(X) == "ring" and sf.route(Xm) == "direct", (n, h)
    m1, m2 = sf.hot_margins(X, w, base), sf.hot_margins(X, w, base)
    md = sf.hot_margins(Xm, w, base)
    g1, g2 = sf.hot_rmatvec(X, r), sf.hot_rmatvec(X, r)
    gd = sf.hot_rmatvec(Xm, r)
    pm = sf.hot_margins_reference(X, w, base)
    pg = sf.hot_rmatvec_reference(X, r)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-9)

    row = {"n": n, "H": h,
           "rings": [sf.ring_shape(h, sf.MARGINS_STAGES),
                     sf.ring_shape(h, sf.RMATVEC_STAGES)],
           "margins_equal_direct": bool(torch.equal(m1, md)),
           "margins_two_launches": bool(torch.equal(m1, m2)),
           "rmatvec_two_launches": bool(torch.equal(g1, g2)),
           "margins_parity_rel": rel(m1, pm),
           "rmatvec_parity_rel": rel(g1, pg),
           "rmatvec_direct_parity_rel": rel(g1, gd)}
    row["ok"] = (row["margins_equal_direct"] and row["margins_two_launches"]
                 and row["rmatvec_two_launches"]
                 and row["margins_parity_rel"] <= 1e-3
                 and row["rmatvec_parity_rel"] <= 1e-3)
    emit("check", **row)
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=262_144)
    p.add_argument("--cols", type=int, default=512)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("exp_ring_stream_fused: no CUDA card", file=sys.stderr)
        return 1
    from photon_ml_torch.ops.kernels import stream_fused as sf

    gen = torch.Generator(device="cuda").manual_seed(2026)
    rows = [check(torch, sf, gen, n, h) for n, h in (
        (args.rows, args.cols), (5, 512), (1000, 512), (4099, 1772),
        (1, 4), (777, 4), (1003, 64), (1003, 96), (1030, 192),
        (1030, 516), (777, 4000), (2051, 8192), (1500, 384), (513, 96))]
    if not all(r["ok"] for r in rows):
        emit("failed", shapes=[r for r in rows if not r["ok"]])
        return 1

    n, h = args.rows, args.cols
    X, Xm = block(torch, gen, n, h)
    w, base, r = (torch.randn(s, generator=gen, device="cuda")
                  for s in (h, n, n))
    calls = {"hot_margins": (lambda Y: lambda: sf.hot_margins(Y, w, base)),
             "hot_rmatvec": (lambda Y: lambda: sf.hot_rmatvec(Y, r))}
    bounds = {"hot_margins": (n * h + h + 2 * n) * 4 / PEAK_BYTES_PER_S * 1e3,
              "hot_rmatvec": (n * h + n + h) * 4 / PEAK_BYTES_PER_S * 1e3}
    library = {"hot_margins": lambda: torch.addmv(base, X, w),
               "hot_rmatvec": lambda: torch.mv(X.t(), r)}
    for name, knob in (("hot_margins", "MARGINS_STAGES"),
                       ("hot_rmatvec", "RMATVEC_STAGES")):
        chosen = getattr(sf, knob)
        by_depth = {}
        for stages in (2, 3, 4):
            if sf.shared_bytes(h, 1, stages) > sf.MAX_SHARED:
                continue
            setattr(sf, knob, stages)
            shape = "x".join(map(str, sf.ring_shape(h, stages)))
            by_depth[shape] = graph_ms(torch, calls[name](X))
        setattr(sf, knob, chosen)
        emit("times", kernel=name, n=n, H=h,
             ring_shape=sf.ring_shape(h, chosen), bound_ms=bounds[name],
             ms=graph_ms(torch, calls[name](X)), ms_by_ring=by_depth,
             direct_route_ms=graph_ms(torch, calls[name](Xm)),
             library_ms=graph_ms(torch, library[name]),
             library_call=("torch.addmv" if name == "hot_margins"
                           else "torch.mv on X.t()"),
             profiled_kernel_ms=kernel_ms(torch, calls[name](X)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
