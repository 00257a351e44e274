#!/usr/bin/env python3
"""The bfloat16 entry of csrc/hot_pass.cu (hot_value_and_gradient and
hot_hessian_vector over a bfloat16 hybrid block) on one CUDA card.

    python3 dev-scripts/exp_hot_pass_bf16.py [--rows N] [--cols H]
        [--baseline FILE] [--no-checks] [--out FILE]

First (unless --no-checks) it checks the package's kernel through its
wrappers at edge shapes, for every loss: z and xv bit for bit the
two-kernel route's (stream_fused.hot_margins plus the cold term), each
column of g within 1e-5 of the float64 sum of |terms| of the same
rounded operands, within 1e-3 (parity_rel) of the plain version, two
launches the same bits. The shapes cover fewer rows than a tile, rows
ending mid-tile and mid-group, the narrowest and widest rows, and each
width class of the kernel's transposed product.

Then, at the main shape (by default config 5's bfloat16 hybrid block at
9.5M rows, 9,500,000 x 3,016, made on the card from a seed with 60%
zeros), it times each pass (value and gradient, H.v) through the C entry
at every ring shape (rows a tile, tiles in the ring) that the kernel
takes, built as it is and with HOT_PASS_TIMING_NO_TRANSPOSE (the pass
without its transposed product): the median of CUDA-graph replays of 3
calls. Each --baseline TAG=FILE is another hot_pass.cu (for example the
parent commit's), built both ways and timed beside the package's in
turns (baselines, package, package, baselines in reverse), its z and g
compared with the package's.

Prints one JSON line per result (also appended to --out) and, last,
nvidia-smi's name and power limit. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
TERM_TOL = 1e-5
PARITY_REL = 1e-3
SEED = 2026
RING_SHAPES = ((8, 2), (8, 3), (8, 4), (4, 4), (4, 8), (2, 8))
# (n, H, cold): fewer rows than a tile, mid-tile and mid-group ends, the
# narrowest and widest rows, and widths in each class of the transposed
# product's column vectors.
CHECK_SHAPES = ((5, 8, False), (1000, 40, False), (4097, 600, True),
                (513, 2984, True), (1029, 3016, True), (3, 3016, False),
                (777, 4096, True), (600, 8192, True), (2051, 2048, False))

_out = None


def emit(kind: str, **fields) -> None:
    line = json.dumps({"result": kind, **fields})
    print(line, flush=True)
    if _out:
        with open(_out, "a") as f:
            f.write(line + "\n")


def graph_ms(torch, fn, reps: int = 5, inner: int = 3) -> float:
    """Per-call time on the card: ``inner`` calls captured in a CUDA graph
    and replayed, median over ``reps`` event windows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    del graph
    return statistics.median(samples)


def build_entry(hp, src: str, tag: str, define: str = ""):
    """``src`` built into the package's build directory (with -D``define``),
    its hot_pass_bf16 entry typed as the package's."""
    from photon_ml_torch.ops.kernels import _build

    hp.load()
    lib = os.path.join(_build.BUILD_DIR, f"libhot_pass-{tag}.so")
    flags = [f"-D{define}"] if define else []
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib,
                    src], check=True, capture_output=True, text=True,
                   timeout=300)
    fn = ctypes.CDLL(lib).hot_pass_bf16
    entry = next(iter(hp._launchers.values()))
    fn.argtypes, fn.restype = entry.argtypes, entry.restype
    return fn


def raw_pass(torch, hp, fn, a, hessian: bool, rows: int, stages: int):
    """One pass through the C entry ``fn`` at the ring shape given: (z, xv
    or None, g), or the CUDA error code where the entry refuses it."""
    X = a["X"]
    n, h = (int(x) for x in X.shape)
    dev = X.device
    z = torch.empty(n, dtype=torch.float32, device=dev)
    xv = torch.empty(n, dtype=torch.float32, device=dev) if hessian else None
    groups = -(-n // hp.ROW_GROUP)
    partial = torch.empty((groups, h), dtype=torch.float32, device=dev)
    g = torch.empty(h, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(X.data_ptr(), a["w"].data_ptr(),
             ptr(a["v"]) if hessian else None, a["offsets"].data_ptr(),
             ptr(a["cold_z"]), ptr(a["cold_zv"]) if hessian else None,
             a["labels"].data_ptr(), a["weights"].data_ptr(), z.data_ptr(),
             ptr(xv), partial.data_ptr(), g.data_ptr(), n, h, rows, stages,
             groups, hp.LOSSES.index("logistic"),
             torch.cuda.current_stream().cuda_stream)
    if err:
        return err
    return z, xv, g


def make_block(torch, n: int, h: int, seed: int, cold: bool = True,
               chunk: int = 262_144) -> dict:
    """A bfloat16 (n, h) block with 60% zeros and the vectors of one
    pass, made on the card in chunks of rows: w and v rounded to
    bfloat16, logistic labels, weights with 5% zero."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.empty((n, h), dtype=torch.bfloat16, device=dev)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        part = torch.randn((i1 - i0, h), generator=gen, device=dev)
        part.masked_fill_(torch.rand((i1 - i0, h), generator=gen,
                                     device=dev) < 0.6, 0.0)
        X[i0:i1] = part
        del part

    def vec(size, scale):
        return scale * torch.randn(size, generator=gen, device=dev)

    w, v = (vec(h, 0.05).bfloat16().float() for _ in range(2))
    weights = torch.rand(n, generator=gen, device=dev) * 1.5 + 0.5
    weights.masked_fill_(torch.rand(n, generator=gen, device=dev) < 0.05,
                         0.0)
    return {"X": X, "w": w, "v": v, "offsets": vec(n, 0.2),
            "cold_z": vec(n, 0.3) if cold else None,
            "cold_zv": vec(n, 0.3) if cold else None,
            "labels": (torch.rand(n, generator=gen, device=dev) < 0.3)
            .float(), "weights": weights}


def check_shape(torch, hp, sf, loss, b: dict) -> dict:
    """The package's kernel on one block against the two-kernel route,
    the float64 sums and the plain version."""
    X, off, wt, y = b["X"], b["offsets"], b["weights"], b["labels"]
    cz, czv = b["cold_z"], b["cold_zv"]
    z = sf.hot_margins(X, b["w"], off)
    z = z if cz is None else z + cz
    xv = sf.hot_margins(X, b["v"], off)
    xv = (xv if czv is None else xv + czv) - off
    vg = (X, b["w"], off, cz, y, wt, loss)
    hv = (X, b["w"], b["v"], off, cz, czv, y, wt, loss)
    before = (hp.hot_value_and_gradient.launches,
              hp.hot_hessian_vector.launches)
    z1, g1 = hp.hot_value_and_gradient(*vg)
    z2, g2 = hp.hot_value_and_gradient(*vg)
    hz, hxv, h1 = hp.hot_hessian_vector(*hv)
    hz2, hxv2, h2 = hp.hot_hessian_vector(*hv)
    torch.cuda.synchronize()
    counted = (hp.hot_value_and_gradient.launches - before[0],
               hp.hot_hessian_vector.launches - before[1]) == (2, 2)
    bits = (torch.equal(z1, z) and torch.equal(z2, z)
            and torch.equal(hz, z) and torch.equal(hz2, z)
            and torch.equal(hxv, xv) and torch.equal(hxv2, xv)
            and torch.equal(g1, g2) and torch.equal(h1, h2))
    _, dl = loss.loss_and_dz(z, y)
    r_g = torch.where(wt > 0, wt * dl, torch.zeros_like(dl))
    r_h = torch.where(wt > 0, wt * loss.d2z(z, y),
                      torch.zeros_like(dl)) * xv
    x64 = X.double()
    out = {"bits": bits, "counted": counted}
    for name, got, r, plain in (
            ("vg", g1, r_g, hp.hot_value_and_gradient_reference(*vg)[1]),
            ("hv", h1, r_h, hp.hot_hessian_vector_reference(*hv)[2])):
        r64 = r.bfloat16().double()
        exact, mag = r64 @ x64, r64.abs() @ x64.abs()
        gap = (got.double() - exact).abs() - TERM_TOL * mag
        rel = float((got - plain).abs().max()) / max(
            float(plain.abs().max()), 1e-9)
        out[name] = {"terms_ok": bool((gap <= 0).all()),
                     "parity_rel": rel}
    out["ok"] = bool(bits and counted and all(
        out[k]["terms_ok"] and out[k]["parity_rel"] <= PARITY_REL
        for k in ("vg", "hv")))
    return out


def run_checks(torch, hp, sf, losses) -> bool:
    ok = True
    for name in hp.LOSSES:
        loss = getattr(losses, name.upper())
        for n, h, cold in CHECK_SHAPES:
            b = make_block(torch, n, h, SEED + n + h, cold)
            if name == "squared":
                b["labels"] = torch.randn(n, device="cuda")
            elif name == "poisson":
                b["labels"] = torch.poisson(torch.ones(n, device="cuda"))
            res = check_shape(torch, hp, sf, loss, b)
            ok = ok and res["ok"]
            emit("check", loss=name, n=n, H=h, cold=cold,
                 ring=hp.ring_shape(h, True, 2), **res)
    return ok


def main() -> int:
    global _out
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=9_500_000)
    p.add_argument("--cols", type=int, default=3016)
    p.add_argument("--baseline", action="append", default=[],
                   metavar="TAG=FILE",
                   help="another hot_pass.cu, timed beside the package's "
                        "(repeatable)")
    p.add_argument("--no-checks", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    _out = args.out

    import torch

    if not torch.cuda.is_available():
        print("exp_hot_pass_bf16: CUDA is not available", file=sys.stderr)
        return 2
    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops.kernels import _build
    from photon_ml_torch.ops.kernels import hot_pass as hp
    from photon_ml_torch.ops.kernels import stream_fused as sf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["hot_pass", "stream_fused"])
    hp.load()
    ok = True
    if not args.no_checks:
        ok = run_checks(torch, hp, sf, losses)
        if not ok:
            emit("done", ok=False)
            return 1

    src = os.path.join(_build.SRC_DIR, "hot_pass.cu")
    entries = {"package": hp._launchers[torch.bfloat16],
               "package no_transpose": build_entry(
                   hp, src, "exp-nt", "HOT_PASS_TIMING_NO_TRANSPOSE")}
    others = []
    for spec in args.baseline:
        tag, path = spec.split("=", 1)
        others.append(tag)
        entries[tag] = build_entry(hp, path, f"exp-{tag}")
        entries[f"{tag} no_transpose"] = build_entry(
            hp, path, f"exp-{tag}-nt", "HOT_PASS_TIMING_NO_TRANSPOSE")
    n, h = args.rows, args.cols
    a = make_block(torch, n, h, SEED)
    torch.cuda.synchronize()
    x_bytes = n * h * 2
    for hessian in (False, True):
        mode = "hot_hessian_vector" if hessian else "hot_value_and_gradient"
        vectors = 7 * n + 3 * h if hessian else 5 * n + 2 * h
        bound = (x_bytes + 4 * vectors) / PEAK_BYTES_PER_S * 1e3
        shape = hp.ring_shape(h, hessian, 2)
        geometry = {}
        for tag in ["package"] + others:
            for g in (shape, (8, 4), (8, 3)):
                res = raw_pass(torch, hp, entries[tag], a, hessian, *g)
                if not isinstance(res, int):
                    geometry[tag] = g
                    break
        zp, _, gp = raw_pass(torch, hp, entries["package"], a, hessian,
                             *shape)
        for tag in others:  # the same z bits; g within float32 rounding
            zb, _, gb = raw_pass(torch, hp, entries[tag], a, hessian,
                                 *geometry[tag])
            emit("agreement", mode=mode, entry=tag, ring=geometry[tag],
                 z_bits=torch.equal(zb, zp),
                 g_rel=float((gb - gp).abs().max())
                 / max(float(gp.abs().max()), 1e-9))
            del zb, gb
        del zp, gp
        order = others + ["package", "package"] + others[::-1]
        times = {}
        for tag in order:
            fn, g = entries[tag], geometry[tag]
            times.setdefault(tag, []).append(graph_ms(
                torch, lambda: raw_pass(torch, hp, fn, a, hessian, *g)))
        emit("pass", mode=mode, n=n, H=h, ring=geometry, bound_ms=bound,
             ms={k: min(v) for k, v in times.items()}, runs=times,
             bound_share={k: bound / min(v) for k, v in times.items()},
             card=card)
        for tag, fn in entries.items():
            ring = {}
            for rows, stages in RING_SHAPES:
                res = raw_pass(torch, hp, fn, a, hessian, rows, stages)
                if isinstance(res, int):
                    ring[f"{rows}x{stages}"] = f"refused ({res})"
                    continue
                del res
                ring[f"{rows}x{stages}"] = graph_ms(
                    torch, lambda: raw_pass(torch, hp, fn, a, hessian, rows,
                                            stages))
            emit("ring", mode=mode, entry=tag, n=n, H=h, bound_ms=bound,
                 ms=ring, card=card)
    emit("done", ok=ok)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
