#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ProbGraph on one GPU and check it.

    python3 chip_smoke.py                  # from the root of a checkout

Phases, each printed as it runs:

  1. Environment: the card's name and power limit, torch and CUDA
     versions, and the build of every CUDA kernel from ``src/``.
  2. Kernels against their plain PyTorch versions on the card, over
     AND2/AND3/AND4/OR/ANDNOT/nested programs, row widths 2..600 and
     ragged tuple counts up to ~1M (integers: equality required), then
     each kernel timed at the main path's shape beside its byte bound.
  3. The main path: a scale-21 Kronecker graph (2.1M vertices, 31.8M
     edges), ``session(g, "bf", storage_budget=1.0)`` on the card,
     ``triangle_count()`` and ``local_clustering()``. The launch counts are
     zeroed just before and read just after; per-edge popcounts of a fixed
     1M-edge sample and the TC are held against the plain path on the card.
  4. Where the time goes: a warm pass and a sketch build under
     torch.profiler (device busy time, idle share, top kernels).
  5. A scale-12 graph against an independent numpy reference of the same
     estimator (sketch words identical; TC and LCC within rtol 1e-4).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It also fails at once without a CUDA
device, or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

#: Kronecker scale of the main path: 2^21 vertices, ~31.8M edges
SCALE = 21

#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and the
#: 32-bit rate outside the tensor cores, ops/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def require(cond: bool, msg: str) -> None:
    """Fail the run (non-zero exit, no result line) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 30) -> float:
    """Median device time of ``fn()`` with CUDA events.

    ``flush()`` runs before each launch: it evicts L2 (the sketch is larger
    than L2, so its callers find it cold) and keeps the device busy long
    enough that the host has enqueued ``fn``'s launches before the start
    event fires, so the events time the device work and not the host's
    Python in between.
    """
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, ops / peak rate)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, setexpr, fused_expr, ref):
    """Phase 2: parity on many shapes, then timing at the main path's shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u, v, w, x = setexpr.rows(4)
    exprs = {"AND2": u & v, "AND3": u & v & w, "AND4": u & v & w & x,
             "OR": u | v, "ANDNOT": u - v, "nested": (u | (v & w)) - (x | u)}
    programs = {k: setexpr.compile_program(e) for k, e in exprs.items()}
    n = 100_003
    cases = [(W, T) for W in (2, 8, 32, 34) for T in (1, 999, 65_549,
                                                        1_000_003)]
    cases += [(600, T) for T in (1, 999, 70_001)]
    checked = 0
    max_err = {"fused_gather_popcount": 0, "fused_rows_popcount": 0}
    for W, T in cases:
        data = torch.randint(-2**31, 2**31 - 1, (n, W), dtype=torch.int32,
                             device=dev, generator=gen)
        data[0] = -1                                  # an all-ones row
        tuples = torch.randint(0, n, (T, 4), dtype=torch.int32, device=dev,
                               generator=gen)
        tuples[::7, 0] = 0
        for name, prog in programs.items():
            got = fused_expr.fused_gather_popcount(data, tuples, prog)
            want = ref.fused_gather_popcount(data, tuples, prog)
            max_err["fused_gather_popcount"] = max(
                max_err["fused_gather_popcount"],
                int((got - want).abs().max()))
            require(torch.equal(got, want),
                    f"gather {name} W={W} T={T}: "
                    f"{int((got != want).sum())} tuples differ")
            rows = [data[tuples[:, s].long()] for s in prog.slots]
            got_r = fused_expr.fused_rows_popcount(rows, prog)
            want_r = ref.fused_rows_popcount(rows, prog)
            max_err["fused_rows_popcount"] = max(
                max_err["fused_rows_popcount"],
                int((got_r - want_r).abs().max()))
            require(torch.equal(got_r, want_r),
                    f"rows {name} W={W} T={T}: "
                    f"{int((got_r != want_r).sum())} rows differ")
            checked += 2
        del data, tuples, rows
    torch.cuda.synchronize()
    print(f"phase 2: kernels equal their plain versions on {checked} cases "
          f"({len(cases)} shapes x {len(programs)} programs x 2 forms); "
          f"max_abs_err {max_err}", flush=True)

    # timing at the main path's shape: scale-21 rows of 32 words, one
    # 65,536-edge chunk of the AND2 pass
    n21, W, T, k = 1 << 21, 32, 65_536, 2
    data = torch.randint(-2**31, 2**31 - 1, (n21, W), dtype=torch.int32,
                         device=dev, generator=gen)
    tuples = torch.randint(0, n21, (T, k), dtype=torch.int32, device=dev,
                           generator=gen)
    prog = programs["AND2"]
    scratch = torch.empty(2 << 30, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    distinct = int(torch.unique(tuples).numel())
    g_bytes = distinct * W * 4 + T * k * 4 + T * 4
    g_ops = T * W * (k + 1)                   # k-1 ANDs, a popcount, an add
    g_bound, g_by = bound_ms(g_bytes, g_ops)
    g_ms = time_ms(lambda: fused_expr.fused_gather_popcount(data, tuples,
                                                            prog), flush)
    g_plain = time_ms(lambda: ref.fused_gather_popcount(data, tuples, prog),
                      flush)
    rows = [data[tuples[:, s].long()] for s in prog.slots]
    r_bytes = k * T * W * 4 + T * 4
    r_bound, r_by = bound_ms(r_bytes, g_ops)
    r_ms = time_ms(lambda: fused_expr.fused_rows_popcount(rows, prog), flush)
    r_plain = time_ms(lambda: ref.fused_rows_popcount(rows, prog), flush)
    del data, tuples, rows, scratch
    torch.cuda.empty_cache()
    timing = {
        "fused_gather_popcount": dict(
            ms=g_ms, plain_ms=g_plain, bound_ms=g_bound, bound_by=g_by,
            bytes=g_bytes, max_abs_err=max_err["fused_gather_popcount"]),
        "fused_rows_popcount": dict(
            ms=r_ms, plain_ms=r_plain, bound_ms=r_bound, bound_by=r_by,
            bytes=r_bytes, max_abs_err=max_err["fused_rows_popcount"]),
    }
    for name, t in timing.items():
        print(f"  {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
              f"{t['bytes']} bytes, {t['bound_ms'] / t['ms']:.1%} of bound) "
              f"at T={T} W={W} k={k}", flush=True)
    return timing


def phase_main(torch, np, TE, TG, fused_expr, scale: int):
    """Phase 3: the port's main path at full size, then its checks."""
    t0 = time.perf_counter()
    g = TG.kronecker(scale, 16, seed=1, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"phase 3: kronecker({scale}, 16, seed=1): n={g.n} m={g.m} "
          f"d_max={g.d_max} generate+CSR {gen_s:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fused_expr.reset_launch_counts()
    t0 = time.perf_counter()
    sess = TE.session(g, "bf", storage_budget=1.0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc = float(sess.triangle_count())
    pass_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lcc = sess.local_clustering()
    mean_lcc = float(lcc.mean())
    lcc_s = time.perf_counter() - t0
    launches = dict(fused_expr.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    words = sess.sketch.data.shape[1]
    chunks = math.ceil(g.m / sess.plan.edge_chunk)
    print(f"  session: words={words} sketch={sess.stats()['sketch_bytes']} "
          f"bytes build {build_s:.3f} s; pass (TC) {pass_s:.3f} s; "
          f"LCC {lcc_s:.3f} s; edge_chunk={sess.plan.edge_chunk} "
          f"degree_order={sess.plan.degree_order}", flush=True)
    print(f"  TC={tc:.6g} mean LCC={mean_lcc:.6g} launches={launches} "
          f"peak device memory {peak} bytes", flush=True)
    require(sess.plan.use_kernel, "the main path must use the kernels")
    require(launches["fused_gather_popcount"] == chunks,
            f"gather kernel launched {launches['fused_gather_popcount']} "
            f"times, expected one per chunk ({chunks})")
    require(math.isfinite(tc) and tc > 0, f"TC {tc} not finite and positive")
    require(lcc.shape == (g.n,) and bool(torch.isfinite(lcc).all()),
            "LCC must be finite float32[n]")
    require(bool((lcc >= 0).all()), "LCC must be non-negative")

    # the runs below launch kernels too; they are not counted
    t0 = time.perf_counter()
    float(TE.MiningSession(g, sess.sketch, sess.plan).triangle_count())
    warm_pass_s = time.perf_counter() - t0
    print(f"  warm pass (TC, second session over the same sketch) "
          f"{warm_pass_s:.3f} s = {g.m / warm_pass_s:.4g} edges/s", flush=True)
    plain_plan = sess.plan.with_(use_kernel=False)
    sample = torch.from_numpy(np.random.default_rng(0).choice(
        g.m, size=min(g.m, 1_000_000), replace=False)).to("cuda")
    edges = g.edges[sample]
    got = TE.tuple_cardinality_ones(sess.sketch, edges, sess.plan)
    want = TE.tuple_cardinality_ones(sess.sketch, edges, plain_plan)
    require(torch.equal(got, want),
            f"per-edge popcounts: {int((got != want).sum())} of "
            f"{edges.shape[0]} sampled edges differ from the plain path")
    t0 = time.perf_counter()
    tc_plain = float(TE.MiningSession(g, sess.sketch,
                                      plain_plan).triangle_count())
    plain_pass_s = time.perf_counter() - t0
    require(math.isclose(tc, tc_plain, rel_tol=1e-4),
            f"TC {tc} vs plain-path TC {tc_plain}")
    print(f"  {edges.shape[0]}-edge popcount sample equal to the plain "
          f"path; plain-path "
          f"TC={tc_plain:.6g} (pass {plain_pass_s:.3f} s)", flush=True)
    return g, sess, dict(launches=launches, chunks=chunks, n=g.n, m=g.m,
                gen_s=gen_s, build_s=build_s, pass_s=pass_s, lcc_s=lcc_s,
                warm_pass_s=warm_pass_s,
                plain_pass_s=plain_pass_s, tc=tc, mean_lcc=mean_lcc,
                peak_bytes=peak, words=words)


def phase_breakdown(torch, TE, sketches, g, sess, warm_pass_s, build_s):
    """Phase 4: where the time goes. A warm pass (TC + LCC) and a sketch
    build run under torch.profiler; device busy time is the sum of their
    kernels' device time, and the idle share is taken against the
    unprofiled wall time of phase 3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(label, fn, wall_s):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
        print(f"phase 4: {label}: device busy {busy_s * 1e3:.3f} ms of "
              f"{wall_s * 1e3:.1f} ms wall (unprofiled), idle share "
              f"{max(0.0, 1 - busy_s / wall_s):.1%}; top kernels:", flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
                  f"{e.key[:100]}", flush=True)
        return busy_s

    def warm_pass():
        again = TE.MiningSession(g, sess.sketch, sess.plan)
        float(again.triangle_count())
        again.local_clustering()

    pass_busy = run("warm TC pass + LCC", warm_pass, warm_pass_s)
    build_busy = run("sketch build", lambda: sketches.build(
        g, "bf", storage_budget=1.0), build_s)
    return pass_busy, build_busy


def phase_reference(torch, np, TE, TG, sketches):
    """Phase 5: a small graph against an independent numpy estimator."""
    g = TG.kronecker(12, 16, seed=1, device="cuda")
    sess = TE.session(g, "bf", storage_budget=0.25, device="cuda")
    words = sess.sketch.data.shape[1]
    bloom = sketches.build_bloom_np(g, words, 2, 0)
    require(np.array_equal(sess.sketch.data.cpu().numpy().view(np.uint32),
                           bloom), "sketch words differ from build_bloom_np")
    e = g.edges.cpu().numpy()
    anded = (bloom[e[:, 0]] & bloom[e[:, 1]]).view(np.uint8)
    ones = np.unpackbits(anded, axis=1).sum(axis=1).astype(np.float64)
    bits = words * 32
    est = -(bits / 2) * np.log1p(-np.minimum(ones, bits - 1) / bits)
    tc_ref = est.sum() / 3
    tv = np.zeros(g.n)
    np.add.at(tv, e[:, 0], est)
    np.add.at(tv, e[:, 1], est)
    d = g.deg.cpu().numpy().astype(np.float64)
    lcc_ref = tv / np.maximum(d * (d - 1), 1)
    tc = float(sess.triangle_count())
    lcc = sess.local_clustering().cpu().numpy()
    require(math.isclose(tc, tc_ref, rel_tol=1e-4),
            f"scale-12 TC {tc} vs numpy {tc_ref}")
    require(np.allclose(lcc, lcc_ref, rtol=1e-4, atol=1e-5),
            "scale-12 LCC differs from numpy")
    a = torch.zeros((g.n, g.n), dtype=torch.float64, device="cuda")
    a[g.edges[:, 0].long(), g.edges[:, 1].long()] = 1
    a[g.edges[:, 1].long(), g.edges[:, 0].long()] = 1
    exact = float(torch.trace(a @ a @ a)) / 6
    print(f"phase 5: scale 12 TC={tc:.6g} numpy={tc_ref:.6g} exact={exact:.0f} "
          f"(estimate rel err {abs(tc - exact) / exact:.4f})", flush=True)


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"no port sources under {SRC}: run chip_smoke.py "
                         "from the root of a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import engine as TE
    from repro_torch.core import graph as TG
    from repro_torch.core import sketches
    from repro_torch.engine import setexpr
    from repro_torch.kernels import _build, fused_expr, ref

    t_start = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built in "
          f"{build_s:.2f} s: {', '.join(p.name for p in libs.values())}",
          flush=True)
    for name in libs:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    timing = phase_kernels(torch, setexpr, fused_expr, ref)
    g, sess, main_path = phase_main(torch, np, TE, TG, fused_expr, SCALE)
    phase_breakdown(torch, TE, sketches, g, sess, main_path["warm_pass_s"],
                    main_path["build_s"])
    del g, sess
    phase_reference(torch, np, TE, TG, sketches)

    print(f"main path: scale {SCALE} n={main_path['n']} "
          f"m={main_path['m']} words={main_path['words']} "
          f"build {main_path['build_s']:.3f} s pass {main_path['pass_s']:.3f} s "
          f"gather launches {main_path['launches']['fused_gather_popcount']}; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    source = "src/repro_torch/kernels/csrc/fused_expr.cu"
    replaces = {"fused_gather_popcount": "src/repro/kernels/fused_expr.py:79",
                "fused_rows_popcount": "src/repro/kernels/fused_expr.py:129"}
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces[name],
        "launches": main_path["launches"][name],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    } for name, t in timing.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
