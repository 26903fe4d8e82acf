#!/usr/bin/env python3
"""Time the float32 flash-attention kernel beside an older checkout's, on
one GPU.

    python3 attention_fp32.py                 # from the root of a checkout
    python3 attention_fp32.py --parent DIR    # also the checkout at DIR's

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this
checkout ("change") and, with ``--parent``, of the checkout at DIR
("parent") with the repository's nvcc flags, in parallel, into
``build/attention_fp32/``; both export the C entry point
``pg_flash_attention``. At each of ``chip_smoke.fp32_attention_shapes``
(inputs drawn from a seeded generator, contiguous [B, S, H, D]) each
kernel is first held to the plain version (``kernels/ref.py``
``causal_attention``, atol = rtol = 2e-5), then timed in turns parent,
change, change, parent (CUDA events, L2 flushed before each launch, 10
launches a turn after half a second of the same launches, the SM clock
sampled during each turn); the plain version and
``scaled_dot_product_attention`` are timed once. Prints the card's name
and power limit, each library's ptxas lines, a line per shape and, last,
one JSON object. Exits non-zero on a build failure or a wrong result.

``--diagnose`` then times, at the timing shape (the first cell), what
bounds the change: the change with the shared loads of its Q·K^T loop,
of its P·V loop or of both made loop-invariant (the compiler hoists them:
the loops then run on registers alone), and with both loops run twice per
tile, with and without their loads (``DIAGNOSTICS``; the results are
wrong and only timed), in turns forward and back. Beside them two
microbenchmarks: the FFMA rate of a register-only outer product (8x8 and
4x4 per thread, 384 threads, one block per SM) and the shared-memory
cycles of one warp-wide LDS.128 by how many distinct 16-byte addresses
each quarter-warp reads (``LDS_PATTERNS``), at the SM clock sampled
during them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "attention_fp32"

_S_LOADS = [("lds<4>(Kst + (s_kg + KG * j) * KS + 4 * d4, kf[j]);",
             "lds<4>(Kst + (s_kg + KG * j) * KS, kf[j]);"),
            ("lds<4>(Qt + (4 * d4 + dd) * QS + s_row, qa);",
             "lds<4>(Qt + dd * QS + s_row, qa);")]
_PV_LOADS = [("lds<4>(Pw + j * PW + 8 * o_rg, pr);",
              "lds<4>(Pw + 8 * o_rg, pr);"),
             ("lds<4>(Pw + j * PW + 8 * o_rg + 4, pr + 4);",
              "lds<4>(Pw + 8 * o_rg + 4, pr + 4);"),
             ("lds<CV>(Vst + j * VS + (DP / NCS) * b + CV * o_cg, vv + CV * b);",
              "lds<CV>(Vst + (DP / NCS) * b + CV * o_cg, vv + CV * b);")]
_TWICE = [("#pragma unroll 8\n    for (int d4 = 0;",
           "for (int rep = 0; rep < 2; ++rep)\n#pragma unroll 8\n"
           "    for (int d4 = 0;"),
          ("#pragma unroll 8\n    for (int j = 0; j < BKV; ++j) {",
           "for (int rep = 0; rep < 2; ++rep)\n#pragma unroll 8\n"
           "    for (int j = 0; j < BKV; ++j) {")]
#: diagnostic variant -> the (text in the change's source, its
#: replacement) pairs it makes
DIAGNOSTICS = {"no Q·K^T loads": _S_LOADS, "no P·V loads": _PV_LOADS,
               "no loads": _S_LOADS + _PV_LOADS, "loops twice": _TWICE,
               "loops twice, no loads": _S_LOADS + _PV_LOADS + _TWICE}
#: LDS.128 microbenchmark: pattern -> the float4 index of lane l
LDS_PATTERNS = {"32 distinct": "l", "8 distinct, the same in each quarter":
                "l & 7", "4 distinct a quarter": "l & 3",
                "2 distinct a quarter": "(l >> 2) & 1",
                "1 a quarter, 4 in the warp": "l >> 3", "1 in the warp": "0"}
_MICRO = r"""
#include <cuda_runtime.h>
template <int RI, int RJ>
__global__ void __launch_bounds__(384, 1) ffma(float* out, int iters) {
  float a[RI], b[RJ], c[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) a[i] = 1e-3f * (threadIdx.x + i);
#pragma unroll
  for (int j = 0; j < RJ; ++j) b[j] = 1e-3f * (threadIdx.x - j);
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) c[i][j] = 0.f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s += c[i][j];
  if (s == 1.2345f) out[threadIdx.x] = s;
}
template <int P>
__global__ void lds128(float* out, int iters) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int l = threadIdx.x & 31;
  const int idx = %(patterns)s;
  const float4* p = buf + idx;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float4 v = p[(((it & 1) * 16 + u) & 31) * 32];
      s0 += v.x; s1 += v.y; s2 += v.z; s3 += v.w;
    }
  if (s0 + s1 + s2 + s3 == 1.2345f) out[threadIdx.x] = s0;
}
extern "C" int run(int which, float* out, int sms, int iters) {
  if (which == 0) ffma<8, 8><<<sms, 384>>>(out, iters);
  else if (which == 1) ffma<4, 4><<<sms, 384>>>(out, 4 * iters);
%(launches)s
  return (int)cudaGetLastError();
}
"""


def build(nvcc: str, flags, sources: dict, prefix: str = "") -> dict:
    """Compile name -> source file, all at once, into ``prefix<i>.so``;
    returns name -> (the loaded entry point, nvcc's output)."""
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {name: OUT / f"{prefix}{i}.so" for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [nvcc, *flags, "-o", str(libs[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(libs[name])).pg_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        built[name] = (fn, log)
    return built


def attend(torch, fn, q, k, v, window, out):
    """One launch of a library's ``pg_flash_attention`` on [B, S, H, D]
    tensors, as the port's wrapper makes it."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    arr = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(2), q.stride(1), k.stride(0), k.stride(2),
        k.stride(1), v.stride(0), v.stride(2), v.stride(1), out.stride(0),
        out.stride(2), out.stride(1))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            sq, k.shape[1], d, h, kvh, h // kvh, window, 1.0 / math.sqrt(d),
            ctypes.addressof(arr), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"pg_flash_attention failed: error {rc}")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None,
                        help="root of an older checkout whose kernel is "
                             "timed beside this one")
    parser.add_argument("--diagnose", action="store_true",
                        help="also time the change's diagnostic variants "
                             "and the FFMA and LDS.128 microbenchmarks")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_fp32.py needs an NVIDIA GPU")
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    print(cs.smi_line(), flush=True)
    sources = {"change": ROOT / CSRC}
    if args.parent:
        sources["parent"] = Path(args.parent) / CSRC
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS, sources)
    for name, (_, log) in libs.items():
        lines = [x.strip() for x in log.splitlines()
                 if "Used" in x or "spill" in x]
        print(f"{name} ptxas: " + " | ".join(lines), flush=True)
    order = (["parent", "change", "change", "parent"] if args.parent
             else ["change", "change"])
    flush = cs.make_flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(26)
    cells = {}
    for shape, (b, sq, h, kv, d, window) in cs.fp32_attention_shapes(
            ).items():
        q = torch.randn((b, sq, h, d), device="cuda", generator=gen)
        k, v = (torch.randn((b, sq, kv, d), device="cuda", generator=gen)
                for _ in range(2))
        want = ref.causal_attention(q, k, v, window)
        out = torch.empty_like(q)
        for name, (fn, _) in libs.items():
            got = attend(torch, fn, q, k, v, window, out)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            cs.require(torch.allclose(got, want, atol=2e-5, rtol=2e-5),
                       f"{name} at {shape}: max |kernel - plain| {err}")
        del want
        turns = {name: [] for name in libs}
        for name in order:
            fn = libs[name][0]

            def call(fn=fn):
                return attend(torch, fn, q, k, v, window, out)
            ms, mhz, _ = cs.sm_clocks(
                torch, call, lambda: cs.time_ms(call, flush, reps=10,
                                                warmup=1))
            turns[name].append((ms, mhz))
        plain = cs.time_ms(lambda: ref.causal_attention(q, k, v, window),
                           flush, reps=3, warmup=1)
        try:
            library = cs.time_ms(cs.library_attention(torch, q, k, v, window),
                                 flush, reps=3, warmup=1)
        except (RuntimeError, ValueError):
            library = None
        flops = 4 * b * h * d * cs.attended_pairs(sq, window)
        bound, by = cs.bound_ms(4 * (2 * b * sq * h * d + 2 * b * sq * kv * d),
                                flops, cs.PEAK_FP32_FLOPS)
        cell = dict(shape=dict(b=b, s=sq, h=h, kv=kv, d=d, window=window),
                    bound_ms=bound, bound_by=by, plain_ms=plain,
                    library_ms=library)
        for name, runs in turns.items():
            mean = sum(ms for ms, _ in runs) / len(runs)
            cell[name] = dict(ms=[ms for ms, _ in runs], mean_ms=mean,
                              sm_mhz=[mhz for _, mhz in runs],
                              share=bound / mean)
        cells[shape] = cell
        ratio = ""
        if "parent" in cell:
            ratio = (f"; parent / change "
                     f"{cell['parent']['mean_ms'] / cell['change']['mean_ms']:.3f}")
        print(f"{shape} (B={b} S={sq} H={h} KV={kv} D={d} window={window}): "
              + "; ".join(f"{name} {c['mean_ms']:.4f} ms (turns "
                          f"{', '.join(f'{x:.4f}' for x in c['ms'])}; SM "
                          f"{c['sm_mhz']} MHz) {c['share']:.2%} of bound"
                          for name, c in ((n, cell[n]) for n in libs))
              + f"{ratio}; bound {bound:.4f} ms by {by}; plain {plain:.3f} "
              f"ms; scaled_dot_product_attention "
              f"{'null' if library is None else f'{library:.3f} ms'}",
              flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    report = {"card": cs.smi_line(), "cells": cells}
    if args.diagnose:
        report["diagnose"] = diagnose(torch, cs, _build, flush)
    print(json.dumps(report))


def diagnose(torch, cs, _build, flush) -> dict:
    """``--diagnose``: the variants of DIAGNOSTICS at the timing shape and
    the two microbenchmarks; returns their times."""
    text = (ROOT / CSRC).read_text()
    sources = {"change": ROOT / CSRC}
    for name, changes in DIAGNOSTICS.items():
        src = text
        for old, new in changes:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not found")
            src = src.replace(old, new)
        sources[name] = OUT / f"diagnose{len(sources)}.cu"
        OUT.mkdir(parents=True, exist_ok=True)
        sources[name].write_text(src)
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS, sources, "diagnose")
    b, sq, h, kv, d, window = next(iter(cs.fp32_attention_shapes().values()))
    gen = torch.Generator(device="cuda").manual_seed(26)
    q = torch.randn((b, sq, h, d), device="cuda", generator=gen)
    k, v = (torch.randn((b, sq, kv, d), device="cuda", generator=gen)
            for _ in range(2))
    out = torch.empty_like(q)
    turns = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        fn = libs[name][0]
        turns[name].append(cs.time_ms(
            lambda: attend(torch, fn, q, k, v, window, out), flush, reps=10,
            warmup=2))
    result = {"variants_ms": {n: sum(t) / len(t) for n, t in turns.items()}}
    print("diagnose at the timing shape (ms, mean of two turns): " + "; ".join(
        f"{n} {t:.4f}" for n, t in result["variants_ms"].items()), flush=True)
    del q, k, v, out

    src = OUT / "micro.cu"
    src.write_text(_MICRO % dict(
        patterns=" : ".join(f"P == {i} ? {e}" for i, e in enumerate(
            LDS_PATTERNS.values())) + " : 0",
        launches="\n".join(f"  else if (which == {i + 2}) lds128<{i}>"
                           f"<<<4 * sms, 256>>>(out, iters);"
                           for i in range(len(LDS_PATTERNS)))))
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(OUT / "micro.so"), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(OUT / "micro.so"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1024, device="cuda")

    def timed(which, iters):
        def call():
            lib.run(which, ctypes.c_void_p(sink.data_ptr()), sms, iters)
        call()
        torch.cuda.synchronize()

        def measure():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop)
        return cs.sm_clocks(torch, call, measure, 0.3)[:2]
    iters = 20000
    for which, tile in ((0, 64), (1, 16)):
        ms, mhz = timed(which, iters)
        flops = 2.0 * sms * 384 * iters * 4 * 64
        result[f"ffma_{tile}_tflops"] = flops / ms / 1e9
        result[f"ffma_{tile}_mhz"] = mhz
        print(f"FFMA, {'8x8' if tile == 64 else '4x4'} register tile a "
              f"thread, 384 threads an SM: {flops / ms / 1e9:.1f} TFLOP/s "
              f"at SM clock {mhz} MHz", flush=True)
    for i, pattern in enumerate(LDS_PATTERNS):
        ms, mhz = timed(i + 2, 4096)
        warp_loads = 4 * 256 / 32 * 4096 * 16  # per SM
        cycles = ms * 1e-3 * mhz * 1e6 / warp_loads
        result[f"lds128_cycles[{pattern}]"] = cycles
        print(f"LDS.128, {pattern}: {cycles:.2f} SM cycles a warp "
              f"instruction (4 blocks of 256 threads an SM, SM clock {mhz} "
              f"MHz)", flush=True)
    return result


if __name__ == "__main__":
    main()
