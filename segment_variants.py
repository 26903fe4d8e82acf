#!/usr/bin/env python3
"""Time variants of the segmented popcount kernel on one GPU.

    python3 segment_variants.py            # from the root of a checkout
    python3 segment_variants.py --scale21  # also the scale-21 AND3 launch

Each variant is ``src/repro_torch/kernels/csrc/fused_expr.cu`` with one
tuning constant changed (warps per block, tuple steps per batch of row
loads, a minimum of resident blocks that caps registers); all are built
with the repository's nvcc flags, in parallel, into
``build/segment_variants/``. The inputs are the first launches of the
Bloom clique passes that ``chip_smoke.py`` times: the AND3 and AND4
launches of ``kronecker(16, 16, seed=1)`` and, with ``--scale21``, the
AND3 launch of ``kronecker(21, 16, seed=1)``, all at storage budget 1.0.
Every variant must equal the plain version on every input; then each is
timed twice (CUDA events, L2 flushed before each launch, the variants in
one order and then in the reverse order) beside the [T, k] gather
kernel on the same tuples. Prints the card's name and power limit, each
variant's registers and spills as ptxas reports them, and a table of
mean times in ms. Exits non-zero on a build failure or a wrong popcount.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "fused_expr.cu"
OUT = ROOT / "build" / "segment_variants"

#: variant name -> (text in the source, its replacement); "base" is the
#: source as committed
VARIANTS = {
    "base": None,
    "warps8": ("constexpr int kSegWarps = 4;", "constexpr int kSegWarps = 8;"),
    "batch2": ("constexpr int kSegBatch = 4;", "constexpr int kSegBatch = 2;"),
    "batch8": ("constexpr int kSegBatch = 4;", "constexpr int kSegBatch = 8;"),
    "minblocks12": ("__launch_bounds__(kSegWarps * 32)\nsegment_popcount",
                    "__launch_bounds__(kSegWarps * 32, 12)\n"
                    "segment_popcount"),
}


def build(nvcc: str, flags) -> dict:
    """Compile every variant at once; returns name -> loaded entry point."""
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, change in VARIANTS.items():
        src = text
        if change is not None:
            if change[0] not in src:
                raise SystemExit(f"variant {name}: {change[0]!r} not found "
                                 "in the source")
            src = src.replace(change[0], change[1])
        path = OUT / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(OUT / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        print(f"{name}: {ptxas_summary(log)}", flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).pg_fused_segment_popcount
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes of the segmented kernel's int64-offset
    instantiations (the clique passes' AND3 and AND4 at W % 4 == 0 and
    W % 4 == 2), as ptxas prints them."""
    parts, current = [], None
    for line in log.splitlines():
        m = re.search(r"segment_popcount_kernelILi(\d)ELi(\d)ExE", line)
        if "Compiling entry" in line:
            current = (f"AND{m.group(1)} V={m.group(2)}"
                       if m and (m.group(1), m.group(2)) in
                       (("3", "4"), ("4", "2")) else None)
        elif current and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif current and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            parts.append(f"{current}: {regs} registers, {spill} B spilled")
            current = None
    return "; ".join(parts)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale21", action="store_true",
                        help="also time the scale-21 AND3 launch (the host "
                             "spends about two minutes generating it)")
    args = parser.parse_args(argv)
    if not SOURCE.exists():
        raise SystemExit("run segment_variants.py from the root of a "
                         "checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("segment_variants.py needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import engine as TE
    from repro_torch.core import graph as TG
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import _build, fused_expr, program, ref

    print(cs.smi_line(), flush=True)
    entries = build(_build.find_nvcc(), _build.NVCC_FLAGS)
    flush = cs.make_flush(torch)
    cases = []
    for scale, ks in ((16, (3, 4)),) + (((21, (3,)),) if args.scale21
                                        else ()):
        g = TG.kronecker(scale, 16, seed=1, device="cuda")
        sketch = TE.session(g, "bf", storage_budget=1.0,
                            device="cuda").sketch
        for k in ks:
            launch = next(cliques.segment_launches(
                *next(cliques.closed_segments(g, sketch, k))))
            cases.append((f"scale {scale} AND{k}", sketch.data, launch))

    def run(fn, data, heads, offsets, tails):
        out = torch.empty(tails.numel(), dtype=torch.int32, device="cuda")
        rc = fn(data.data_ptr(), data.shape[0], data.shape[1],
                heads.data_ptr(), heads.shape[1] + 1, heads.shape[0],
                offsets.data_ptr(), offsets.element_size(), tails.data_ptr(),
                tails.numel(), fused_expr.SEGMENT_CHUNK_TILES,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return out

    print("case | T | segments used | " + " | ".join(entries)
          + " | [T, k] gather (ms)", flush=True)
    for label, data, (heads, offsets, tails) in cases:
        want = ref.fused_segment_popcount(data, heads, offsets, tails)
        for name, fn in entries.items():
            if not torch.equal(run(fn, data, heads, offsets, tails), want):
                raise SystemExit(f"{name} differs from the plain version on "
                                 f"{label}")
        times = {name: [] for name in entries}
        for order in (list(entries), list(entries)[::-1]):
            for name in order:
                times[name].append(cs.time_ms(lambda: run(
                    entries[name], data, heads, offsets, tails), flush,
                    reps=10))
        counts = (offsets[1:] - offsets[:-1]).long()
        tuples = torch.cat([heads.repeat_interleave(counts, 0),
                            tails[:, None]], dim=1).contiguous()
        prog = program.and_program(heads.shape[1] + 1)
        gather = cs.time_ms(lambda: fused_expr.fused_gather_popcount(
            data, tuples, prog), flush, reps=10)
        print(f"{label} | {tails.numel()} | {int((counts > 0).sum())} | "
              + " | ".join(f"{sum(t) / len(t):.4f}" for t in times.values())
              + f" | {gather:.4f}", flush=True)


if __name__ == "__main__":
    main()
