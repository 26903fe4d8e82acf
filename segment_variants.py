#!/usr/bin/env python3
"""Time variants of the popcount kernels in fused_expr.cu on one GPU.

    python3 segment_variants.py            # from the root of a checkout
    python3 segment_variants.py --scale21  # also the scale-21 AND3 launch
    python3 segment_variants.py --tile [--parent DIR] [--graph-cache F]

Each variant is ``src/repro_torch/kernels/csrc/fused_expr.cu`` with one
tuning constant changed; all are built with the repository's nvcc flags,
in parallel, into ``build/segment_variants/``. Every variant must equal
the plain version on every input; then each is timed twice (CUDA events,
L2 flushed before each launch, the variants in one order and then in the
reverse order). Prints the card's name and power limit, each variant's
registers and spills as ptxas reports them, and a table of mean times in
ms. Exits non-zero on a build failure or a wrong popcount.

Default mode, the segmented kernel (warps per block, tuple steps per
batch of row loads, a minimum of resident blocks that caps registers).
The inputs are the first launches of the Bloom clique passes that
``chip_smoke.py`` times: the AND3 and AND4 launches of ``kronecker(16,
16, seed=1)`` and, with ``--scale21``, the AND3 launch of
``kronecker(21, 16, seed=1)``, all at storage budget 1.0; the [T, k]
gather kernel is timed beside them on the same tuples.

``--tile``, the [T, k] gather and dense kernel (tuples per warp, steps
per batch of row loads, warps per block); ``--parent DIR`` adds the
kernels of the checkout at DIR as a variant. The inputs: a TC pass chunk
of 65,536 random tuples over a 2^21-row, 32-word sketch (gather AND2 and
AND3; dense AND2 and AND3 on the rows pre-gathered), and two real chunks
of the scale-21 Bloom TC pass in hub order, its first and its median
(``chip_smoke.hub_chunks``), timed also warm (no flush). Last, the base
and the parent on the random AND2 chunk with L2 flushed by a 2 GiB read
instead of a write. ``--graph-cache F`` loads the scale-21 graph from F,
or writes it there (as ``minhash_passes.py`` does).
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

#: variant name -> the (text in the source, its replacement) pairs that
#: make it; "base" is the source as committed
VARIANTS = {
    "base": (),
    "warps8": (("constexpr int kSegWarps = 4;",
                "constexpr int kSegWarps = 8;"),),
    "batch2": (("constexpr int kSegBatch = 4;",
                "constexpr int kSegBatch = 2;"),),
    "batch8": (("constexpr int kSegBatch = 4;",
                "constexpr int kSegBatch = 8;"),),
    "minblocks12": (("__launch_bounds__(kSegWarps * 32)\nsegment_popcount",
                     "__launch_bounds__(kSegWarps * 32, 12)\n"
                     "segment_popcount"),),
}

def _tile(name: str, value) -> tuple:
    """The change that sets the [T, k] kernels' constant ``name``."""
    committed = {"kTileTuples": 16, "kTileBatch": 2, "kTileWarps": 4}[name]
    return (f"constexpr int {name} = {committed};",
            f"constexpr int {name} = {value};")


#: the same for the [T, k] kernels (``--tile``)
TILE_VARIANTS = {
    "base": (),
    "tile32": (_tile("kTileTuples", 32),),
    "tile8": (_tile("kTileTuples", 8),),
    "batch1": (_tile("kTileBatch", 1),),
    "batch4": (_tile("kTileBatch", 4),),
    "warps8": (_tile("kTileWarps", 8),),
}

#: kernels whose registers and spills the --tile summary prints (demangled
#: names): the new kernel's 16-byte instantiations and the parent's
TILE_SUMMARY = {"tile_popcount_kernel<GatherSrc, 2, 4>": "gather AND2",
                "tile_popcount_kernel<GatherSrc, 3, 4>": "gather AND3",
                "tile_popcount_kernel<GatherSrc, 0, 4>": "gather program",
                "tile_popcount_kernel<RowsSrc, 2, 4>": "rows AND2",
                "tile_popcount_kernel<RowsSrc, 0, 4>": "rows program",
                "gather_popcount_kernel<2>": "gather AND2",
                "gather_popcount_kernel<0>": "gather program",
                "rows_popcount_kernel<2>": "rows AND2",
                "rows_popcount_kernel<0>": "rows program"}


def build(nvcc: str, flags, variants: dict, parent=None) -> dict:
    """Compile every variant at once (and, with ``parent``, that checkout's
    source as "parent"); returns name -> (loaded library, ptxas log)."""
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, changes in variants.items():
        src = text
        for old, new in changes:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not found in the "
                                 "source")
            src = src.replace(old, new)
        sources[name] = src
    if parent:
        sources["parent"] = (Path(parent) / SOURCE.relative_to(ROOT)
                             ).read_text()
    procs = {}
    for name, src in sources.items():
        path = OUT / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(OUT / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        libs[name] = (ctypes.CDLL(str(OUT / f"{name}.so")), log)
    return libs


def segment_entries(libs: dict) -> dict:
    """name -> the segmented kernel's entry point, with its signature."""
    entries = {}
    for name, (lib, log) in libs.items():
        print(f"{name}: {ptxas_summary(log)}", flush=True)
        fn = lib.pg_fused_segment_popcount
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


def tile_summary(log: str) -> str:
    """Registers and spill bytes of the kernels in ``TILE_SUMMARY``."""
    import chip_smoke as cs

    parts = []
    for e in cs.ptxas_kernels(log):
        label = next((lab for key, lab in TILE_SUMMARY.items()
                      if key in e["kernel"]), None)
        if label:
            parts.append(f"{label}: {e['registers']} registers, "
                         f"{e['spill_stores']} B spilled")
    return "; ".join(parts)


def segment_main(args, torch, cs) -> None:
    """Default mode: the segmented kernel's variants on clique launches."""
    from repro_torch import engine as TE
    from repro_torch.core import graph as TG
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import _build, fused_expr, program, ref

    entries = segment_entries(build(_build.find_nvcc(), _build.NVCC_FLAGS,
                                    VARIANTS))
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


def tile_main(args, torch, cs) -> None:
    """``--tile``: the [T, k] kernels' variants on a random TC chunk and
    on two real chunks of the scale-21 Bloom TC pass."""
    import minhash_passes
    from repro_torch import engine as TE
    from repro_torch.core import graph as TG
    from repro_torch.kernels import _build, program, ref
    from repro_torch.kernels.program import MAX_LEAVES

    V = ctypes.c_void_p
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS, TILE_VARIANTS,
                 args.parent)
    for name, (lib, log) in libs.items():
        print(f"{name}: {tile_summary(log)}", flush=True)
        lib.pg_fused_gather_popcount.argtypes = [
            V, ctypes.c_longlong, ctypes.c_int, V, ctypes.c_longlong,
            ctypes.c_int, V, V, V]
        lib.pg_fused_rows_popcount.argtypes = [
            V, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, V, V, V]
    stream = torch.cuda.current_stream().cuda_stream

    def gather(lib, data, tuples, packed):
        out = torch.empty(tuples.shape[0], dtype=torch.int32, device="cuda")
        rc = lib.pg_fused_gather_popcount(
            data.data_ptr(), data.shape[0], data.shape[1], tuples.data_ptr(),
            tuples.shape[0], tuples.shape[1], ctypes.addressof(packed),
            out.data_ptr(), stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return out

    def rows(lib, operands, packed, ptrs):
        out = torch.empty(operands[0].shape[0], dtype=torch.int32,
                          device="cuda")
        rc = lib.pg_fused_rows_popcount(
            ctypes.addressof(ptrs), len(operands), operands[0].shape[0],
            operands[0].shape[1], ctypes.addressof(packed), out.data_ptr(),
            stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    n21, W, T = 1 << 21, 32, 65_536
    data = torch.randint(-2**31, 2**31 - 1, (n21, W), dtype=torch.int32,
                         device="cuda", generator=gen)
    tuples = torch.randint(0, n21, (T, 3), dtype=torch.int32, device="cuda",
                           generator=gen)
    cases = []                 # (label, call(lib), plain result, warm too)
    for k in (2, 3):
        prog = program.and_program(k)
        packed = prog.packed()
        tup = tuples[:, :k].contiguous()
        operands = [ref.gather_rows(data, tup[:, j]) for j in range(k)]
        ptrs = (V * MAX_LEAVES)(*[o.data_ptr() for o in operands])
        cases.append((f"random chunk, gather AND{k}",
                      lambda lib, tup=tup, packed=packed:
                      gather(lib, data, tup, packed),
                      ref.fused_gather_popcount(data, tup, prog), False))
        cases.append((f"random chunk, rows AND{k}",
                      lambda lib, o=operands, packed=packed, ptrs=ptrs:
                      rows(lib, o, packed, ptrs),
                      ref.fused_rows_popcount(operands, prog), False))
    g = minhash_passes.load_graph(torch, TG, 21, args.graph_cache)
    sess = TE.session(g, "bf", storage_budget=1.0, device="cuda")
    prog2 = program.and_program(2)
    packed2 = prog2.packed()
    bloom = sess.sketch.data
    for label, pairs in cs.hub_chunks(g, sess.plan).items():
        rows_read = int(torch.unique(pairs).numel())
        cases.append((f"scale-21 TC {label} ({rows_read} rows), gather AND2",
                      lambda lib, pairs=pairs: gather(lib, bloom, pairs,
                                                      packed2),
                      ref.fused_gather_popcount(bloom, pairs, prog2), True))
    flush, hold = cs.make_flush(torch), cs.make_hold(torch)
    print("case | " + " | ".join(libs) + " (ms)", flush=True)
    for label, call, want, warm in cases:
        for name, (lib, _) in libs.items():
            if not torch.equal(call(lib), want):
                raise SystemExit(f"{name} differs from the plain version on "
                                 f"{label}")
        for how, wait in (("L2 flushed", flush),) + (
                (("warm", hold),) if warm else ()):
            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    times[name].append(cs.time_ms(
                        lambda: call(libs[name][0]), wait, reps=20))
            print(f"{label}, {how} | " + " | ".join(
                f"{sum(t) / len(t):.4f}" for t in times.values()), flush=True)
    # the flush writes 2 GiB, so L2 is left full of dirty lines that the
    # timed kernel's misses write back; a flush that reads leaves it clean
    clean = torch.ones(1 << 29, dtype=torch.int32, device="cuda")
    for label, call, _, _ in cases[:2]:
        times = {name: cs.time_ms(lambda: call(libs[name][0]),
                                  lambda: clean.sum(), reps=20)
                 for name in ("base", "parent") if name in libs}
        print(f"{label}, L2 flushed by a 2 GiB read | " + " | ".join(
            f"{name} {t:.4f}" for name, t in times.items()), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale21", action="store_true",
                        help="also time the scale-21 AND3 launch (the host "
                             "spends about two minutes generating it)")
    parser.add_argument("--tile", action="store_true",
                        help="time the [T, k] kernels' variants instead")
    parser.add_argument("--parent", default=None,
                        help="with --tile: root of an older checkout whose "
                             "[T, k] kernels are timed beside these")
    parser.add_argument("--graph-cache", default=None,
                        help="with --tile: file the scale-21 graph is "
                             "loaded from, or saved to")
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

    print(cs.smi_line(), flush=True)
    (tile_main if args.tile else segment_main)(args, torch, cs)


if __name__ == "__main__":
    main()
