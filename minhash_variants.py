#!/usr/bin/env python3
"""Time variants of the MinHash count kernels on one GPU.

    python3 minhash_variants.py                 # from the root of a checkout
    python3 minhash_variants.py --parent DIR    # also an older checkout's

Each variant is ``src/repro_torch/kernels/csrc/mh_intersect.cu`` with a
tuning constant changed: warp steps per batch of row loads (``kBatch``)
or words of a row per lane (``kLaneWords``). ``--parent DIR`` adds the
rows-form kernels of the checkout at DIR (its ``mh_intersect.cu``) as a
variant. All are built with the repository's nvcc flags, in parallel,
into ``build/minhash_variants/``. The inputs are those ``chip_smoke.py``
times: a TC pass chunk (E = 65,536 pairs of k = 31 rows, pre-gathered
for the rows form, by id from a 2^21-row sketch for the gather form) and
the first launch of the k-Hash 4-clique pass on ``kronecker(16, 16,
seed=1)`` (storage budget 1.0, k = 28). Every variant must equal the
plain version on every input; then each is timed twice (CUDA events, L2
flushed before each launch, the variants in one order and then in the
reverse order), and the old route of the TC pass (two ``index_select``
row copies, then the base variant's rows kernel) beside them; the floor
is one launch of a trivial kernel (zeroing E int32) timed the same way.
Prints the card's name and power limit, each variant's registers and
spills as ptxas reports them, and a table of mean times in ms. Exits
non-zero on a build failure or a wrong count.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = Path("src") / "repro_torch" / "kernels" / "csrc" / "mh_intersect.cu"
OUT = ROOT / "build" / "minhash_variants"

#: variant name -> the (text in the source, its replacement) pairs it
#: makes; "base" is the source as committed
VARIANTS = {
    "base": [],
    "batch2": [("constexpr int kBatch = 1;", "constexpr int kBatch = 2;")],
    "batch4": [("constexpr int kBatch = 1;", "constexpr int kBatch = 4;")],
    "lanes2": [("constexpr int kLaneWords = 4;",
                "constexpr int kLaneWords = 2;")],
    "lanes8": [("constexpr int kLaneWords = 4;",
                "constexpr int kLaneWords = 8;")],
}

_ROWS = ("pg_mh_intersect_pairs", "pg_khash_match_pairs")
_GATHER = ("pg_mh_intersect_gather", "pg_khash_match_gather")


def build(nvcc: str, flags, parent) -> dict:
    """Compile every variant at once; returns name -> loaded library."""
    text = (ROOT / CSRC).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, changes in VARIANTS.items():
        src = text
        for old, new in changes:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not found in the "
                                 "source")
            src = src.replace(old, new)
        sources[name] = src
    if parent:
        sources["parent"] = (Path(parent) / CSRC).read_text()
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
        print(f"{name}: {ptxas_summary(log)}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for entry in _ROWS:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for entry in _GATHER if name != "parent" else ():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


#: kernels whose registers and spills the summary prints: the
#: instantiations the main path runs at k = 31 (group of 8 lanes, 4-byte
#: loads) and k = 28 (16-byte loads), and the parent's kernels
_SUMMARY = {r"mh_kernel.*RowsSrcELi8ELi1E": "mh rows",
            r"mh_kernel.*GatherSrcELi8ELi1E": "mh gather",
            r"khash_kernel.*GatherSrcELi8ELi1E": "khash gather",
            r"khash_kernel.*RowsSrcELi8ELi1E": "khash rows",
            r"khash_kernel.*RowsSrcELi8ELi4E": "khash rows (k=28)",
            r"^_Z\w*mh_intersect_kernel": "mh rows",
            r"^_Z\w*khash_match_kernel": "khash rows"}


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes of the kernels in ``_SUMMARY``, as ptxas
    prints them."""
    parts, current, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = next((label for pat, label in _SUMMARY.items()
                            if re.search(pat, m.group(1))), None)
        elif current and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif current and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            parts.append(f"{current}: {regs} registers, {spill} B spilled")
            current = None
    return "; ".join(parts)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="root of an older checkout whose rows kernels "
                             "are timed beside these")
    args = parser.parse_args(argv)
    if not (ROOT / CSRC).exists():
        raise SystemExit("run minhash_variants.py from the root of a "
                         "checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("minhash_variants.py needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import engine as TE
    from repro_torch.core import graph as TG
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import _build, ref

    print(cs.smi_line(), flush=True)
    libs = build(_build.find_nvcc(), _build.NVCC_FLAGS, args.parent)
    flush = cs.make_flush(torch)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def rows_call(lib, entry, a, b, sentinel):
        out = torch.empty(a.shape[0], dtype=torch.int32, device="cuda")
        rc = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), a.shape[0],
                                 a.shape[1], sentinel, out.data_ptr(),
                                 stream())
        if rc != 0:
            raise SystemExit(f"{entry} launch failed: CUDA error {rc}")
        return out

    def gather_call(lib, entry, data, pairs, sentinel):
        out = torch.empty(pairs.shape[0], dtype=torch.int32, device="cuda")
        rc = getattr(lib, entry)(data.data_ptr(), data.shape[0],
                                 pairs.data_ptr(), pairs.shape[0],
                                 data.shape[1], sentinel, out.data_ptr(),
                                 stream())
        if rc != 0:
            raise SystemExit(f"{entry} launch failed: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(1)
    sentinel, e, k = 150, 65_536, 31
    a, b = cs.minhash_rows(torch, gen, e, k, sentinel)
    data, _ = cs.minhash_rows(torch, gen, 1 << 21, k, sentinel)
    pairs = torch.randint(0, 1 << 21, (e, 2), dtype=torch.int32,
                          device="cuda", generator=gen)
    u, v = pairs[:, 0].long(), pairs[:, 1].long()
    g16 = TG.kronecker(16, 16, seed=1, device="cuda")
    kh = TE.session(g16, "kh", storage_budget=1.0, device="cuda")
    tri = next(cliques.closed_triangles(g16, kh.sketch))
    tri = tri[:cliques._LAUNCH_TUPLES]
    mu, mv = (kh.sketch.data.index_select(0, tri[:, c].long())
              for c in (0, 1))
    cases = []                 # (label, entry, form, operands, sentinel)
    for entry in _ROWS:
        cases.append((f"{entry[3:]} rows, TC chunk", entry, "rows", (a, b),
                      sentinel))
    for entry in _GATHER:
        cases.append((f"{entry[3:]}, TC chunk", entry, "gather",
                      (data, pairs), sentinel))
    cases.append((f"khash_match_pairs rows, k-Hash 4-clique launch (E="
                  f"{mu.shape[0]}, k={mu.shape[1]})", "pg_khash_match_pairs",
                  "rows", (mu, mv), g16.n))

    out = torch.empty(e, dtype=torch.int32, device="cuda")
    floor = cs.time_ms(out.zero_, flush, reps=20)
    print(f"floor (one trivial launch): {floor:.4f} ms", flush=True)
    print("case | " + " | ".join(libs) + " | old route (ms)", flush=True)
    for label, entry, form, ops, sent in cases:
        plain = getattr(ref, entry[3:])(*ops, sent)
        call = rows_call if form == "rows" else gather_call
        names = [n for n in libs if form == "rows" or n != "parent"]
        for name in names:
            if not torch.equal(call(libs[name], entry, *ops, sent), plain):
                raise SystemExit(f"{name} differs from the plain version on "
                                 f"{label}")
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cs.time_ms(lambda: call(
                    libs[name], entry, *ops, sent), flush, reps=20))
        old = "-"
        if form == "gather":
            rows_entry = entry.replace("_gather", "_pairs")
            old_ms = cs.time_ms(lambda: rows_call(
                libs["base"], rows_entry, data.index_select(0, u),
                data.index_select(0, v), sent), flush, reps=20)
            old = f"{old_ms:.4f}"
        print(f"{label} | " + " | ".join(
            f"{sum(times[n]) / 2:.4f}" if n in times else "-"
            for n in libs) + f" | {old}", flush=True)


if __name__ == "__main__":
    main()
