#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ProbGraph on one GPU and check it.

    python3 chip_smoke.py                  # from the root of a checkout

Phases, each printed as it runs:

  1. Environment: the card's name and power limit, torch and CUDA
     versions, and the build of every CUDA kernel from ``src/``.
  2. Kernels against their plain PyTorch versions on the card (integers:
     equality required). The popcount kernels, both [T, k] forms, over
     the programs of ``popcount_programs`` (AND2/AND3/AND4, OR, ANDNOT,
     nested, 8-leaf and permuted-column programs), row widths 1..600
     (every vector width, column blocks), tuple counts at the kernels'
     tile edges and up to ~1M, ids to clamp, operands whose base is
     shifted by 4 bytes, and two-column tuples; the MinHash counts in
     both forms (rows: int32[E, k] rows; gather: the sketch matrix and
     pairs of ids) over k in {1, 4, 7, 24, 28, 31, 32, 33, 128, 256},
     ragged E up to ~1M and 0, with
     all-sentinel rows, negative entries, duplicates, out-of-range and
     negative ids (clamped), and operands whose base is shifted by 4
     bytes. Attention by both routes (bfloat16: the wgmma
     tensor-core kernel; float32: the CUDA-core kernel), head dims
     16..256, MHA/GQA/MQA, windows 0/8/4096, S in {1, 97, 1000, 4096},
     Sq != Skv and rows that see no key. Then each kernel timed at the
     main path's shape beside its bound (the MinHash gather forms also
     beside the old route: two ``index_select`` row copies, then the rows
     kernel); attention at the repo's
     prefill_32k shapes (qwen3_8b, h2o_danube3_4b, gemma_2b; bf16), driven
     once through ``flash_attention`` with its per-route launch counts
     zeroed before and read after, and timed beside the plain version and
     ``scaled_dot_product_attention`` (a yardstick the port never calls,
     whose own error against the plain version is printed too); the
     float32 route driven and timed on its own at ATTN_FP32_SHAPE.
  3. The Bloom path: a scale-21 Kronecker graph (2.1M vertices, 31.8M
     edges), ``session(g, "bf", storage_budget=1.0)`` on the card,
     ``triangle_count()`` and ``local_clustering()``. The launch counts are
     zeroed just before and read just after; per-edge popcounts of a fixed
     1M-edge sample and the TC are held against the plain path on the card.
  3b. The MinHash path on the same graph: ``session(g, "kh", ...)`` with
     TC, LCC, ``jarvis_patrick("jaccard", 0.05)`` and
     ``edge_similarity("jaccard")``, then ``session(g, "1h", ...,
     variant="naive")`` with TC; each with its launch counts (by form:
     only the gather form may run) zeroed just before and read just
     after, its kernel's match counts on the 1M-edge sample (both forms)
     and its TC held against the plain path.
  3d. The AND2 gather on two real chunks of the phase-3 TC pass (the
     first and the median in hub order), checked against the plain
     version and timed with L2 flushed and warm, beside its bound and
     ``khash_match_gather`` on the same pairs over the k-Hash sketch.
  3c. Cliques: ``four_clique_count()`` on the phase-3 Bloom session
     (scale 21; its wedge candidates held to a numpy count from the CSR),
     then on ``kronecker(16, 16, seed=1)`` the Bloom ``five_clique_count()``
     (the AND4 form) and the k-Hash ``four_clique_count()``; each with its
     launch counts zeroed just before and read just after; the Bloom
     passes must launch only the segmented kernel. Kernel-path popcounts
     of sampled triangles and 4-cliques, hub edges included, equal the
     plain path's, through segments and through [T, k] tuples; the k-Hash
     count equals the plain path's. On the first launch of each Bloom pass
     (up to ``_LAUNCH_TUPLES`` survivor tuples over the session's sketch)
     the segmented kernel and the [T, k] gather kernel are checked against
     each other and the plain version and timed in turns, each beside its
     bound; the k-Hash pass must launch only the rows form of
     ``khash_match_pairs``, which is timed on the pass's first launch.
  4. Where the time goes: a warm Bloom pass (and the [T, k] gather
     kernel's time per launch in it), a Bloom sketch build, warm k-Hash
     and 1-Hash-naive passes and the scale-21 4-clique pass under
     torch.profiler (device busy time, idle share, top kernels).
  5. A scale-12 graph against an independent numpy reference of the same
     definitions: Bloom words, k-Hash, 1-Hash and KMV sketches identical;
     TC (and the Bloom LCC) within rtol 1e-4 of the numpy estimators; the
     Bloom 4- and 5-clique estimates within rtol 1e-5 of numpy's, and the
     exact branch's counts equal to 4,032,443 and 26,522,168 (brute
     force).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It also fails at once without a CUDA
device, or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

#: Kronecker scale of the main path: 2^21 vertices, ~31.8M edges
SCALE = 21
#: scale of the 5-clique and k-Hash 4-clique passes (phase 3c)
CLIQUE5_SCALE = 16
#: exact counts of kronecker(12, 16, seed=1), by brute force over sets
EXACT_4CLIQUES_12, EXACT_5CLIQUES_12 = 4_032_443, 26_522_168

#: the repo's prefill_32k attention shapes (src/repro/configs/):
#: name -> (batch, seq, heads, kv heads, head dim, window)
ATTN_SHAPES = {"qwen3_8b": (1, 32768, 32, 8, 128, 0),
               "h2o_danube3_4b": (1, 32768, 32, 8, 120, 4096),
               "gemma_2b": (1, 8192, 8, 1, 256, 0)}
#: the float32 route's timing shape: qwen3_8b's heads at S = 4,096
#: (batch, seq, heads, kv heads, head dim, window)
ATTN_FP32_SHAPE = (1, 4096, 32, 8, 128, 0)
#: bound on the mean |kernel - plain| of a bfloat16 case (see attn_tol)
ATTN_BF16_MEAN = 1e-3

#: why a row's ``library_ms`` is null: no single PyTorch call computes it
NO_LIBRARY = {
    "popcount": "no PyTorch call computes a gather, a bitwise AND tree and "
                "a popcount (torch has no popcount)",
    "minhash": "no PyTorch call computes it: compare, mask and sum are "
               "three calls",
}

#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and the
#: float32 rate outside the tensor cores (an FMA counted as two), flop/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: the INT32 rate, for integer operations (compares, bitwise ops,
#: popcounts, adds): 64 INT32 lanes per SM x 132 SMs x the 1,980 MHz
#: maximum SM clock, ops/s
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9
#: dense bf16 tensor-core rate, flop/s
PEAK_BF16_FLOPS = 989e12


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


def ptxas_kernels(log: str) -> list:
    """Per kernel of an nvcc ``-Xptxas -v`` log: its name (demangled by
    c++filt where the machine has it), registers and spill-store bytes."""
    entries, current, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            entries.append(dict(kernel=current, registers=int(m.group(1)),
                                spill_stores=spill))
            current = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(e["kernel"] for e in entries),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(entries):
        for e, name in zip(entries, names):
            e["kernel"] = name.replace("(anonymous namespace)::", "")
    return entries


def time_ms(fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` with CUDA events.

    ``flush()`` runs before each launch: it evicts L2 (the sketch is larger
    than L2, so its callers find it cold) and keeps the device busy long
    enough that the host has enqueued ``fn``'s launches before the start
    event fires, so the events time the device work and not the host's
    Python in between.
    """
    import torch

    for _ in range(warmup):
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


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_INT32_OPS_S
             ) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, ops / peak rate);
    ``ops`` are integer operations unless another rate is given."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_flush(torch):
    """A flush for :func:`time_ms`: a 2 GiB write evicts L2 and keeps the
    card busy while the host enqueues the timed launches."""
    scratch = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()
    return flush


def popcount_programs(setexpr, program):
    """The programs phase 2 and the card tests hold both popcount forms to:
    name -> Program over tuples of 8 columns. The k-way ANDs run the
    kernels' template; "AND3@4,0,2" is the template reading permuted
    columns; every other program the interpreted path (up to 8 leaves)."""
    r = setexpr.rows(8)
    u, v, w, x = r[:4]
    exprs = {"AND2": u & v, "AND3": u & v & w, "AND4": u & v & w & x,
             "OR": u | v, "ANDNOT": u - v, "nested": (u | (v & w)) - (x | u),
             "AND8": setexpr.and_all(*r),
             "mixed8": ((r[0] & r[1]) | (r[2] & r[3]))
             - ((r[4] | r[5]) & (r[6] | r[7])),
             "permuted": (setexpr.Row(6) | setexpr.Row(1)) - setexpr.Row(4)}
    progs = {k: setexpr.compile_program(e) for k, e in exprs.items()}
    chain = program.and_program(3)
    progs["AND3@4,0,2"] = program.Program(ops=chain.ops, args=chain.args,
                                          slots=(4, 0, 2))
    return progs


def shifted(torch, x):
    """A copy of contiguous ``x`` whose base lies one word past an
    allocation's start (4-byte but not 8- or 16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def phase_kernels(torch, setexpr, fused_expr, ref, flush):
    """Phase 2, popcount kernels: parity on many shapes, then timing of
    each form the main path or a reference kernel uses, at the main path's
    shape."""
    from repro_torch.kernels import program

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    programs = popcount_programs(setexpr, program)
    n = 100_003
    cases = [(W, T) for W in (2, 8, 32, 34) for T in (1, 999, 65_549,
                                                        1_000_003)]
    cases += [(600, T) for T in (1, 999, 70_001)]
    # tile edges, every vector width and column blocks
    cases += [(W, T) for W in (1, 3, 4, 30, 31, 33, 128, 129)
              for T in (1, 31, 32, 33, 65, 4099)]
    checked = 0
    # max |kernel - plain| per form and program
    err = {f"{form}/{name}": 0 for form in ("gather", "rows")
           for name in programs}

    def check(key, got, want, what):
        err[key] = max(err[key], int((got - want).abs().max()))
        require(torch.equal(got, want),
                f"{key} {what}: {int((got != want).sum())} of {want.numel()} "
                "differ from the plain version")

    for W, T in cases:
        data = torch.randint(-2**31, 2**31 - 1, (n, W), dtype=torch.int32,
                             device=dev, generator=gen)
        data[0] = -1                                  # an all-ones row
        # ids in [-3, n + 3): negative and past-the-end ids clamp
        tuples = torch.randint(-3, n + 3, (T, 8), dtype=torch.int32,
                               device=dev, generator=gen)
        tuples[::7, 0] = 0
        pairs = tuples[:, :2].contiguous()            # 8-byte id loads
        for d, how in ((data, ""), (shifted(torch, data), " (shifted)")):
            what = f"W={W} T={T}{how}"
            for name, prog in programs.items():
                want = ref.fused_gather_popcount(d, tuples, prog)
                check(f"gather/{name}",
                      fused_expr.fused_gather_popcount(d, tuples, prog),
                      want, what)
                rows = [ref.gather_rows(d, tuples[:, s]) for s in prog.slots]
                if how:
                    rows[0] = shifted(torch, rows[0])
                check(f"rows/{name}", fused_expr.fused_rows_popcount(
                    rows, prog), want, what)
                checked += 2
            for tp, tw in ((pairs, " [T, 2]"),
                           (shifted(torch, pairs), " [T, 2] shifted")):
                check("gather/AND2", fused_expr.fused_gather_popcount(
                    d, tp, programs["AND2"]), ref.fused_gather_popcount(
                    d, tp, programs["AND2"]), what + tw)
                checked += 1
        del data, tuples, pairs, rows
    torch.cuda.synchronize()
    print(f"phase 2: popcount kernels equal their plain versions on "
          f"{checked} cases ({len(cases)} shapes x {len(programs)} programs "
          f"x 2 forms x aligned and 4-byte shifted operands, and [T, 2] "
          f"ids); max_abs_err {max(err.values())}", flush=True)

    # timing at the main path's shape: scale-21 rows of 32 words, one
    # 65,536-edge chunk; AND2 is the TC pass, AND3 the 4-clique form
    n21, W, T = 1 << 21, 32, 65_536
    data = torch.randint(-2**31, 2**31 - 1, (n21, W), dtype=torch.int32,
                         device=dev, generator=gen)
    tuples = torch.randint(0, n21, (T, 3), dtype=torch.int32, device=dev,
                           generator=gen)
    # row of the table -> (form, program); rows 1-2 are the kernels as PR
    # 11 timed them, rows 3-6 the reference's bf_intersect kernels, which
    # are these same forms
    forms = {"fused_gather_popcount": ("gather", "AND2"),
             "fused_rows_popcount": ("rows", "AND2"),
             "bf_intersect_pairs": ("rows", "AND2"),
             "bf_intersect3_pairs": ("rows", "AND3"),
             "bf_edge_intersect": ("gather", "AND2"),
             "bf_edge_intersect3": ("gather", "AND3")}
    timing = {}
    print(f"  [T, k] kernels' layout at W={W}: {fused_expr.tile_layout(data)}",
          flush=True)
    for name, (form, pname) in forms.items():
        prog = programs[pname]
        k = len(prog.slots)
        tup = tuples[:, :k].contiguous()
        ops = T * W * (k + 1)                 # k-1 ANDs, a popcount, an add
        if form == "gather":
            nbytes = int(torch.unique(tup).numel()) * W * 4 + T * k * 4 + T * 4
            ms = time_ms(lambda: fused_expr.fused_gather_popcount(
                data, tup, prog), flush)
            plain = time_ms(lambda: ref.fused_gather_popcount(data, tup, prog),
                            flush)
        else:
            rows = [data[tup[:, s].long()] for s in prog.slots]
            nbytes = k * T * W * 4 + T * 4
            ms = time_ms(lambda: fused_expr.fused_rows_popcount(rows, prog),
                         flush)
            plain = time_ms(lambda: ref.fused_rows_popcount(rows, prog),
                            flush)
            del rows
        bound, by = bound_ms(nbytes, ops)
        timing[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            bound_by=by, bytes=nbytes, form=f"{form}/{pname}",
                            max_abs_err=err[f"{form}/{pname}"],
                            library_note=NO_LIBRARY["popcount"],
                            timed_at=f"{form} {pname}, T={T} random tuples, "
                                     f"W={W}, {n21} rows (a TC pass chunk)")
        print(f"  {name} ({form}, {pname}): {ms:.4f} ms (plain {plain:.4f} "
              f"ms, bound {bound:.4f} ms by {by}, {nbytes} bytes, "
              f"{bound / ms:.1%} of bound) at T={T} W={W}", flush=True)
    del data, tuples
    torch.cuda.empty_cache()
    return timing


def minhash_rows(torch, gen, e: int, k: int, sentinel: int):
    """Row pairs drawn from [-40, sentinel + 40): negative ids, pads above
    the sentinel and duplicates within rows; b copies about half of a's
    positions (aligned matches), every 13th row of a and of b (offset) is
    all sentinel."""
    a = torch.randint(-40, sentinel + 40, (e, k), dtype=torch.int32,
                      device="cuda", generator=gen)
    b = torch.randint(-40, sentinel + 40, (e, k), dtype=torch.int32,
                      device="cuda", generator=gen)
    b = torch.where(torch.rand((e, k), device="cuda", generator=gen) < 0.5,
                    a, b)
    a[::13] = sentinel
    b[5::13] = sentinel
    return a, b


#: the MinHash counts: rows form (the TPU kernels' signature) -> gather form
MINHASH_FORMS = {"mh_intersect_pairs": "mh_intersect_gather",
                 "khash_match_pairs": "khash_match_gather"}


def phase_minhash_kernels(torch, mh_intersect, ref, flush):
    """Phase 2, MinHash counts, both forms: parity over k and ragged E,
    then timing at the main path's shape (E = 65,536 pairs, k = 31), with
    the old route of the TC pass (two row copies, then the rows kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    sentinel, n = 150, 100_003
    err = {name: 0 for pair in MINHASH_FORMS.items() for name in pair}
    cases = [(k, e) for k in (1, 4, 7, 24, 28, 31, 32, 33)
             for e in (0, 1, 999, 65_537, 1_000_003)]
    cases += [(k, e) for k in (128, 256) for e in (0, 1, 999, 70_001)]
    checked = 0

    def check(name, got, want, what):
        require(got.shape == want.shape and got.dtype == torch.int32,
                f"{name} {what}: output {got.dtype}{list(got.shape)}")
        if got.numel():
            err[name] = max(err[name], int((got - want).abs().max()))
        require(torch.equal(got, want),
                f"{name} {what}: {int((got != want).sum())} pairs differ "
                "from the plain version")

    for k, e in cases:
        a, b = minhash_rows(torch, gen, e, k, sentinel)
        data, _ = minhash_rows(torch, gen, n, k, sentinel)
        # ids in [-3, n + 3): negative and past-the-end ids clamp
        pairs = torch.randint(-3, n + 3, (e, 2), dtype=torch.int32,
                              device="cuda", generator=gen)
        pairs[::7, 1] = pairs[::7, 0]
        for rows_name, gather_name in MINHASH_FORMS.items():
            what = f"k={k} E={e}"
            want = getattr(ref, rows_name)(a, b, sentinel)
            check(rows_name, getattr(mh_intersect, rows_name)(a, b, sentinel),
                  want, what)
            check(rows_name, getattr(mh_intersect, rows_name)(
                shifted(torch, a), b, sentinel), want, what + " (shifted a)")
            want = getattr(ref, gather_name)(data, pairs, sentinel)
            for x, how in ((data, ""), (shifted(torch, data), " (shifted)")):
                check(gather_name, getattr(mh_intersect, gather_name)(
                    x, pairs, sentinel), want, what + how)
            checked += 4
        del a, b, data, pairs
    torch.cuda.synchronize()
    print(f"phase 2: MinHash kernels equal their plain versions on "
          f"{checked} cases ({len(cases)} (k, E) shapes x 2 counts x rows "
          f"and gather forms, each aligned and 4-byte shifted); max_abs_err "
          f"{err}", flush=True)

    e, k = 65_536, 31
    a, b = minhash_rows(torch, gen, e, k, sentinel)
    data, _ = minhash_rows(torch, gen, 1 << 21, k, sentinel)
    pairs = torch.randint(0, 1 << 21, (e, 2), dtype=torch.int32,
                          device="cuda", generator=gen)
    u, v = pairs[:, 0].long(), pairs[:, 1].long()
    timing = {}
    for rows_name, gather_name in MINHASH_FORMS.items():
        ops = e * k * k if rows_name == "mh_intersect_pairs" else e * k
        rows_fn = getattr(mh_intersect, rows_name)
        gather_fn = getattr(mh_intersect, gather_name)
        forms = (
            (rows_name, lambda: rows_fn(a, b, sentinel),
             lambda: getattr(ref, rows_name)(a, b, sentinel),
             2 * e * k * 4 + e * 4, f"E={e} row pairs"),
            (gather_name, lambda: gather_fn(data, pairs, sentinel),
             lambda: getattr(ref, gather_name)(data, pairs, sentinel),
             e * (8 + 2 * k * 4 + 4),
             f"E={e} pairs by id from a {1 << 21}-row sketch"))
        for name, fn, plain_fn, nbytes, shape in forms:
            ms = time_ms(fn, flush)
            plain = time_ms(plain_fn, flush)
            bound, by = bound_ms(nbytes, ops)
            timing[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by, bytes=nbytes,
                                max_abs_err=err[name],
                                library_note=NO_LIBRARY["minhash"],
                                timed_at=f"{shape}, k={k} (a TC pass "
                                         "chunk)")
            extra = ""
            if name == gather_name:
                old = time_ms(lambda: rows_fn(data.index_select(0, u),
                                              data.index_select(0, v),
                                              sentinel), flush)
                timing[name]["old_route_ms"] = old
                extra = (f"; old route (two index_select row copies, then "
                         f"the rows kernel) {old:.4f} ms")
            print(f"  {name}: {ms:.4f} ms (plain {plain:.4f} ms, bound "
                  f"{bound:.4f} ms by {by}, {nbytes} bytes, {ops} compares, "
                  f"{bound / ms:.1%} of bound) at E={e} k={k}{extra}",
                  flush=True)
    del a, b, data, pairs
    return timing


def attended_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention over s positions attends."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def library_attention(torch, q, k, v, window: int):
    """``scaled_dot_product_attention`` on the same inputs (a yardstick
    only: the port never calls it). A window needs a boolean mask, which
    only the memory-efficient backend takes at S = 32K, and that backend
    wants the kv heads expanded (done here, outside the timed call)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    g = q.shape[2] // k.shape[2]
    kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)
    return call


def attn_tol(v, dtype_name: str) -> dict:
    """Kernel vs plain attention. float32: sums in another order, the
    reference's own 2e-5. bfloat16: the tensor-core kernel rounds P to
    bf16 before P·V, which moves an output by at most 2^-9·max|v| (l is
    summed from the fp32 P); twice that covers the accumulation order and
    where the scale is applied, on top of one bf16 rounding of the output
    (atol 1e-3, rtol 1e-2). The mean error stays <= ATTN_BF16_MEAN."""
    if dtype_name == "float32":
        return dict(atol=2e-5, rtol=2e-5)
    return dict(atol=1e-3 + 2.0 ** -8 * float(v.float().abs().max()),
                rtol=1e-2)


def wgmma_build_summary(lib_path) -> str:
    """The tensor-core library's ``-Xptxas -v`` lines (one per (Dp, BKV)
    instantiation: the entry register count and spills) with the role
    budgets the kernel sets with setmaxnreg."""
    import ctypes
    import re

    regs = (ctypes.c_int * 2)()
    ctypes.CDLL(str(lib_path)).pg_flash_wgmma_roles(regs)
    log = (lib_path.parent / "flash_attention_wgmma.log").read_text()
    shapes = re.findall(r"flash_wgmma_kernelILi(\d+)ELi(\d+)E", log)
    used = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    parts = [f"Dp={dp} BKV={bkv}: {u} registers at entry, spill stores/"
             f"loads {st}/{ld} bytes"
             for (dp, bkv), u, (st, ld) in zip(shapes[::2], used, spills)]
    return (f"producer warpgroup setmaxnreg {regs[0]}, consumer warpgroups "
            f"{regs[1]}; " + "; ".join(parts))


def phase_attention(torch, flash_attention, ref, flush, lib_path):
    """Phase 2, attention: both routes against the plain version over
    types, head dims and layouts, then the prefill shapes (bf16, the
    tensor-core route): one counted drive through the entry point, parity,
    and timing; then the float32 route, counted and timed on its own."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    err = {"float32": 0.0, "bfloat16": 0.0}
    mean_err = {"float32": 0.0, "bfloat16": 0.0}
    print(f"  flash_attention_wgmma build: {wgmma_build_summary(lib_path)}",
          flush=True)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def check(got, want, v, what):
        name = str(want.dtype).split(".")[-1]
        diff = (got.float() - want.float()).abs()
        e, mean = float(diff.max()), float(diff.mean())
        err[name] = max(err[name], e)
        mean_err[name] = max(mean_err[name], mean)
        require(got.dtype == want.dtype and got.shape == want.shape
                and torch.allclose(got.float(), want.float(),
                                   **attn_tol(v, name))
                and (name == "float32" or mean <= ATTN_BF16_MEAN),
                f"flash_attention {what}: max |kernel - plain| {e}, mean "
                f"{mean} ({got.dtype}{list(got.shape)})")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 120, 128, 256):
            for h, kv in ((4, 4), (4, 2), (4, 1)):
                for window in (0, 8, 4096):
                    for sq in (1, 97, 1000, 4096):
                        q = randn(1, sq, h, d, dtype=dtype)
                        k, v = (randn(1, sq, kv, d, dtype=dtype)
                                for _ in range(2))
                        check(flash_attention.flash_attention(
                            q, k, v, window=window),
                            ref.causal_attention(q, k, v, window), v,
                            f"{dtype} D={d} H={h} KV={kv} window={window} "
                            f"S={sq}")
                        cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        for sq, skv, window in ((1000, 97, 0), (97, 1000, 0), (1000, 97, 8),
                                (4096, 1, 3)):
            q, k, v = (randn(n, s, 64, dtype=dtype)
                       for n, s in ((8, sq), (2, skv), (2, skv)))
            check(flash_attention.flash_attention_folded(q, k, v, groups=4,
                                                         window=window),
                  ref.flash_attention_folded(q, k, v, groups=4,
                                             window=window), v,
                  f"{dtype} folded Sq={sq} Skv={skv} window={window}")
            cases += 1
    torch.cuda.synchronize()
    print(f"phase 2: flash_attention equals its plain version on {cases} "
          f"cases (float32 atol=rtol=2e-5; bfloat16 atol 1e-3 + "
          f"2^-8·max|v|, rtol 1e-2, mean <= {ATTN_BF16_MEAN}); "
          f"max_abs_err {err}, largest mean_abs_err {mean_err}", flush=True)

    # the entry point at the prefill shapes, once each, counted
    inputs = {}
    for name, (b, sq, h, kv, d, window) in ATTN_SHAPES.items():
        inputs[name] = (randn(b, sq, h, d, dtype=torch.bfloat16),
                        randn(b, sq, kv, d, dtype=torch.bfloat16),
                        randn(b, sq, kv, d, dtype=torch.bfloat16), window)
    flash_attention.reset_launch_counts()
    outs = {name: flash_attention.flash_attention(q, k, v, window=window)
            for name, (q, k, v, window) in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(flash_attention.ROUTE_LAUNCHES)
    require(launches == {"wgmma_bf16": len(ATTN_SHAPES), "fma_fp32": 0},
            f"flash_attention at the prefill shapes launched {launches}, "
            f"expected {len(ATTN_SHAPES)} wgmma_bf16 and no fma_fp32")
    timing = {}
    for name, (q, k, v, window) in inputs.items():
        b, sq, h, kv, d, _ = ATTN_SHAPES[name]
        out = outs.pop(name)
        require(bool(torch.isfinite(out).all()),
                f"flash_attention {name}: non-finite output")
        want = ref.causal_attention(q, k, v, window)
        check(out, want, v, name)
        kernel_err = float((out.float() - want.float()).abs().max())
        flops = 4 * b * h * d * attended_pairs(sq, window)
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sq * kv * d)
        bound, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        ms = time_ms(lambda: flash_attention.flash_attention(
            q, k, v, window=window), flush, reps=5, warmup=1)
        plain = time_ms(lambda: ref.causal_attention(q, k, v, window), flush,
                        reps=2, warmup=1)
        try:
            call = library_attention(torch, q, k, v, window)
            library = time_ms(call, flush, reps=3, warmup=1)
            library_err = float((call().transpose(1, 2).float()
                                 - want.float()).abs().max())
            why = ""
        except (RuntimeError, ValueError) as exc:   # OOM is a RuntimeError
            library, library_err = None, None
            why = f" ({type(exc).__name__}: {exc})"[:300]
        del want
        torch.cuda.empty_cache()
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=library,
                            library_note=why.strip(" ()") or None,
                            bound_ms=bound, bound_by=by, flops=flops,
                            bytes=nbytes, max_abs_err=err["bfloat16"],
                            timed_at=f"{name}: B={b} S={sq} H={h} KV={kv} "
                                     f"D={d} window={window}, bf16")
        lib = "null" + why if library is None else f"{library:.3f} ms"
        print(f"  flash_attention_wgmma {name} (B={b} S={sq} H={h} KV={kv} "
              f"D={d} window={window}, bf16): {ms:.3f} ms (plain "
              f"{plain:.3f} ms, scaled_dot_product_attention {lib}; bound "
              f"{bound:.3f} ms by {by}: {flops:.4g} flop, {nbytes} bytes; "
              f"{bound / ms:.2%} of bound, {flops / ms / 1e9:.1f} TFLOP/s); "
              f"max |kernel - plain| {kernel_err:.4g}, max |SDPA - plain| "
              f"{library_err if library_err is None else f'{library_err:.4g}'}",
              flush=True)
    del inputs, outs

    # the float32 route on its own path: one counted call, then timed
    b, sq, h, kv, d, window = ATTN_FP32_SHAPE
    q = randn(b, sq, h, d)
    k, v = randn(b, sq, kv, d), randn(b, sq, kv, d)
    flash_attention.reset_launch_counts()
    out = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    fp32_launches = dict(flash_attention.ROUTE_LAUNCHES)
    require(fp32_launches == {"wgmma_bf16": 0, "fma_fp32": 1},
            f"flash_attention on float32 launched {fp32_launches}")
    check(out, ref.causal_attention(q, k, v, window), v, "float32 timing shape")
    flops = 4 * b * h * d * attended_pairs(sq, window)
    nbytes = 4 * (2 * b * sq * h * d + 2 * b * sq * kv * d)
    bound, by = bound_ms(nbytes, flops, PEAK_FP32_FLOPS)
    ms = time_ms(lambda: flash_attention.flash_attention(
        q, k, v, window=window), flush, reps=5, warmup=1)
    plain = time_ms(lambda: ref.causal_attention(q, k, v, window), flush,
                    reps=3, warmup=1)
    try:
        library = time_ms(library_attention(torch, q, k, v, window), flush,
                          reps=3, warmup=1)
        why = ""
    except (RuntimeError, ValueError) as exc:
        library, why = None, f" ({type(exc).__name__}: {exc})"[:300]
    timing["fp32"] = dict(ms=ms, plain_ms=plain, library_ms=library,
                          library_note=why.strip(" ()") or None,
                          bound_ms=bound, bound_by=by,
                          max_abs_err=err["float32"],
                          timed_at=f"B={b} S={sq} H={h} KV={kv} D={d} "
                                   f"window={window}, float32 (no prefill "
                                   f"shape is float32)")
    lib = "null" + why if library is None else f"{library:.3f} ms"
    print(f"  flash_attention fp32 (B={b} S={sq} H={h} KV={kv} D={d}, "
          f"float32): {ms:.3f} ms (plain {plain:.3f} ms, "
          f"scaled_dot_product_attention {lib}; bound {bound:.3f} ms by {by} "
          f"at 67 TFLOP/s fp32; {bound / ms:.2%} of bound)", flush=True)
    return timing, launches["wgmma_bf16"], fp32_launches["fma_fp32"]


def phase_main(torch, np, TE, TG, kernels, scale: int):
    """Phase 3: the port's Bloom path at full size, then its checks."""
    t0 = time.perf_counter()
    g = TG.kronecker(scale, 16, seed=1, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"phase 3: kronecker({scale}, 16, seed=1): n={g.n} m={g.m} "
          f"d_max={g.d_max} generate+CSR {gen_s:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
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
    launches = kernels.launch_counts()
    forms = dict(kernels.fused_expr.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    words = sess.sketch.data.shape[1]
    chunks = math.ceil(g.m / sess.plan.edge_chunk)
    print(f"  session: words={words} sketch={sess.stats()['sketch_bytes']} "
          f"bytes build {build_s:.3f} s; pass (TC) {pass_s:.3f} s; "
          f"LCC {lcc_s:.3f} s; edge_chunk={sess.plan.edge_chunk} "
          f"degree_order={sess.plan.degree_order}", flush=True)
    print(f"  TC={tc:.6g} mean LCC={mean_lcc:.6g} launches={launches} "
          f"by form={forms} peak device memory {peak} bytes", flush=True)
    require(sess.plan.use_kernel, "the main path must use the kernels")
    require(launches["fused_gather_popcount"] == chunks
            and forms.get("gather/and2") == chunks,
            f"gather kernel launched {launches['fused_gather_popcount']} "
            f"times ({forms}), expected one AND2 launch per chunk ({chunks})")
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
    edges = g.edges[edge_sample(torch, np, g)]
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
    return g, sess, dict(launches=launches, forms=forms, chunks=chunks,
                n=g.n, m=g.m,
                gen_s=gen_s, build_s=build_s, pass_s=pass_s, lcc_s=lcc_s,
                warm_pass_s=warm_pass_s,
                plain_pass_s=plain_pass_s, tc=tc, mean_lcc=mean_lcc,
                peak_bytes=peak, words=words)


def edge_sample(torch, np, g):
    """Indices of a fixed 1M-edge sample of ``g.edges`` (seed 0)."""
    return torch.from_numpy(np.random.default_rng(0).choice(
        g.m, size=min(g.m, 1_000_000), replace=False)).to("cuda")


def phase_minhash(torch, np, TE, kernels, g, chunks: int):
    """Phase 3b: the MinHash path on the scale-21 graph of phase 3."""
    from repro_torch.kernels import mh_intersect, ref
    from repro_torch.obs.metrics import REGISTRY

    sample = edge_sample(torch, np, g)
    u, v = (g.edges[sample, c].long() for c in (0, 1))
    results, sessions = {}, {}
    for kind, kw, kernel in (("kh", {}, "khash_match_pairs"),
                             ("1h", {"variant": "naive"},
                              "mh_intersect_pairs")):
        label = kind + ("-naive" if kw else "")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sess = TE.session(g, kind, storage_budget=1.0, device="cuda", **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tc = float(sess.triangle_count())
        pass_s = time.perf_counter() - t0
        r = dict(build_s=build_s, pass_s=pass_s, tc=tc, k=sess.sketch.k,
                 sketch_bytes=sess.stats()["sketch_bytes"])
        if kind == "kh":
            t0 = time.perf_counter()
            lcc = sess.local_clustering()
            r["mean_lcc"] = float(lcc.mean())
            r["lcc_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            labels, num = sess.jarvis_patrick("jaccard", 0.05)
            r["clusters"] = int(num)
            r["jp_s"] = time.perf_counter() - t0
            r["jp_iterations"] = int(
                REGISTRY.gauge("cluster_cc_iterations").value)
            t0 = time.perf_counter()
            sim = sess.edge_similarity("jaccard")
            r["mean_jaccard"] = float(sim.mean())
            r["sim_s"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        forms = dict(mh_intersect.FORM_LAUNCHES)
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["launches"], r["forms"] = launches, forms
        print(f"phase 3b: {label}: k={r['k']} sketch={r['sketch_bytes']} "
              f"bytes build {build_s:.3f} s; pass (TC) {pass_s:.3f} s; "
              f"TC={tc:.6g}; launches={launches}; by form={forms}; peak "
              f"device memory {r['peak_bytes']} bytes", flush=True)
        if kind == "kh":
            print(f"  LCC mean {r['mean_lcc']:.6g} ({r['lcc_s']:.3f} s); "
                  f"Jarvis-Patrick (jaccard >= 0.05): {r['clusters']} "
                  f"clusters, {r['jp_iterations']} iterations "
                  f"({r['jp_s']:.3f} s); edge Jaccard mean "
                  f"{r['mean_jaccard']:.6g} ({r['sim_s']:.3f} s)",
                  flush=True)
            require(lcc.shape == (g.n,) and bool(torch.isfinite(lcc).all())
                    and bool((lcc >= 0).all()),
                    "kh LCC must be finite, non-negative float32[n]")
            require(labels.shape == (g.n,) and 1 <= r["clusters"] <= g.n
                    and bool((labels <= torch.arange(
                        g.n, device="cuda")).all()),
                    "Jarvis-Patrick labels must be int32[n] minima")
            require(sim.shape == (g.m,) and bool(torch.isfinite(sim).all())
                    and bool(((sim >= 0) & (sim <= 1)).all()),
                    "edge Jaccard must lie in [0, 1]")
        require(sess.plan.use_kernel, f"the {label} path must use the kernels")
        require(launches[kernel] == chunks
                and sum(launches.values()) == chunks
                and forms == {f"{kernel}/gather": chunks},
                f"{label}: launches {launches} ({forms}), expected {chunks} "
                f"of {kernel}, all in the gather form, and no other")
        require(math.isfinite(tc) and tc > 0, f"{label} TC {tc}")

        # the runs below launch kernels too; they are not counted
        t0 = time.perf_counter()
        float(TE.MiningSession(g, sess.sketch, sess.plan).triangle_count())
        r["warm_pass_s"] = time.perf_counter() - t0
        data, n = sess.sketch.data, sess.sketch.n
        ru, rv = data.index_select(0, u), data.index_select(0, v)
        want = getattr(ref, kernel)(ru, rv, n)
        for form, got in (
                ("rows", getattr(mh_intersect, kernel)(ru, rv, n)),
                ("gather", getattr(mh_intersect, MINHASH_FORMS[kernel])(
                    data, g.edges[sample], n))):
            require(torch.equal(got, want),
                    f"{label}: {int((got != want).sum())} of {u.numel()} "
                    f"sampled edges' match counts ({form} form) differ from "
                    "the plain version")
        t0 = time.perf_counter()
        tc_plain = float(TE.MiningSession(
            g, sess.sketch, sess.plan.with_(use_kernel=False)
        ).triangle_count())
        r["plain_pass_s"] = time.perf_counter() - t0
        require(math.isclose(tc, tc_plain, rel_tol=1e-4),
                f"{label} TC {tc} vs plain-path TC {tc_plain}")
        print(f"  warm pass {r['warm_pass_s']:.3f} s = "
              f"{g.m / r['warm_pass_s']:.4g} edges/s; {u.numel()}-edge "
              f"match-count sample (rows and gather forms) equal to the "
              f"plain version; plain-path "
              f"TC={tc_plain:.6g} (pass {r['plain_pass_s']:.3f} s)",
              flush=True)
        results[label], sessions[label] = r, sess
    return results, sessions


#: device cycles a warm timing holds the card before each launch (~1 ms at
#: 1.98 GHz): the host enqueues the launch meanwhile
HOLD_CYCLES = 2_000_000


def make_hold(torch):
    """A stand-in for :func:`make_flush` that keeps the card busy without
    touching memory (``torch.cuda._sleep``), so :func:`time_ms` times a
    launch that finds the rows its previous runs read still in L2."""
    def hold():
        torch.cuda._sleep(HOLD_CYCLES)
    return hold


def hub_chunks(g, plan) -> dict:
    """Two chunks of the Bloom TC pass as it launches them: the edges in
    hub order (``order_edges_by_hub``) cut into ``plan.edge_chunk``
    tuples; the first (the hubbiest) and the median one, int32[T, 2]."""
    from repro_torch.engine.plan import order_edges_by_hub

    edges, _ = order_edges_by_hub(g, g.edges)
    c = plan.edge_chunk
    mid = -(-edges.shape[0] // c) // 2
    return {"hub chunk": edges[:c].contiguous(),
            "median chunk": edges[mid * c:(mid + 1) * c].contiguous()}


def phase_real_chunks(torch, kernels, g, sess, kh_sess) -> dict:
    """Phase 3d: the AND2 gather on two real chunks of the Bloom TC pass
    (:func:`hub_chunks`), checked against the plain version, timed with L2
    flushed and warm (no flush), each beside its bound (each distinct row,
    id and output once) and beside ``khash_match_gather`` on the same pairs
    over the phase-3b k-Hash sketch."""
    from repro_torch.kernels import program, ref

    fe, mh = kernels.fused_expr, kernels.mh_intersect
    data, W = sess.sketch.data, sess.sketch.data.shape[1]
    kdata, kn = kh_sess.sketch.data, kh_sess.sketch.n
    prog = program.and_program(2)
    flush, hold = make_flush(torch), make_hold(torch)
    timing = {}
    for label, pairs in hub_chunks(g, sess.plan).items():
        T = pairs.shape[0]
        call = lambda: fe.fused_gather_popcount(data, pairs, prog)
        want = ref.fused_gather_popcount(data, pairs, prog)
        got = call()
        require(torch.equal(got, want),
                f"gather AND2 on the {label}: {int((got != want).sum())} of "
                f"{T} popcounts differ from the plain version")
        rows = int(torch.unique(pairs).numel())
        nbytes = rows * W * 4 + T * 2 * 4 + T * 4
        bound, by = bound_ms(nbytes, T * W * 3)
        ms, warm = time_ms(call, flush), time_ms(call, hold)
        plain = time_ms(lambda: ref.fused_gather_popcount(data, pairs, prog),
                        flush)
        kcall = lambda: mh.khash_match_gather(kdata, pairs, kn)
        kms, kwarm = time_ms(kcall, flush), time_ms(kcall, hold)
        timed_at = (f"gather AND2, the {label} of the scale-{SCALE} Bloom TC "
                    f"pass in hub order: T={T}, {rows} distinct rows, W={W}")
        print(f"phase 3d: {timed_at}: {ms:.4f} ms L2 flushed, {warm:.4f} ms "
              f"warm (plain {plain:.4f} ms; bound {bound:.4f} ms by {by}, "
              f"{nbytes} bytes, {bound / ms:.1%} / {bound / warm:.1%}); "
              f"khash_match_gather on the same pairs (k={kdata.shape[1]}) "
              f"{kms:.4f} / {kwarm:.4f} ms; popcounts equal the plain "
              f"version; layout {fe.tile_layout(data)}", flush=True)
        timing[f"fused_gather_popcount[{label}]"] = dict(
            ms=ms, warm_ms=warm, plain_ms=plain, bound_ms=bound, bound_by=by,
            bytes=nbytes, max_abs_err=int((got - want).abs().max()),
            khash_gather_ms=kms, khash_gather_warm_ms=kwarm,
            library_note=NO_LIBRARY["popcount"], timed_at=timed_at)
    del flush
    torch.cuda.empty_cache()
    return timing


def wedge_candidates(np, g) -> int:
    """Σ over canonical edges (u, v) of |{w ∈ N_v : w > v}|, in numpy."""
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    row = np.repeat(np.arange(g.n), np.diff(indptr))
    up = np.bincount(row[indices > row], minlength=g.n)
    return int(up[g.edges[:, 1].cpu().numpy()].sum())


def hub_edge_sample(torch, np, g, hubs: int = 4, per_hub: int = 64,
                    others: int = 4096):
    """Canonical edges: up to ``per_hub`` at each of the ``hubs`` vertices
    of highest degree, and ``others`` drawn at random (seed 0)."""
    top = torch.topk(g.deg, hubs).indices.to(torch.int32)
    picks = []
    for hub in top:
        at = torch.nonzero((g.edges == hub).any(dim=1)).squeeze(1)
        picks.append(at[torch.linspace(0, at.numel() - 1, min(
            per_hub, at.numel()), device=at.device).long()])
    picks.append(torch.from_numpy(np.random.default_rng(0).choice(
        g.m, size=min(others, g.m), replace=False)).to(g.edges.device))
    return g.edges[torch.unique(torch.cat(picks))]


def clique_pass(torch, kernels, fn):
    """Run ``fn()`` with launch counts zeroed just before and read just
    after; returns (value, seconds, launches, forms, peak bytes)."""
    from repro_torch.obs.metrics import REGISTRY

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    value = float(fn())
    seconds = time.perf_counter() - t0
    gauges = {name: int(REGISTRY.gauge(name).value) for name in (
        "clique_wedge_candidates", "clique_triangles",
        "clique_pair_candidates", "clique_quads")}
    return dict(value=value, s=seconds, launches=kernels.launch_counts(),
                forms=dict(kernels.fused_expr.FORM_LAUNCHES),
                peak_bytes=torch.cuda.max_memory_allocated(), **gauges)


def require_same_popcounts(torch, TE, sketch, plan, tuples, what: str):
    """Kernel-path popcounts of ``tuples`` equal the plain path's."""
    tuples = tuples.to(torch.int32)
    got = TE.tuple_cardinality_ones(sketch, tuples, plan)
    want = TE.tuple_cardinality_ones(sketch, tuples,
                                     plan.with_(use_kernel=False))
    require(torch.equal(got, want),
            f"{what}: {int((got != want).sum())} of {tuples.shape[0]} "
            "popcounts differ from the plain path")


def require_same_segment_popcounts(torch, TE, sketch, plan, segments,
                                   what: str) -> int:
    """Kernel-path popcounts of every launch of ``segments`` (see
    ``cliques.closed_segments``) equal the plain path's; returns the
    tuples checked."""
    from repro_torch.core.algorithms import cliques

    plain, checked = plan.with_(use_kernel=False), 0
    for segment in segments:
        for launch in cliques.segment_launches(*segment):
            got = TE.segment_cardinality_ones(sketch, *launch, plan)
            want = TE.segment_cardinality_ones(sketch, *launch, plain)
            require(torch.equal(got, want),
                    f"{what}: {int((got != want).sum())} of {got.numel()} "
                    "segmented popcounts differ from the plain path")
            checked += got.numel()
    return checked


def time_clique_form(torch, kernels, sketch, segments, flush, what: str
                     ) -> dict:
    """The first launch of a Bloom clique pass: the segmented kernel and
    the [T, k] gather kernel on the same tuples, checked against each other
    and the plain version, then timed in turns (gather, segmented,
    segmented, gather; L2 flushed before each launch) beside the plain
    time and two bounds: the segmented input's (each row, head, offset,
    tail and output once) and the [T, k] input's."""
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import program, ref

    fe = kernels.fused_expr
    heads, offsets, tails = next(cliques.segment_launches(*next(segments)))
    T, k = tails.numel(), heads.shape[1] + 1
    data, W = sketch.data, sketch.data.shape[1]
    counts = (offsets[1:] - offsets[:-1]).long()
    tuples = torch.cat([heads.repeat_interleave(counts, 0), tails[:, None]],
                       dim=1).contiguous()
    prog = program.and_program(k)
    got = fe.fused_segment_popcount(data, heads, offsets, tails)
    gathered = fe.fused_gather_popcount(data, tuples, prog)
    want = ref.fused_segment_popcount(data, heads, offsets, tails)
    require(torch.equal(got, want) and torch.equal(gathered, want),
            f"AND{k} on {what}: {int((got != want).sum())} segmented and "
            f"{int((gathered != want).sum())} [T, k] popcounts of {T} differ "
            "from the plain version")
    used = counts > 0
    s_used = int(used.sum())
    rows = torch.unique(torch.cat([heads[used].reshape(-1), tails]))
    seg_bytes = (rows.numel() * W * 4 + s_used * (k - 1) * 4
                 + (s_used + 1) * offsets.element_size() + T * 4 + T * 4)
    tup_bytes = int(torch.unique(tuples).numel()) * W * 4 + T * k * 4 + T * 4
    # per tail word an AND, a popcount and an add; per head word k-2 ANDs
    bound, by = bound_ms(seg_bytes, T * W * 3 + s_used * W * (k - 2))
    bound_tuples, _ = bound_ms(tup_bytes, T * W * (k + 1))
    seg_call = lambda: fe.fused_segment_popcount(data, heads, offsets, tails)
    gather_call = lambda: fe.fused_gather_popcount(data, tuples, prog)
    g1 = time_ms(gather_call, flush, reps=10, warmup=2)
    s1 = time_ms(seg_call, flush, reps=10, warmup=2)
    s2 = time_ms(seg_call, flush, reps=10, warmup=2)
    g2 = time_ms(gather_call, flush, reps=10, warmup=2)
    ms, gather_ms = (s1 + s2) / 2, (g1 + g2) / 2
    plain = time_ms(lambda: ref.fused_segment_popcount(data, heads, offsets,
                                                       tails),
                    flush, reps=5, warmup=1)
    layout = fe.segment_layout(data)
    timed_at = (f"segment AND{k}, T={T} {what} in {s_used} segments "
                f"({heads.shape[0]} given), W={W}")
    print(f"  AND{k} on the first launch of the pass ({timed_at}; layout "
          f"{layout}): segmented {s1:.4f} / {s2:.4f} ms, [T, k] gather "
          f"{g1:.4f} / {g2:.4f} ms (in turns), plain {plain:.4f} ms; bound "
          f"{bound:.4f} ms by {by} ({seg_bytes} bytes, {bound / ms:.1%}), "
          f"[T, k] input's bound {bound_tuples:.4f} ms ({tup_bytes} bytes, "
          f"{bound_tuples / gather_ms:.1%} of the gather kernel); popcounts "
          f"equal each other and the plain version", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bytes=seg_bytes, kernel="pg_fused_segment_popcount",
                gather_ms=gather_ms, bound_ms_tuples=bound_tuples,
                max_abs_err=int((got - want).abs().max()),
                library_note=NO_LIBRARY["popcount"], timed_at=timed_at)


def time_khash_clique_launch(torch, kernels, g, sketch) -> dict:
    """The first launch of the k-Hash 4-clique pass: ``khash_match_pairs``
    (rows form) on rows u and v of its first piece of triangles, checked
    against the plain version and timed beside its bound (L2 flushed)."""
    from repro_torch.core.algorithms import cliques
    from repro_torch.kernels import ref

    tri = next(cliques.closed_triangles(g, sketch))[:cliques._LAUNCH_TUPLES]
    mu, mv = (sketch.data.index_select(0, tri[:, c].long()) for c in (0, 1))
    T, k, n = mu.shape[0], mu.shape[1], g.n
    fn = kernels.mh_intersect.khash_match_pairs
    got, want = fn(mu, mv, n), ref.khash_match_pairs(mu, mv, n)
    require(torch.equal(got, want),
            f"khash_match_pairs on the k-Hash 4-clique launch: "
            f"{int((got != want).sum())} of {T} counts differ from the plain "
            "version")
    flush = make_flush(torch)
    ms = time_ms(lambda: fn(mu, mv, n), flush, reps=10, warmup=2)
    plain = time_ms(lambda: ref.khash_match_pairs(mu, mv, n), flush,
                    reps=5, warmup=1)
    nbytes = 2 * T * k * 4 + T * 4
    bound, by = bound_ms(nbytes, T * k)
    timed_at = (f"rows form, E={T} pairs (u, v) of the first piece of "
                f"triangles of the k-Hash 4-clique pass, k={k}, "
                f"kronecker({CLIQUE5_SCALE}, 16, seed=1)")
    print(f"  khash_match_pairs on the first launch of the pass ({timed_at})"
          f": {ms:.4f} ms (plain {plain:.4f} ms, bound {bound:.4f} ms by "
          f"{by}, {nbytes} bytes, {bound / ms:.1%} of bound); counts equal "
          "the plain version", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                bytes=nbytes, timed_at=timed_at,
                max_abs_err=int((got - want).abs().max()))


def phase_cliques(torch, np, TE, TG, kernels, g, sess):
    """Phase 3c: 4-cliques on the phase-3 Bloom session at scale 21, then
    5-cliques (Bloom, AND4) and the k-Hash 4-clique at CLIQUE5_SCALE. The
    AND3 and AND4 forms are timed on the first launch of their pass."""
    from repro_torch.core.algorithms import cliques

    want_wedges = wedge_candidates(np, g)
    r4 = clique_pass(torch, kernels, sess.four_clique_count)
    and3 = r4["forms"].get("segment/and3", 0)
    print(f"phase 3c: 4-cliques, scale {SCALE} Bloom session: estimate "
          f"{r4['value']:.6g}; wedge candidates {r4['clique_wedge_candidates']}"
          f" (numpy {want_wedges}); tuples to the kernel "
          f"{r4['clique_triangles']}; AND3 launches {and3} "
          f"(launches {r4['launches']}); pass {r4['s']:.3f} s; peak device "
          f"memory {r4['peak_bytes']} bytes", flush=True)
    require(sess.plan.use_kernel, "the 4-clique pass must use the kernels")
    require(r4["clique_wedge_candidates"] == want_wedges,
            "4-clique wedge candidates differ from the numpy count")
    require(and3 >= -(-r4["clique_triangles"] // cliques._LAUNCH_TUPLES) > 0
            and r4["launches"]["fused_segment_popcount"] == and3
            and r4["launches"]["fused_gather_popcount"] == 0,
            f"4-clique pass: {and3} segmented AND3 launches for "
            f"{r4['clique_triangles']} tuples ({r4['forms']})")
    require(math.isfinite(r4["value"]) and r4["value"] > 0,
            f"4-clique estimate {r4['value']}")
    sample = hub_edge_sample(torch, np, g)
    tri = torch.cat(list(cliques.closed_triangles(g, sess.sketch,
                                                  edges=sample)))
    require_same_popcounts(torch, TE, sess.sketch, sess.plan,
                           tri[:2_000_000], "scale-21 triangle sample")
    seg_checked = require_same_segment_popcounts(
        torch, TE, sess.sketch, sess.plan,
        cliques.closed_segments(g, sess.sketch, 3, edges=sample),
        "scale-21 triangle sample")
    print(f"  {min(tri.shape[0], 2_000_000)} triangles of {sample.shape[0]} "
          f"sampled edges (hub edges included): AND3 popcounts equal the "
          f"plain path ([T, k] gather); all {seg_checked} through segments "
          f"too", flush=True)
    del tri
    flush = make_flush(torch)
    timing = {"bf_edge_intersect3": time_clique_form(
        torch, kernels, sess.sketch, cliques.closed_segments(g, sess.sketch),
        flush, f"survivor tuples of the scale-{SCALE} 4-clique pass")}

    t0 = time.perf_counter()
    g16 = TG.kronecker(CLIQUE5_SCALE, 16, seed=1, device="cuda")
    gen_s = time.perf_counter() - t0
    bf16s = TE.session(g16, "bf", storage_budget=1.0, device="cuda")
    r5 = clique_pass(torch, kernels, bf16s.five_clique_count)
    and4 = r5["forms"].get("segment/and4", 0)
    print(f"phase 3c: 5-cliques, kronecker({CLIQUE5_SCALE}, 16, seed=1) "
          f"(n={g16.n} m={g16.m}, generated in {gen_s:.1f} s) Bloom "
          f"words={bf16s.sketch.data.shape[1]}: estimate {r5['value']:.6g}; "
          f"wedges {r5['clique_wedge_candidates']}, triangles "
          f"{r5['clique_triangles']}, pair candidates "
          f"{r5['clique_pair_candidates']}, tuples to the kernel "
          f"{r5['clique_quads']}; AND4 launches {and4}; pass {r5['s']:.3f} s;"
          f" peak device memory {r5['peak_bytes']} bytes", flush=True)
    require(and4 >= -(-r5["clique_quads"] // cliques._LAUNCH_TUPLES) > 0
            and r5["launches"]["fused_segment_popcount"] == and4
            and r5["launches"]["fused_gather_popcount"] == 0,
            f"5-clique pass: {and4} segmented AND4 launches "
            f"({r5['forms']})")
    require(math.isfinite(r5["value"]) and r5["value"] > 0,
            f"5-clique estimate {r5['value']}")
    sample16 = hub_edge_sample(torch, np, g16, per_hub=16, others=1024)
    quads = torch.cat(list(cliques.closed_quads(g16, bf16s.sketch,
                                                edges=sample16)))
    require_same_popcounts(torch, TE, bf16s.sketch, bf16s.plan,
                           quads[:2_000_000], "scale-16 4-clique sample")
    seg_checked = require_same_segment_popcounts(
        torch, TE, bf16s.sketch, bf16s.plan,
        cliques.closed_segments(g16, bf16s.sketch, 4, edges=sample16),
        "scale-16 4-clique sample")
    print(f"  {min(quads.shape[0], 2_000_000)} 4-cliques of "
          f"{sample16.shape[0]} sampled edges (hub edges included): AND4 "
          f"popcounts equal the plain path ([T, k] gather); all "
          f"{seg_checked} through segments too", flush=True)
    del quads
    timing["fused_gather_popcount[AND4]"] = time_clique_form(
        torch, kernels, bf16s.sketch,
        cliques.closed_segments(g16, bf16s.sketch, 4), flush,
        f"survivor 4-cliques of the scale-{CLIQUE5_SCALE} 5-clique pass")
    del bf16s, flush

    kh = TE.session(g16, "kh", storage_budget=1.0, device="cuda")
    rk = clique_pass(torch, kernels, kh.four_clique_count)
    kforms = dict(kernels.mh_intersect.FORM_LAUNCHES)
    t0 = time.perf_counter()
    plain_kh = float(TE.MiningSession(g16, kh.sketch, kh.plan.with_(
        use_kernel=False)).four_clique_count())
    plain_kh_s = time.perf_counter() - t0
    print(f"phase 3c: k-Hash 4-cliques, kronecker({CLIQUE5_SCALE}) k="
          f"{kh.sketch.k}: estimate {rk['value']:.6g} (plain path "
          f"{plain_kh:.6g}, {plain_kh_s:.3f} s); triangles (exact closing) "
          f"{rk['clique_triangles']}; launches {rk['launches']}; pass "
          f"{rk['s']:.3f} s; peak device memory {rk['peak_bytes']} bytes",
          flush=True)
    rk["forms"] = kforms
    require(rk["launches"]["khash_match_pairs"] > 0
            and kforms == {"khash_match_pairs/rows":
                           rk["launches"]["khash_match_pairs"]},
            f"the k-Hash 4-clique pass launched {kforms}, expected the rows "
            "form of khash_match_pairs only")
    require(rk["value"] == plain_kh,
            f"k-Hash 4-cliques {rk['value']} vs plain path {plain_kh}")
    timing["khash_match_pairs[clique]"] = time_khash_clique_launch(
        torch, kernels, g16, kh.sketch)
    del kh, g16
    torch.cuda.empty_cache()
    return dict(four=r4, five=r5, kh=rk, and3=and3, and4=and4,
                timing=timing)


def phase_breakdown(torch, TE, sketches, g, sess, warm_pass_s, build_s,
                    mh_sessions, mh_path, clique_s):
    """Phase 4: where the time goes. A warm Bloom pass (TC + LCC), a Bloom
    sketch build, warm k-Hash and 1-Hash-naive passes (TC) and the
    4-clique pass run under torch.profiler; device busy time is the sum of
    their kernels' device time, and the idle share is taken against the
    unprofiled wall time of phases 3/3b/3c."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(label, fn, wall_s, top=6):
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
        for e in sorted(kernels,
                        key=lambda e: -e.self_device_time_total)[:top]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
                  f"{e.key[:100]}", flush=True)
        return busy_s, kernels

    def warm_pass():
        again = TE.MiningSession(g, sess.sketch, sess.plan)
        float(again.triangle_count())
        again.local_clustering()

    pass_busy, pass_kernels = run("warm TC pass + LCC", warm_pass,
                                  warm_pass_s)
    tile = [e for e in pass_kernels if "tile_popcount_kernel" in e.key]
    tile_us = sum(e.self_device_time_total for e in tile)
    tile_n = sum(e.count for e in tile)
    require(tile_n > 0, "the warm Bloom pass profile shows no launch of the "
                        "[T, k] gather kernel")
    print(f"  the [T, k] gather kernel in the warm pass: {tile_n} launches, "
          f"{tile_us / 1e3:.3f} ms, {tile_us / tile_n:.2f} us a launch",
          flush=True)
    build_busy, _ = run("sketch build", lambda: sketches.build(
        g, "bf", storage_budget=1.0), build_s)
    mh_busy = {}
    for label, name in (("kh", "k-Hash"), ("1h-naive", "1-Hash-naive")):
        mh = mh_sessions[label]
        mh_busy[label], _ = run(f"warm {name} TC pass", lambda: float(
            TE.MiningSession(g, mh.sketch, mh.plan).triangle_count()),
            mh_path[label]["warm_pass_s"])
    clique_busy, _ = run(f"4-clique pass (scale {SCALE})",
                         lambda: float(sess.four_clique_count()), clique_s,
                         top=14)
    return pass_busy, build_busy, mh_busy, clique_busy


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
    return g, exact


_GOLDEN = 0x9E3779B9
_PAD_HASH = 0xFFFFFFFF


def numpy_bloom_cliques(np, hash_u32, bloom, indptr, indices, edges,
                        num_hashes: int, seed: int = 0):
    """Bloom 4- and 5-clique estimates from the definitions, in numpy:
    candidates w > v of N_v per edge (u, v), closed when every hash bit of
    w is set in u's row; pairs w < x of one edge's survivors closed when
    x's bits are set in w's row; Eq. 2 on popcount(AND of the rows),
    summed in float64 and divided by 4 and 5."""
    n, words = bloom.shape
    bits = words * 32
    pos = np.stack([hash_u32(np.arange(n), (i + seed * _GOLDEN) & 0xFFFFFFFF)
                    .astype(np.int64) % bits for i in range(num_hashes)], 1)

    def member(a, x):
        ok = np.ones(a.shape[0], dtype=bool)
        for i in range(num_hashes):
            p = pos[x, i]
            ok &= ((bloom[a, p >> 5] >> (p & 31).astype(np.uint32)) & 1) == 1
        return ok

    def estimate_sum(cols):
        total = 0.0
        for s0 in range(0, cols[0].shape[0], 1 << 20):
            acc = bloom[cols[0][s0:s0 + (1 << 20)]]
            for c in cols[1:]:
                acc = acc & bloom[c[s0:s0 + (1 << 20)]]
            ones = np.unpackbits(acc.view(np.uint8), axis=1).sum(axis=1)
            ones = np.minimum(ones.astype(np.float64), bits - 1)
            total += float((-(bits / num_hashes)
                            * np.log1p(-ones / bits)).sum())
        return total

    def expand(counts):
        """(item, rank) of every slot of items holding counts[i] slots."""
        item = np.repeat(np.arange(counts.shape[0]), counts)
        first = np.cumsum(counts) - counts
        return item, np.arange(item.shape[0]) - first[item]

    row = np.repeat(np.arange(n), np.diff(indptr))
    up_first = indptr[:-1].astype(np.int64) + np.bincount(
        row[indices < row], minlength=n)
    up_count = indptr[1:] - up_first
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    e, rank = expand(up_count[v])
    w = indices[up_first[v][e] + rank].astype(np.int64)
    keep = member(u[e], w)
    e, w = e[keep], w[keep]
    cc4 = estimate_sum([u[e], v[e], w]) / 4
    later = np.searchsorted(e, e, side="right") - 1 - np.arange(e.shape[0])
    i, rank = expand(later)
    j = i + 1 + rank
    keep = member(w[i], w[j])
    i, j = i[keep], j[keep]
    cc5 = estimate_sum([u[e[i]], v[e[i]], w[i], w[j]]) / 5
    return cc4, cc5


def phase_reference_cliques(torch, np, TE, g):
    """Phase 5, cliques: the Bloom 4- and 5-clique estimates at scale 12
    against numpy's and against the exact counts; the exact branch
    reproduces the brute-force counts."""
    from repro_torch.core.algorithms import cliques
    from repro_torch.core.hashing import np_hash_u32

    sess = TE.session(g, "bf", storage_budget=0.25, device="cuda")
    t0 = time.perf_counter()
    cc4, cc5 = float(sess.four_clique_count()), float(sess.five_clique_count())
    est_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex4, ex5 = float(cliques.four_clique_count(g)), float(
        cliques.five_clique_count(g))
    exact_s = time.perf_counter() - t0
    want4, want5 = numpy_bloom_cliques(
        np, np_hash_u32, sess.sketch.data.cpu().numpy().view(np.uint32),
        g.indptr.cpu().numpy(), g.indices.cpu().numpy(),
        g.edges.cpu().numpy(), sess.sketch.num_hashes, sess.sketch.seed)
    print(f"phase 5: scale 12 cliques: Bloom 4-cliques {cc4:.6g} (numpy "
          f"{want4:.6g}, exact {ex4:.0f}, rel err "
          f"{(cc4 - ex4) / ex4:+.4f}); Bloom 5-cliques {cc5:.6g} (numpy "
          f"{want5:.6g}, exact {ex5:.0f}, rel err {(cc5 - ex5) / ex5:+.4f}); "
          f"estimates {est_s:.3f} s, exact counts {exact_s:.3f} s",
          flush=True)
    require(ex4 == EXACT_4CLIQUES_12 and ex5 == EXACT_5CLIQUES_12,
            f"exact clique counts {ex4}, {ex5} vs brute force "
            f"{EXACT_4CLIQUES_12}, {EXACT_5CLIQUES_12}")
    require(math.isclose(cc4, want4, rel_tol=1e-5)
            and math.isclose(cc5, want5, rel_tol=1e-5),
            f"Bloom clique estimates {cc4}, {cc5} vs numpy {want4}, {want5}")


def numpy_minhash(np, hash_u32, indptr, indices, n: int, k: int, d_max: int,
                  seed: int = 0):
    """k-Hash, 1-Hash and KMV sketches built row by row in numpy from the
    definitions: per hash function the neighbour of least hash (smallest
    id on ties); the k neighbours of least hash, ties by id, a hash of
    all ones read as a pad; the k least hash values mapped to (0, 1]. The
    last two keep min(k, d_max) columns, as the reference does."""
    width = min(k, d_max)
    kh = np.full((n, k), n, np.int32)
    oh = np.full((n, width), n, np.int32)
    kmv = np.full((n, width), 2.0, np.float32)
    fam = np.stack([hash_u32(indices, (i + seed * _GOLDEN) & 0xFFFFFFFF)
                    for i in range(k)], axis=1)
    h1 = hash_u32(indices, seed)
    unit = (h1.astype(np.float32) + np.float32(1.0)) * np.float32(2.0 ** -32)
    for x in range(n):
        lo, hi = int(indptr[x]), int(indptr[x + 1])
        if lo == hi:
            continue
        nb = indices[lo:hi]
        kh[x] = nb[np.argmin(fam[lo:hi], axis=0)]
        order = np.argsort(h1[lo:hi], kind="stable")[:width]
        oh[x, :order.size] = np.where(h1[lo:hi][order] == _PAD_HASH, n,
                                      nb[order])
        vals = np.sort(unit[lo:hi])[:width]
        kmv[x, :vals.size] = vals
    return kh, oh, kmv


def numpy_kmv_size(np, rows):
    filled = (rows < 2.0).sum(axis=1)
    kmax = np.where(rows < 2.0, rows, 0.0).max(axis=1)
    est = (filled - 1.0) / np.maximum(kmax, 1e-20)
    return np.where(filled >= rows.shape[1], est, filled)


def phase_reference_minhash(torch, np, TE, g, exact: float):
    """Phase 5, MinHash and KMV: sketches equal to the numpy build, TC
    within rtol 1e-4 of the numpy estimators (1-Hash: the naive variant,
    the kernel path)."""
    from repro_torch.core.hashing import np_hash_u32

    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    e = g.edges.cpu().numpy()
    du = g.deg.cpu().numpy()[e[:, 0]].astype(np.float64)
    dv = g.deg.cpu().numpy()[e[:, 1]].astype(np.float64)
    k = TE.session(g, "kh", storage_budget=1.0, device="cuda").sketch.k
    kh, oh, kmv = numpy_minhash(np, np_hash_u32, indptr, indices, g.n, k,
                                g.d_max)
    n = g.n
    for kind, kw, want in (("kh", {}, kh), ("1h", {"variant": "naive"}, oh),
                           ("kmv", {}, kmv)):
        sess = TE.session(g, kind, storage_budget=1.0, device="cuda", **kw)
        got = sess.sketch.data.cpu().numpy()
        require(got.dtype == want.dtype and np.array_equal(got, want),
                f"scale-12 {kind} sketch differs from the numpy build")
        a, b = want[e[:, 0]], want[e[:, 1]]
        if kind == "kh":
            j = ((a == b) & (a < n)).sum(axis=1) / a.shape[1]
            inter = j / (1 + j) * (du + dv)
        elif kind == "1h":
            j = ((a[:, :, None] == b[:, None, :])
                 & (a[:, :, None] < n)).sum(axis=(1, 2)) / a.shape[1]
            inter = j / (1 + j) * (du + dv)
        else:
            merged = np.sort(np.concatenate([a, b], axis=1), axis=1)
            dup = np.concatenate([np.zeros((len(e), 1), bool),
                                  merged[:, 1:] == merged[:, :-1]], axis=1)
            merged = np.where(dup & (merged < 2.0), 2.0, merged)
            union = numpy_kmv_size(np, np.sort(merged, axis=1)[:, :a.shape[1]])
            inter = np.maximum(du + dv - union, 0.0)
        tc_ref = inter.sum() / 3
        tc = float(sess.triangle_count())
        require(math.isclose(tc, tc_ref, rel_tol=1e-4),
                f"scale-12 {kind} TC {tc} vs numpy {tc_ref}")
        print(f"phase 5: scale 12 {kind}{'-naive' if kw else ''} (k={k}): "
              f"sketch equal to the numpy build; TC={tc:.6g} numpy="
              f"{tc_ref:.6g} (rel err vs exact {abs(tc - exact) / exact:.4f})",
              flush=True)


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
    from repro_torch import kernels
    from repro_torch.engine import setexpr
    from repro_torch.kernels import _build, ref

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
            entries = ptxas_kernels(log.read_text())
            if entries:
                regs = [e["registers"] for e in entries]
                spilled = [e for e in entries if e["spill_stores"]]
                print(f"  {name}: {len(entries)} kernels, {min(regs)}-"
                      f"{max(regs)} registers, "
                      f"{sum(e['spill_stores'] for e in entries)} bytes of "
                      f"spill stores in all (ptxas)"
                      + "".join(f"; {e['spill_stores']} B in {e['kernel']}"
                                for e in spilled), flush=True)

    flush = make_flush(torch)
    timing = phase_kernels(torch, setexpr, kernels.fused_expr, ref, flush)
    timing.update(phase_minhash_kernels(torch, kernels.mh_intersect, ref,
                                        flush))
    attn, attn_launches, fp32_launches = phase_attention(
        torch, kernels.flash_attention, ref, flush,
        libs["flash_attention_wgmma"])
    timing["flash_attention_wgmma"] = attn["qwen3_8b"]
    timing["flash_attention"] = attn["fp32"]
    del flush
    torch.cuda.empty_cache()
    g, sess, main_path = phase_main(torch, np, TE, TG, kernels, SCALE)
    mh_path, mh_sessions = phase_minhash(torch, np, TE, kernels, g,
                                         main_path["chunks"])
    timing.update(phase_real_chunks(torch, kernels, g, sess,
                                    mh_sessions["kh"]))
    clq = phase_cliques(torch, np, TE, TG, kernels, g, sess)
    timing.update(clq["timing"])
    phase_breakdown(torch, TE, sketches, g, sess, main_path["warm_pass_s"],
                    main_path["build_s"], mh_sessions, mh_path,
                    clq["four"]["s"])
    del g, sess, mh_sessions
    torch.cuda.empty_cache()
    g12, exact = phase_reference(torch, np, TE, TG, sketches)
    phase_reference_minhash(torch, np, TE, g12, exact)
    phase_reference_cliques(torch, np, TE, g12)

    print(f"main path: scale {SCALE} n={main_path['n']} "
          f"m={main_path['m']} words={main_path['words']} "
          f"build {main_path['build_s']:.3f} s pass {main_path['pass_s']:.3f} s "
          f"gather launches {main_path['launches']['fused_gather_popcount']}; "
          + "; ".join(f"{label}: k={r['k']} build {r['build_s']:.3f} s pass "
                      f"{r['pass_s']:.3f} s launches {r['forms']}"
                      for label, r in mh_path.items())
          + f"; 4-cliques pass {clq['four']['s']:.3f} s AND3 launches "
          f"{clq['and3']}; 5-cliques (scale {CLIQUE5_SCALE}) pass "
          f"{clq['five']['s']:.3f} s AND4 launches {clq['and4']}; "
          f"flash_attention launches: {attn_launches} wgmma_bf16 (prefill), "
          f"{fp32_launches} fma_fp32 (float32 path)"
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)

    # each row: the kernel's launches on the paths that run it, each path
    # counted from zero (row 1: the Bloom TC, 4-clique and 5-clique paths;
    # rows 3-6 and the AND4 entry: their form's launches on those paths);
    # rows 1-5 are timed at a TC pass chunk, row 6 and the AND4 entry at
    # the first launch of their clique pass (``timed_at``), which runs the
    # segmented kernel (``kernel``; ``gather_ms`` and ``bound_ms_tuples``
    # are the [T, k] kernel's time and its input's bound there). The
    # MinHash rows ``*_pairs`` are the rows forms (mh: no mined path runs
    # it, the TC passes read rows by id; khash: the k-Hash 4-clique pass,
    # timed on its first launch under ``clique_*``), the ``*_gather`` rows
    # the forms the TC passes launch (``old_route_ms``: row copies, then
    # the rows kernel, on the same pairs); the ``[... chunk]`` rows are the
    # AND2 gather on two real chunks of the Bloom TC pass (phase 3d: ``ms``
    # with L2 flushed, ``warm_ms`` without, ``khash_gather_*`` the k-Hash
    # gather on the same pairs), with the Bloom TC path's AND2 launches
    fused_src = "src/repro_torch/kernels/csrc/fused_expr.cu"
    mh_src = "src/repro_torch/kernels/csrc/mh_intersect.cu"
    mh_forms = {label: r["forms"] for label, r in mh_path.items()}
    kh_clique = clq["kh"]["forms"]["khash_match_pairs/rows"]
    kh_launch = timing.pop("khash_match_pairs[clique]")
    timing["khash_match_pairs"].update(
        clique_launches=kh_clique, clique_ms=kh_launch["ms"],
        clique_plain_ms=kh_launch["plain_ms"],
        clique_bound_ms=kh_launch["bound_ms"],
        clique_bound_by=kh_launch["bound_by"],
        clique_timed_at=kh_launch["timed_at"])
    gather = (main_path["launches"]["fused_gather_popcount"]
              + clq["four"]["launches"]["fused_gather_popcount"]
              + clq["five"]["launches"]["fused_gather_popcount"])
    rows = [
        ("fused_gather_popcount", fused_src,
         "src/repro/kernels/fused_expr.py:79", gather),
        ("fused_rows_popcount", fused_src,
         "src/repro/kernels/fused_expr.py:129",
         main_path["launches"]["fused_rows_popcount"]),
        ("bf_intersect_pairs", fused_src,
         "src/repro/kernels/bf_intersect.py:66",
         main_path["forms"].get("rows/and2", 0)),
        ("bf_intersect3_pairs", fused_src,
         "src/repro/kernels/bf_intersect.py:98",
         main_path["forms"].get("rows/and3", 0)),
        ("bf_edge_intersect", fused_src,
         "src/repro/kernels/bf_intersect.py:168",
         main_path["forms"].get("gather/and2", 0)),
        ("bf_edge_intersect3", fused_src,
         "src/repro/kernels/bf_intersect.py:219", clq["and3"]),
        ("mh_intersect_pairs", mh_src, "src/repro/kernels/mh_intersect.py:26",
         mh_forms["1h-naive"].get("mh_intersect_pairs/rows", 0)),
        ("khash_match_pairs", mh_src, "src/repro/kernels/mh_intersect.py:53",
         mh_forms["kh"].get("khash_match_pairs/rows", 0) + kh_clique),
        ("mh_intersect_gather", mh_src,
         "src/repro/kernels/mh_intersect.py:26",
         mh_forms["1h-naive"]["mh_intersect_pairs/gather"]),
        ("khash_match_gather", mh_src,
         "src/repro/kernels/mh_intersect.py:53",
         mh_forms["kh"]["khash_match_pairs/gather"]),
        ("flash_attention_wgmma",
         "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
         "src/repro/kernels/flash_attention.py:73", attn_launches),
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:73", fp32_launches),
        ("fused_gather_popcount[AND4]", fused_src,
         "src/repro/kernels/fused_expr.py:79", clq["and4"]),
        ("fused_gather_popcount[hub chunk]", fused_src,
         "src/repro/kernels/fused_expr.py:79",
         main_path["forms"].get("gather/and2", 0)),
        ("fused_gather_popcount[median chunk]", fused_src,
         "src/repro/kernels/fused_expr.py:79",
         main_path["forms"].get("gather/and2", 0)),
    ]
    records = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": timing[name]["max_abs_err"],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "share": timing[name]["bound_ms"] / timing[name]["ms"],
        "library_ms": timing[name].get("library_ms"),
        "library_note": timing[name].get("library_note"),
        "timed_at": timing[name]["timed_at"],
        **{key: value for key, value in timing[name].items()
           if key in ("kernel", "gather_ms", "bound_ms_tuples",
                      "old_route_ms", "warm_ms", "khash_gather_ms",
                      "khash_gather_warm_ms") or key.startswith("clique_")},
    } for name, source, replaces, launches in rows]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
