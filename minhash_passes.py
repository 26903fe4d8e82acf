#!/usr/bin/env python3
"""Run one mining pass of a checkout of the port, on one GPU.

    python3 minhash_passes.py [--pass kh|1h-naive|kh4|bf] [--src DIR]
                              [--scale 21] [--scale4 16] [--graph-cache F]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same script can drive an older checkout of the port beside this
one; run each pass in its own process. ``kh``, ``1h-naive`` and ``bf``
are the TC passes of ``session(g, "kh")``, ``session(g, "1h",
variant="naive")`` and ``session(g, "bf")`` (the AND2 gather popcount) on
``kronecker(scale, 16, seed=1)``; ``kh4`` is the
k-Hash ``four_clique_count()`` on ``kronecker(scale4, 16, seed=1)``; all
at storage budget 1.0. ``--graph-cache F`` loads the scale-``scale``
graph from F (written by the first run that lacks it), which spares each
process the two minutes the host takes to generate it.

The session (and its sketch) is built first; then the pass runs once
with the launch counts zeroed just before and read just after, and three
times more on a fresh ``MiningSession`` over the same sketch (warm),
each timed on the host clock around a synchronized pass. Prints one JSON
object: the card, the estimate (also as a float32 bit pattern, so two
checkouts compare exactly), the launches (and by form, where the
checkout counts forms), the first and warm pass seconds and the peak
device memory over the passes.
"""
from __future__ import annotations

import argparse
import json
import struct
import sys
import time
from pathlib import Path

#: pass name -> (sketch kind, session options, method)
PASSES = {"kh": ("kh", {}, "triangle_count"),
          "1h-naive": ("1h", {"variant": "naive"}, "triangle_count"),
          "kh4": ("kh", {}, "four_clique_count"),
          "bf": ("bf", {}, "triangle_count")}


def load_graph(torch, graph, scale: int, cache):
    """``kronecker(scale, 16, seed=1)`` on the card, through ``cache``."""
    if cache is not None and Path(cache).exists():
        saved = torch.load(cache)
        return graph.Graph(**{k: v.to("cuda") if torch.is_tensor(v) else v
                              for k, v in saved.items()})
    g = graph.kronecker(scale, 16, seed=1, device="cuda")
    if cache is not None:
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        torch.save(dict(indptr=g.indptr, indices=g.indices, deg=g.deg,
                        edges=g.edges, n_vertices=g.n_vertices,
                        n_edges=g.n_edges, d_max=g.d_max), cache)
    return g


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pass", dest="name", default="kh",
                        choices=sorted(PASSES))
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parent / "src"))
    parser.add_argument("--scale", type=int, default=21)
    parser.add_argument("--scale4", type=int, default=16)
    parser.add_argument("--graph-cache", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("minhash_passes.py needs an NVIDIA GPU")
    sys.path.insert(0, args.src)
    from repro_torch import engine, kernels
    from repro_torch.core import graph
    from repro_torch.kernels import _build, fused_expr, mh_intersect

    _build.build(["fused_expr", "mh_intersect"])   # outside the timed passes
    kind, options, method = PASSES[args.name]
    if args.name == "kh4":
        scale = args.scale4
        g = graph.kronecker(scale, 16, seed=1, device="cuda")
    else:
        scale = args.scale
        g = load_graph(torch, graph, scale, args.graph_cache)
    sess = engine.session(g, kind, storage_budget=1.0, device="cuda",
                          **options)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed(session):
        t0 = time.perf_counter()
        value = float(getattr(session, method)())
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    kernels.reset_launch_counts()
    value, first_s = timed(sess)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    forms = {**getattr(mh_intersect, "FORM_LAUNCHES", {}),
             **fused_expr.FORM_LAUNCHES}
    warm = []
    for _ in range(3):
        again, seconds = timed(engine.MiningSession(g, sess.sketch,
                                                    sess.plan))
        if again != value:
            raise SystemExit(f"warm pass gave {again}, first pass {value}")
        warm.append(seconds)
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), src=args.src, name=args.name,
        scale=scale, k=sess.sketch.k, estimate=value,
        bits=struct.unpack("<I", struct.pack("<f", value))[0],
        launches=launches, forms=forms, first_s=first_s, warm_s=warm,
        peak_bytes=torch.cuda.max_memory_allocated())), flush=True)


if __name__ == "__main__":
    main()
