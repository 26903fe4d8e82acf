#!/usr/bin/env python3
"""Run the Bloom clique passes of a checkout of the port once, on one GPU.

    python3 clique_passes.py [--src DIR] [--scale 21] [--scale5 16]
                             [--graph-cache F]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same script can drive an older checkout of the port beside this
one. Generates ``kronecker(scale, 16, seed=1)`` and, for the 5-clique
pass, ``kronecker(scale5, 16, seed=1)``, builds each one's Bloom session
at storage budget 1.0 and runs ``four_clique_count()`` and
``five_clique_count()`` once each (host clock around a synchronized
pass, launch counts zeroed just before). Prints one JSON object: the
card, the estimates (as float32 bit patterns too, so two checkouts can
be compared exactly), the enumeration counters, the launches, the pass
seconds and the peak device memory of each pass. ``--graph-cache F``
loads the scale-``scale`` graph from F (written by the first run that
lacks it; the same file as ``minhash_passes.py --graph-cache``).
"""
from __future__ import annotations

import argparse
import json
import struct
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parent / "src"))
    parser.add_argument("--scale", type=int, default=21)
    parser.add_argument("--scale5", type=int, default=16)
    parser.add_argument("--graph-cache", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("clique_passes.py needs an NVIDIA GPU")
    sys.path.insert(0, args.src)
    from repro_torch import engine, kernels
    from repro_torch.core import graph
    from repro_torch.kernels import _build
    from repro_torch.obs.metrics import REGISTRY
    from minhash_passes import load_graph

    _build.build(["fused_expr"])               # outside the timed passes

    def run(scale: int, method: str) -> dict:
        g = load_graph(torch, graph, scale, args.graph_cache
                       if scale == args.scale else None)
        sess = engine.session(g, "bf", storage_budget=1.0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        value = getattr(sess, method)()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        counters = {name: int(REGISTRY.gauge(name).value) for name in (
            "clique_wedge_candidates", "clique_triangles",
            "clique_pair_candidates", "clique_quads")}
        if method == "four_clique_count":
            del counters["clique_pair_candidates"], counters["clique_quads"]
        return dict(scale=scale, estimate=float(value),
                    bits=struct.unpack("<I", struct.pack(
                        "<f", float(value)))[0],
                    seconds=seconds, launches=launches,
                    peak_bytes=torch.cuda.max_memory_allocated(), **counters)

    out = dict(device=torch.cuda.get_device_name(0), src=args.src,
               four=run(args.scale, "four_clique_count"),
               five=run(args.scale5, "five_clique_count"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
