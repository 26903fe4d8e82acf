"""Multi-query ProbGraph mining on one device (engine session).

Builds one Bloom sketch of a Kronecker graph and runs the requested
algorithms over it (TC, LCC and clustering share one per-edge cardinality
pass): ``--algos tc,lcc,4clique,cliques5,jp,localcluster`` (``jp``:
Jarvis–Patrick clustering, Jaccard ≥ 0.05, reported as its number of
clusters; ``localcluster``: a fixed batch of 8 seeds, α = 0.15, ε = 1e-4,
reported as the mean best conductance of the seeds that found a
cluster). ``--exact`` then counts the triangles exactly over the CSR
(``core/exact.py``) and prints the TC estimate's relative error. The
multi-device ``mine()`` path is not ported yet.

    python -m repro_torch.launch.mine --scale 21 --algos tc,localcluster --exact

runs on the CUDA device (``--device cpu`` runs the plain PyTorch path).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import engine as ENG
from repro_torch._device import DEFAULT_DEVICE, DeviceLike, synchronize
from repro_torch.core import exact as X
from repro_torch.core import graph as G
from repro_torch.obs import metrics, trace

ALGOS = ("tc", "lcc", "4clique", "cliques5", "jp", "localcluster")


def mine_session(graph: G.Graph, algos: list[str], storage_budget: float = 0.25,
                 num_hashes: int = 2, seed: int = 0,
                 device: DeviceLike = DEFAULT_DEVICE):
    """Multi-query mining over ONE shared sketch build (engine.session).

    TC, LCC and clustering share a single per-edge cardinality pass; the
    clique counts and local clustering reuse the same sketch. Returns
    ``{"build": (sketch_bytes, seconds), algo: (value, seconds), ...}``;
    every time ends with the device's work done.
    """
    unknown = [a for a in algos if a not in ALGOS]
    if unknown:
        raise SystemExit(f"unknown algo {unknown[0]!r}; pick from {list(ALGOS)}")
    t0 = time.perf_counter()
    sess = ENG.session(graph, "bf", storage_budget=storage_budget,
                       num_hashes=num_hashes, seed=seed, device=device)
    synchronize(sess.sketch.data)
    results = {"build": (sess.stats()["sketch_bytes"],
                         time.perf_counter() - t0)}

    def run_localcluster():
        # deterministic 8-seed batch; the mean best conductance of the
        # seeds whose sweep found a valid (finite) prefix
        rng = np.random.default_rng(seed + 7)
        seeds = rng.integers(0, graph.n, size=8).astype(np.int32)
        res = sess.local_cluster(seeds, alpha=0.15, eps=1e-4)
        phi = res.best_conductance.cpu().numpy()
        phi = phi[np.isfinite(phi)]
        return float(phi.mean()) if phi.size else float("nan")

    runners = {
        "tc": lambda: float(sess.triangle_count()),
        "lcc": lambda: float(torch.mean(sess.local_clustering())),
        "4clique": lambda: float(sess.four_clique_count()),
        "cliques5": lambda: float(sess.five_clique_count()),
        "jp": lambda: int(sess.jarvis_patrick("jaccard", 0.05)[1]),
        "localcluster": run_localcluster,
    }
    for name in algos:
        t0 = time.perf_counter()
        results[name] = (runners[name](), time.perf_counter() - t0)
    return results


def main(argv=None):
    """CLI: generate, sketch and mine; prints human lines and one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12, help="Kronecker scale")
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--budget", type=float, default=0.25)
    ap.add_argument("--exact", action="store_true",
                    help="also count triangles exactly (core/exact.py) and "
                         "print the TC estimate's relative error")
    ap.add_argument("--algos", type=str, default="tc,lcc",
                    help=f"comma list from {','.join(ALGOS)}")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record spans and write a Chrome-trace/Perfetto "
                         "JSON of the run to this path")
    ap.add_argument("--metrics", action="store_true",
                    help="print a metric-registry snapshot JSON line")
    args = ap.parse_args(argv)

    if args.trace:
        trace.enable()
        trace.clear()
    g = G.kronecker(args.scale, args.edge_factor, seed=1, device=args.device)
    print(f"graph: n={g.n} m={g.m} d_max={g.d_max}")

    res = mine_session(g, args.algos.split(","),
                       storage_budget=args.budget, device=args.device)
    sketch_bytes, build_s = res.pop("build")
    print(f"session: sketch={sketch_bytes/1e6:.2f}MB build={build_s:.2f}s")
    for name, (val, secs) in res.items():
        print(f"  {name:8s} = {val:<12.4g} ({secs:.2f}s)")
    exact = None
    if args.exact:
        t0 = time.perf_counter()
        tc = int(X.exact_triangle_count(g))
        secs = time.perf_counter() - t0
        est = res["tc"][0] if "tc" in res else None
        rel = abs(est - tc) / max(tc, 1) if est is not None else None
        exact = {"value": tc, "seconds": secs, "rel_err": rel}
        print(f"TC_exact={tc} ({secs:.2f}s)"
              + (f" rel_err={rel:.3g}" if rel is not None else ""))
    # machine-readable twin of the human output (one JSON line)
    print(json.dumps({
        "event": "mine_session", "n": g.n, "m": g.m, "d_max": g.d_max,
        "budget": args.budget, "use_kernel": g.device.type == "cuda",
        "device": str(g.device),
        "sketch_bytes": sketch_bytes, "build_s": build_s,
        "algos": {name: {"value": val, "seconds": secs}
                  for name, (val, secs) in res.items()},
        "exact": exact,
    }))
    if args.metrics:
        print(json.dumps({"event": "metrics",
                          "global": metrics.REGISTRY.snapshot()}))
    if args.trace:
        trace.export(args.trace)
        trace.disable()
        print(f"trace -> {args.trace}")


if __name__ == "__main__":
    main()
