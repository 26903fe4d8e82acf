"""ProbGraph mining: distributed over ranks (``mine``), or a multi-query
engine session on one device (``--algos``).

Without ``--algos`` the launcher runs ``mine()``, the paper's own workload
spread over the ranks of a process group:

  * sketch construction: each rank hashes the CSR rows of its vertex range
    into Bloom rows, then the rows are all-gathered (the sketch is
    s·|CSR| bytes, small by design);
  * mining (TC): each rank takes a contiguous block of the edges, counts
    popcount(B_u AND B_v) per edge (the AND2 gather kernel on the card,
    its plain version on the CPU), sums the estimates and the partial
    sums are all-reduced. Fixed-size sketches give every rank the same
    work: no stragglers from degree skew (the SPMD-native property).

``--devices N`` spawns N ranks (gloo on ``--device cpu``, NCCL with one
rank per GPU on ``cuda``, which needs N GPUs); under ``torchrun`` the
launcher joins the group torchrun made instead. Only rank 0 prints.
``--exact`` also counts the triangles exactly over the CSR
(``core/exact.py``) and prints the estimate's relative error.

With ``--algos tc,lcc,4clique,cliques5,jp,localcluster`` one Bloom
sketch is built and the algorithms run over it (TC, LCC and clustering
share one per-edge cardinality pass; ``jp``: Jarvis–Patrick clustering,
Jaccard ≥ 0.05, reported as its number of clusters; ``localcluster``: a
fixed batch of 8 seeds, α = 0.15, ε = 1e-4, reported as the mean best
conductance of the seeds that found a cluster); ``--exact`` then prints
the TC estimate's relative error.

    python -m repro_torch.launch.mine --scale 21 --exact
    python -m repro_torch.launch.mine --device cpu --devices 2 --scale 10
    torchrun --nproc-per-node=K -m repro_torch.launch.mine --scale 21
    python -m repro_torch.launch.mine --scale 21 --algos tc,localcluster

run on the CUDA device unless ``--device cpu`` (the plain PyTorch path).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import engine as ENG
from repro_torch._device import (DEFAULT_DEVICE, DeviceLike, resolve_device,
                                 synchronize)
from repro_torch.core import exact as X
from repro_torch.core import graph as G
from repro_torch.core import sketches as SK
from repro_torch.distributed import sharding
from repro_torch.distributed.spawn import init_group, spawn
from repro_torch.obs import metrics, trace

ALGOS = ("tc", "lcc", "4clique", "cliques5", "jp", "localcluster")


def mesh_position(mesh) -> tuple:
    """(this rank's row-major index over every mesh dim, the mesh's size);
    (0, 1) for no mesh. The mesh must hold every rank of the process
    group in rank order, as ``make_host_mesh`` and ``init_device_mesh``
    lay them out, so that the default group's collectives follow it."""
    if mesh is None:
        return 0, 1
    names = tuple(mesh.mesh_dim_names)
    size = math.prod(sharding.axis_sizes(mesh).values())
    index = sharding.mesh_index(mesh, names)
    if size != dist.get_world_size() or index != dist.get_rank():
        raise ValueError("the mesh must hold every rank of the process "
                         "group, in rank order")
    return index, size


def vertex_range(n: int, nranks: int, rank: int) -> tuple:
    """Vertices [start, stop) of rank ``rank``: blocks of ceil(n / nranks),
    the reference's padded shards with the padding cut off."""
    block = -(-n // nranks)
    start = min(n, rank * block)
    return start, min(n, start + block)


def build_sketches_distributed(graph: G.Graph, mesh, words: int,
                               num_hashes: int, seed: int = 0
                               ) -> torch.Tensor:
    """Vertex-sharded Bloom construction: int32[n, words] on every rank.

    Each rank builds the rows of its :func:`vertex_range` from its CSR
    rows (``sketches.build_bloom_range``, in bounded chunks), pads them to
    the block length and the blocks are all-gathered in rank order; the
    rows equal ``build_bloom(graph, words, num_hashes, seed)``.
    """
    rank, nranks = mesh_position(mesh)
    n = graph.n
    lo, hi = vertex_range(n, nranks, rank)
    if mesh is None:
        return SK.build_bloom_range(graph, words, lo, hi, num_hashes, seed)
    local = torch.zeros((-(-n // nranks), words), dtype=torch.int32,
                        device=graph.device)
    local[:hi - lo] = SK.build_bloom_range(graph, words, lo, hi, num_hashes,
                                           seed)
    blocks = [torch.empty_like(local) for _ in range(nranks)]
    dist.all_gather(blocks, local)
    return torch.cat(blocks)[:n]


def triangle_count_distributed(graph: G.Graph, bloom: torch.Tensor, mesh,
                               num_hashes: int) -> torch.Tensor:
    """Edge-sharded TC_AND: the engine's sharded fold of the Eq. 2
    estimates over every dim of ``mesh``, divided by 3 (float32 scalar).

    Under ``use_rules`` the edge list is split over all the mesh's dims,
    as the reference shards it over ``mesh.axis_names``: each rank folds
    its block (``engine.shard_edge_cardinalities``) in launches of
    ``plan_for``'s ``edge_chunk`` (the AND2 gather kernel on CUDA, its
    plain version on the CPU) and the partials are all-reduced over each
    dim in turn. No mesh is the local fold.
    """
    sketch = SK.SketchSet(data=bloom, kind="bf", num_hashes=num_hashes, k=0,
                          seed=0, n=graph.n)
    plan = ENG.plan_for(graph, sketch, shard_edges=True)
    rules = None if mesh is None else {"edge": tuple(mesh.mesh_dim_names)}
    with sharding.use_rules(mesh, rules):
        return ENG.sum_edge_cardinalities(graph, sketch, plan) / 3.0


def mine(graph: G.Graph, mesh=None, storage_budget: float = 0.25,
         num_hashes: int = 2, seed: int = 0,
         device: DeviceLike = DEFAULT_DEVICE) -> dict:
    """End-to-end distributed TC estimate over the ranks of ``mesh``.

    Every rank calls it with the same graph. With ``mesh`` None it runs
    over a one-dim ("data",) mesh of every rank when a process group is
    initialized, else alone (one shard, no collective). The graph moves
    to ``device`` first. Returns ``tc_estimate``, ``build_s``,
    ``mine_s`` (each ending with the device's work done), ``words`` and
    ``devices`` (the ranks).
    """
    dev = resolve_device(device)
    graph = graph.to(dev)
    if mesh is None and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(dev.type, (dist.get_world_size(),),
                                mesh_dim_names=("data",))
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the graph "
                         f"on {dev.type!r}")
    words = SK.bloom_words_for_budget(graph.n, graph.m, storage_budget)
    t0 = time.perf_counter()
    bloom = build_sketches_distributed(graph, mesh, words, num_hashes, seed)
    synchronize(bloom)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc = float(triangle_count_distributed(graph, bloom, mesh, num_hashes))
    t_mine = time.perf_counter() - t0
    return {"tc_estimate": tc, "build_s": t_build, "mine_s": t_mine,
            "words": words, "devices": mesh_position(mesh)[1]}


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


def _obs_lines(trace_path: Optional[str], with_metrics: bool) -> list:
    """The --metrics and --trace epilogue's output lines (the trace file
    is written here)."""
    lines = []
    if with_metrics:
        lines.append(json.dumps({"event": "metrics",
                                 "global": metrics.REGISTRY.snapshot()}))
    if trace_path:
        trace.export(trace_path)
        trace.disable()
        lines.append(f"trace -> {trace_path}")
    return lines


def _mine_run(opts: dict) -> list:
    """The ``mine()`` mode on this process, alone or as one rank of the
    process group: every rank generates the graph and mines; rank 0
    returns the output lines, the others an empty list."""
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if lead and opts["trace"]:
        trace.enable()
        trace.clear()
    dev = resolve_device(opts["device"])
    g = G.kronecker(opts["scale"], opts["edge_factor"], seed=1, device=dev)
    out = mine(g, storage_budget=opts["budget"], device=dev)
    if not lead:
        return []
    lines = [f"graph: n={g.n} m={g.m} d_max={g.d_max}",
             f"TC_AND={out['tc_estimate']:.0f}  build={out['build_s']:.2f}s "
             f"mine={out['mine_s']:.2f}s devices={out['devices']}"]
    exact = None
    if opts["exact"]:
        t0 = time.perf_counter()
        tc = int(X.exact_triangle_count(g))
        secs = time.perf_counter() - t0
        rel = abs(out["tc_estimate"] - tc) / max(tc, 1)
        exact = {"value": tc, "seconds": secs, "rel_err": rel}
        lines.append(f"TC_exact={tc} ({secs:.2f}s) rel_err={rel:.3f}")
    # machine-readable twin of the human output (one JSON line)
    lines.append(json.dumps({"event": "mine", "n": g.n, "m": g.m,
                             "d_max": g.d_max, "budget": opts["budget"],
                             "device": dev.type, **out, "exact": exact}))
    return lines + _obs_lines(opts["trace"], opts["metrics"])


def main(argv=None):
    """CLI: generate, sketch and mine; prints human lines and one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the mine() path: spawned (gloo on the "
                         "CPU, NCCL with one GPU each on cuda), or those of "
                         "torchrun")
    ap.add_argument("--scale", type=int, default=12, help="Kronecker scale")
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--budget", type=float, default=0.25)
    ap.add_argument("--exact", action="store_true",
                    help="also count triangles exactly (core/exact.py) and "
                         "print the TC estimate's relative error")
    ap.add_argument("--algos", type=str, default="",
                    help=f"comma list from {','.join(ALGOS)}: run a "
                         "multi-query engine session over one shared "
                         "sketch build on one device (default: the "
                         "distributed mine() path)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record spans and write a Chrome-trace/Perfetto "
                         "JSON of the run to this path")
    ap.add_argument("--metrics", action="store_true",
                    help="print a metric-registry snapshot JSON line")
    args = ap.parse_args(argv)

    if not args.algos:
        opts = {"scale": args.scale, "edge_factor": args.edge_factor,
                "budget": args.budget, "device": args.device,
                "exact": args.exact, "trace": args.trace,
                "metrics": args.metrics}
        if "WORLD_SIZE" in os.environ:
            world = int(os.environ["WORLD_SIZE"])
            if args.devices not in (1, world):
                ap.error(f"--devices {args.devices} under torchrun's "
                         f"{world} ranks")
            init_group("env://", world, int(os.environ["RANK"]),
                       resolve_device(args.device).type, timeout_s=60.0)
            try:
                lines = _mine_run(opts)
            finally:
                dist.destroy_process_group()
        elif args.devices > 1:
            lines = spawn(_mine_run, args.devices, (opts,),
                          device=args.device)[0]
        else:
            lines = _mine_run(opts)
        for line in lines:
            print(line)
        return
    if args.devices != 1:
        ap.error("--devices runs the mine() path, which takes no --algos")

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
    for line in _obs_lines(args.trace, args.metrics):
        print(line)


if __name__ == "__main__":
    main()
