"""Job kind ``mine_ranks`` (the tests' only): the program's ``mine()``
path over a cell's ranks, for the harness's rank path.

``load`` all-gathers the ranks' shares of the raw edges and loads the
whole graph on every rank (``from_edge_array``). A job builds the Bloom
rows of the rank's vertex range and all-gathers them
(``launch/mine.py`` ``build_sketches_distributed``), then folds the
rank's block of the edges and all-reduces the estimate
(``triangle_count_distributed``). Compared on each rank: the rows of its
range in the program's graph, the whole all-gathered sketch and the
triangle count, against the reference's range graph: its Bloom rows,
all-gathered, and the plain TC of its edges, summed over the ranks with
``all_reduce``.

Mix keys the tests plant faults with: ``fault_rank`` alters that rank's
triangle count where it is produced; ``raise_rank`` and ``hang_rank``
make that rank raise or hang in its first job; ``import_rank`` has that
rank's ``check_graph`` load a module named ``flax`` (an empty stand-in);
``pid_dir`` has each rank write its process id there.
"""
from __future__ import annotations

import os
import sys
import time
import types
from typing import List

import torch
import torch.distributed as dist

from graphbench import checks
from graphbench.reference import mining, sketches

LIMITS = {"csr_diff": 0.0, "sketch_diff": 0.0, "tc_gap": 1e-4}

#: the mesh over every rank, made once a process
_MESH = {}


def _mesh(ctx):
    if ctx.world == 1:
        return None
    if "mesh" not in _MESH:
        from torch.distributed.device_mesh import init_device_mesh

        _MESH["mesh"] = init_device_mesh(ctx.device.type, (ctx.world,),
                                         mesh_dim_names=("data",))
    return _MESH["mesh"]


def _all_gather_rows(ctx, part: torch.Tensor) -> torch.Tensor:
    """Every rank's ``part`` (rows of any count) in rank order."""
    if ctx.world == 1:
        return part
    size = torch.tensor([part.shape[0]], device=part.device)
    sizes = [torch.empty_like(size) for _ in range(ctx.world)]
    dist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    pad = torch.zeros((max(sizes), *part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    pad[:part.shape[0]] = part
    blocks = [torch.empty_like(pad) for _ in range(ctx.world)]
    dist.all_gather(blocks, pad)
    return torch.cat([b[:s] for b, s in zip(blocks, sizes)])


def _total(ctx, value: torch.Tensor) -> torch.Tensor:
    if ctx.world > 1:
        dist.all_reduce(value)
    return value


def load(ctx, share):
    """The whole graph on every rank, from the ranks' shares."""
    from repro_torch.core.graph import from_edge_array

    if "pid_dir" in ctx.mix:
        with open(os.path.join(ctx.mix["pid_dir"], f"rank{ctx.rank}"),
                  "w") as fh:
            fh.write(str(os.getpid()))
    raw = _all_gather_rows(ctx, torch.from_numpy(share).to(ctx.device))
    return from_edge_array(1 << ctx.config["scale"], raw.cpu().numpy(),
                           device=ctx.device)


def run(ctx, seed: int, probe) -> dict:
    """One job through the program's mine() path."""
    from repro_torch.core import sketches as port_sketches
    from repro_torch.launch import mine

    if ctx.mix.get("raise_rank") == ctx.rank:
        raise RuntimeError(f"planted failure on rank {ctx.rank}")
    if ctx.mix.get("hang_rank") == ctx.rank:
        time.sleep(3600)
    cfg, g = ctx.config, ctx.graph
    mesh = _mesh(ctx)
    words = port_sketches.bloom_words_for_budget(g.n, g.m,
                                                 cfg["storage_budget"])
    with probe.phase("build"):
        bloom = mine.build_sketches_distributed(g, mesh, words,
                                                cfg["num_hashes"], seed)
    with probe.phase("tc"):
        tc = float(mine.triangle_count_distributed(g, bloom, mesh,
                                                   cfg["num_hashes"]))
    if ctx.mix.get("fault_rank") == ctx.rank:
        tc *= 1.001
    return {"sketch": bloom, "tc": tc}


def counters(out: dict) -> dict:
    return {}


def keep(out: dict) -> dict:
    return out


def check_graph(ctx, graph, rg) -> List[checks.Check]:
    """``csr_diff``: entries of the rank's rows of the program's graph (and
    its sizes) that differ from the reference's range."""
    if ctx.mix.get("import_rank") == ctx.rank:
        sys.modules.setdefault("flax", types.ModuleType("flax"))
    lo, hi = ctx.vertex_range
    m = int(_total(ctx, torch.tensor([rg.m], device=ctx.device)))
    bad = int(graph.n != rg.n) + int(graph.m != m)
    first, last = int(graph.indptr[lo]), int(graph.indptr[hi])
    u = graph.edges[:, 0]
    for got, want in (
            (graph.indptr[lo:hi + 1] - first, rg.indptr),
            (graph.indices[first:last], rg.indices),
            (graph.deg[lo:hi], rg.deg),
            (graph.edges[(u >= lo) & (u < hi)], rg.edges)):
        bad += checks.mismatches(got.to(torch.int64), want)
    return [checks.Check("csr_diff", float(bad), 0.0)]


def reference(ctx, rg, seed: int, dtype: torch.dtype) -> dict:
    """The same job by the plain reference, floats in ``dtype``."""
    cfg = ctx.config
    m = int(_total(ctx, torch.tensor([rg.m], device=ctx.device)))
    words = sketches.bloom_words(rg.n, m, cfg["storage_budget"])
    data = _all_gather_rows(ctx, sketches.bloom(rg, words, cfg["num_hashes"],
                                                seed))
    params = {"total_bits": 32 * words, "num_hashes": cfg["num_hashes"]}
    _, cards = mining.edge_cardinalities(rg, "bf", data, params, dtype)
    part = torch.sum(cards).to(torch.float64).reshape(1)
    return {"sketch": data, "tc": float(_total(ctx, part)) / 3.0}


def compare(got: dict, want: dict, rg) -> List[checks.Check]:
    gap = abs(got["tc"] - want["tc"]) / abs(want["tc"])
    values = {"sketch_diff": checks.mismatches(got["sketch"], want["sketch"]),
              "tc_gap": gap if gap == gap else float("inf")}
    return [checks.Check(k, float(v), LIMITS[k]) for k, v in values.items()]
