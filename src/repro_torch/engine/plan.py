"""Execution planning for the batched mining engine.

An :class:`EnginePlan` is the single description of *how* set-intersection
work runs: edge chunking, kernel dispatch, estimator selection and the
degree-ordered edge layout. Its fields and defaults are the reference's,
so a plan here compares equal (``dataclasses.asdict``) to the reference
plan for the same graph and options.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core.graph import Graph
from ..core.sketches import SketchSet


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """Static execution parameters shared by all mining algorithms.

    Attributes:
      edge_chunk:   edges per kernel launch / fold step (bounds the memory
                    one chunk's gathered rows take in the plain path).
      block_e:      accepted and ignored by the CUDA kernels, which map one
                    group of lanes to each tuple; kept so plans compare
                    equal across packages.
      block_w:      accepted and ignored by the CUDA kernels, which loop
                    over a row's words inside the group; kept for the same
                    reason.
      use_kernel:   route Bloom popcounts through the CUDA kernels (needs
                    CUDA tensors); False runs the plain PyTorch version.
      degree_order: sort edges by hub endpoint so consecutive tuples re-read
                    the same hub rows while they sit in L2.
      estimator:    estimator override (e.g. "bf_l" on a "bf" sketch).
      variant:      1-Hash Jaccard variant ("union" | "naive").
      shard_edges:  split the edge fold over the ranks of the mesh that
                    ``distributed.sharding.use_rules`` installs.
      sweep_cap:    max swept prefix length for local clustering sweep cuts.
      frontier_mode: PPR push frontier layout ("dense" | "sparse" | "auto").
      frontier_cap: explicit sparse-frontier capacity override.
    """

    edge_chunk: int = 65536
    block_e: int = 8
    block_w: int = 512
    use_kernel: bool = False
    degree_order: bool = False
    estimator: Optional[str] = None
    variant: str = "union"
    shard_edges: bool = False
    sweep_cap: int = 512
    frontier_mode: str = "auto"
    frontier_cap: Optional[int] = None

    def with_(self, **overrides) -> "EnginePlan":
        """Return a copy of this plan with the given fields replaced."""
        return dataclasses.replace(self, **overrides)


def pow2_bucket(size: int, lo: int = 1) -> int:
    """Next power of two ≥ max(size, lo)."""
    return max(lo, 1 << (max(int(size), 1) - 1).bit_length())


def plan_for(graph: Graph, sketch: Optional[SketchSet] = None,
             **overrides) -> EnginePlan:
    """Default plan for a (graph, sketch) pair.

    ``use_kernel`` follows the graph's device (True on CUDA) unless
    overridden, and ``degree_order`` follows ``use_kernel``. The chunk is
    clamped so one chunk's gathered rows stay near 16 MiB (2**22 words):
    that bounds the plain path's temporaries, and on the kernel path it
    sets the tuples per launch.
    """
    words = (sketch.data.shape[1]
             if sketch is not None and sketch.kind == "bf" else 64)
    target_words = 1 << 22
    chunk = max(1024, min(65536, target_words // max(words, 1)))
    use_kernel = bool(overrides.get("use_kernel",
                                    graph.device.type == "cuda"))
    base = EnginePlan(edge_chunk=int(chunk), use_kernel=use_kernel,
                      degree_order=use_kernel)
    return base.with_(**overrides)


# ----------------------------------------------------------------------------
# edge layout: degree-bucketed ordering for hub-row reuse
# ----------------------------------------------------------------------------

def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def hub_order(graph: Graph, edges: torch.Tensor) -> torch.Tensor:
    """The permutation (int64[m]) that lists edges so consecutive tuples
    revisit hub rows.

    Sort key is (hub degree bucket desc, hub id), ties in input order: the
    permutation of the reference's ``lexsort((hub, -bucket))``, built from
    stable sorts applied last key first.
    """
    du = graph.deg[edges[:, 0].long()]
    dv = graph.deg[edges[:, 1].long()]
    hub = torch.where(du >= dv, edges[:, 0], edges[:, 1])
    hub_deg = torch.maximum(du, dv)
    # bucket = floor(log2(deg)) + 1, via the float exponent; descending so
    # hub-heavy edges lead the schedule
    bucket = torch.frexp(torch.clamp(hub_deg, min=1).to(torch.float32))[1]
    perm = _stable_argsort(hub)
    return perm[_stable_argsort(-bucket[perm])]


def order_edges_by_hub(graph: Graph, edges: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edges in :func:`hub_order`, and the inverse permutation: returns
    (edges_sorted, inv) with ``values_sorted[inv] ==
    values_original_order``."""
    perm = hub_order(graph, edges)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return edges[perm], inv


# ----------------------------------------------------------------------------
# chunked fold / map over edge-like index arrays
# ----------------------------------------------------------------------------

def _chunks(m: int, chunk: int):
    return ((s, min(s + chunk, m)) for s in range(0, m, chunk))


def fold_edges_masked(edges: torch.Tensor, mask: torch.Tensor,
                      chunk_fn: Callable, plan: EnginePlan) -> torch.Tensor:
    """Fold of ``chunk_fn(pairs, mask) -> scalar`` over chunks with a
    caller-supplied validity mask (float32 scalar)."""
    total = torch.zeros((), dtype=torch.float32, device=edges.device)
    for s, e in _chunks(edges.shape[0], plan.edge_chunk):
        total = total + chunk_fn(edges[s:e], mask[s:e])
    return total


def fold_edges(edges: torch.Tensor, chunk_fn: Callable,
               plan: EnginePlan) -> torch.Tensor:
    """Masked fold of ``chunk_fn(pairs, mask) -> scalar`` over chunks.

    Chunks need no padding: the kernels take any tuple count, so every
    mask is all-true and kept only for the shared ``chunk_fn`` signature.
    """
    mask = torch.ones(edges.shape[0], dtype=torch.bool, device=edges.device)
    return fold_edges_masked(edges, mask, chunk_fn, plan)


def edge_shard(m: int, nshards: int, index: int,
               edge_chunk: int) -> Tuple[int, int]:
    """Rows [start, stop) of shard ``index`` of ``nshards`` over ``m`` edges.

    The reference pads the edge list to a multiple of ``nshards ·
    min(edge_chunk, m)`` and gives each shard a contiguous block of the
    padded list; this is that block with the padding cut off (a shard
    past the last edge is empty). Each block's length is a multiple of
    the fold's chunk, so the fold's chunks inside it are the reference
    shard's.
    """
    pad = (-m) % (nshards * min(edge_chunk, max(m, 1)))
    block = (m + pad) // nshards
    start = min(m, index * block)
    return start, min(m, start + block)


def fold_edge_shard(edges: torch.Tensor, chunk_fn: Callable,
                    plan: EnginePlan, index: int,
                    nshards: int) -> torch.Tensor:
    """The fold of :func:`fold_edges` over shard ``index`` of ``nshards``
    (:func:`edge_shard`): one rank's partial sum before the reduction."""
    start, stop = edge_shard(edges.shape[0], nshards, index, plan.edge_chunk)
    return fold_edges(edges[start:stop], chunk_fn, plan)


def map_edges(edges: torch.Tensor, chunk_fn: Callable,
              plan: EnginePlan) -> torch.Tensor:
    """Chunked map of ``chunk_fn(pairs) -> [C]`` over edges; returns [m]."""
    out = torch.empty(edges.shape[0], dtype=torch.float32,
                      device=edges.device)
    for s, e in _chunks(edges.shape[0], plan.edge_chunk):
        out[s:e] = chunk_fn(edges[s:e])
    return out
