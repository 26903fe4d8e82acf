"""Exact set-intersection baselines over the CSR (paper Fig. 1, panel 2).

These serve double duty, as in ``repro.core.exact``: (1) the exact
baseline behind the speedup numbers, (2) the accuracy oracle of every
estimator.

The reference gallops over rows of the padded adjacency ``adj[n, d_max]``
(``vmap(searchsorted)``), which cannot exist at real size (Kronecker scale
21: ~860 GB). Here each tuple walks the CSR row of its endpoint of least
degree and looks every element up in the other endpoints' neighbourhoods:
Σ min(d_u, d_v) lookups per pair instead of d_u · log d_v over padded
rows. The elements are expanded in pieces of about ``_CHUNK_SLOTS``
(:func:`pieces`), so memory stays bounded at any degree. A lookup
``member(a, z)`` (z ∈ N_a) is a binary search of the sorted canonical
edge keys (:func:`key_member`); the clique counts share this code.

Integers are the reference's. Sums run in int64: Σ_e |N_u ∩ N_v| = 3·TC
passes 2^31 at Kronecker scale 21, where the reference's int32 total
wraps.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

from .graph import Graph, edge_keys, has_edge

#: element slots one piece holds, about; each takes a few int64
#: temporaries, so a piece stays near 2 GiB
_CHUNK_SLOTS = 1 << 25

#: ``member(a, z)``: bool, whether z ∈ N_a, elementwise over int64 ids
Member = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def pieces(counts: torch.Tensor, cap: int
           ) -> Iterator[Tuple[int, int, torch.Tensor, torch.Tensor]]:
    """Expand items of ``counts[i]`` slots each, in runs of whole items.

    Runs hold at most ``cap`` + max(counts) slots.
    For each run, yields its items i0 <= i < i1 (host ints) and (item,
    rank) int64 per slot: the slot's item index and its rank within the
    item.
    """
    if counts.numel() == 0:
        return
    dev = counts.device
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1])
    if total == 0:
        return
    marks = torch.arange(1, -(-total // cap), device=dev,
                         dtype=torch.int64) * cap
    bounds = torch.cat([torch.searchsorted(cum, marks, right=True),
                        torch.tensor([counts.numel()], device=dev)])
    ends = torch.where(bounds > 0, cum[(bounds - 1).clamp(min=0)], 0)
    start = cum - counts
    i0, base = 0, 0
    for i1, end in zip(bounds.tolist(), ends.tolist()):
        if end > base:
            item = torch.repeat_interleave(
                torch.arange(i0, i1, device=dev), counts[i0:i1],
                output_size=end - base)
            rank = torch.arange(base, end, device=dev) - start[item]
            yield i0, i1, item, rank
        i0, base = i1, end


def row_elements(graph: Graph, rows: torch.Tensor,
                 cap: int = _CHUNK_SLOTS
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]:
    """The CSR elements of vertices ``rows`` (int64[R]), in runs of whole
    rows (see :func:`pieces`): yields (item, rank, w) int64 per element,
    its index in ``rows``, its position in that row and its id; rows in
    order, each row's elements ascending."""
    indptr = graph.indptr.to(torch.int64)
    deg = graph.deg.to(torch.int64)
    for _, _, item, rank in pieces(deg[rows], cap):
        w = graph.indices[indptr[rows[item]] + rank].to(torch.int64)
        yield item, rank, w


def key_member(graph: Graph, keys: Optional[torch.Tensor] = None) -> Member:
    """z ∈ N_a by binary search of the sorted canonical edge keys
    (``keys`` = :func:`~repro_torch.core.graph.edge_keys`, built here when
    not given)."""
    keys = edge_keys(graph) if keys is None else keys
    n = graph.n

    def member(a: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return has_edge(keys, n, a, z)
    return member


def common_count(graph: Graph, tuples: torch.Tensor, member: Member,
                 cap: int = _CHUNK_SLOTS) -> torch.Tensor:
    """Exact |N_t0 ∩ ... ∩ N_tk-1| per row of int[T, k] -> int64[T]: walk
    the row of least degree, look each element up in the others."""
    tuples = tuples.to(torch.int64)
    deg = graph.deg.to(torch.int64)
    at = deg[tuples].argmin(1, keepdim=True)
    pivot = tuples.gather(1, at)[:, 0]
    # the other k - 1 columns (the pivot's own lookup always holds)
    others = tuples[torch.arange(tuples.shape[1], device=tuples.device)
                    != at].view(tuples.shape[0], tuples.shape[1] - 1)
    out = torch.zeros(tuples.shape[0], dtype=torch.int64,
                      device=tuples.device)
    for item, _, z in row_elements(graph, pivot, cap):
        ok = torch.ones_like(z, dtype=torch.bool)
        for j in range(others.shape[1]):
            ok &= member(others[item, j], z)
        out += torch.bincount(item[ok], minlength=tuples.shape[0])
    return out


def exact_pair_cardinalities(graph: Graph, pairs: torch.Tensor
                             ) -> torch.Tensor:
    """|N_u ∩ N_v| for a batch of vertex pairs int[P, 2]: int32[P]."""
    return common_count(graph, pairs, key_member(graph)).to(torch.int32)


def exact_pair_intersection_elements(graph: Graph, pairs: torch.Tensor
                                     ) -> torch.Tensor:
    """The intersection *elements* per pair: int32[P, d_max], the elements
    of N_u that lie in N_v at their positions in u's CSR row, every other
    slot the sentinel n (the reference's layout).

    The ``[P, d_max]`` result is for parity checks and small graphs; the
    port's Adamic–Adar / Resource-Allocation sum over the elements without
    it.
    """
    u = pairs[:, 0].to(torch.int64)
    v = pairs[:, 1].to(torch.int64)
    member = key_member(graph)
    out = torch.full((pairs.shape[0], graph.d_max), graph.n,
                     dtype=torch.int32, device=pairs.device)
    for item, rank, w in row_elements(graph, u):
        keep = member(v[item], w)
        out[item[keep], rank[keep]] = w[keep].to(torch.int32)
    return out


def exact_triangle_count(graph: Graph, edge_chunk: int = 65536
                         ) -> torch.Tensor:
    """TC = (1/3)·Σ_{(u,v)∈E} |N_u ∩ N_v| over canonical edges (u<v), as
    an int64 scalar, summed over chunks of ``edge_chunk`` edges.

    Over canonical edges each triangle {a<b<c} is counted once per edge =
    3 times, hence /3 (Listing 1 formulation).
    """
    member = key_member(graph)
    edges = graph.edges
    total = torch.zeros((), dtype=torch.int64, device=edges.device)
    for s in range(0, edges.shape[0], edge_chunk):
        total += common_count(graph, edges[s:s + edge_chunk], member).sum()
    return total // 3


__all__ = ["common_count", "exact_pair_cardinalities",
           "exact_pair_intersection_elements", "exact_triangle_count",
           "key_member", "pieces", "row_elements"]
