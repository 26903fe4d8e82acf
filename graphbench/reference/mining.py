"""ProbGraph's estimators and mining algorithms over the reference sketches.

Per-edge cardinalities (paper Eq. 2 for Bloom rows, Eq. 5 for k-Hash
rows), triangle count TC = (1/3)·Σ_edges |N_u ∩ N_v|, local clustering
c_v = 2·t_v / (d_v (d_v − 1)) with t_v the sum over v's edges, and the
4-clique count (1/4)·Σ_triangles |N_u ∩ N_v ∩ N_w| over the triangles
u < v < w whose closing test w ∈ N_u passes by Bloom membership. Counts
are exact integers; every floating-point step runs in ``dtype``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

from . import counts
from .graph import RefGraph
from .sketches import bloom_positions

#: edges whose counts are taken at once (rows gathered: EDGE_BLOCK × W)
EDGE_BLOCK = 1 << 20

#: wedge candidates one enumeration piece holds, about
PIECE = 1 << 26

#: triangles whose AND3 popcount is taken at once
TUPLE_BLOCK = 1 << 22


def edge_counts(g: RefGraph, kind: str, data: torch.Tensor) -> torch.Tensor:
    """int64[m]: popcount(B_u & B_v) (``kind`` "bf") or the aligned
    k-Hash matches of u and v (``kind`` "kh") for every edge (u, v)."""
    out = torch.empty(g.m, dtype=torch.int64, device=data.device)
    for s in range(0, g.m, EDGE_BLOCK):
        u, v = g.edges[s:s + EDGE_BLOCK, 0], g.edges[s:s + EDGE_BLOCK, 1]
        out[s:s + EDGE_BLOCK] = (counts.and_popcount(data, u, v)
                                 if kind == "bf"
                                 else counts.khash_matches(data, g.n, u, v))
    return out


def bloom_cardinality(ones: torch.Tensor, total_bits: int, num_hashes: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Eq. 2 (Swamidass on the AND): −(B/b)·ln(1 − ones/B), with ones
    capped at B − 1 (App. C-3)."""
    x = torch.clamp(ones, max=total_bits - 1).to(dtype)
    return -(total_bits / num_hashes) * torch.log1p(-x / total_bits)


def khash_cardinality(matches: torch.Tensor, k: int, du: torch.Tensor,
                      dv: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Eq. 5: Ĵ/(1 + Ĵ)·(|X| + |Y|) with Ĵ = matches / k."""
    j = matches.to(dtype) / k
    return j / (1.0 + j) * (du.to(dtype) + dv.to(dtype))


def edge_cardinalities(g: RefGraph, kind: str, data: torch.Tensor,
                       params: dict, dtype: torch.dtype) -> Tuple[
                           torch.Tensor, torch.Tensor]:
    """(int64 counts, ``dtype`` cardinalities) of every edge."""
    c = edge_counts(g, kind, data)
    if kind == "bf":
        return c, bloom_cardinality(c, params["total_bits"],
                                    params["num_hashes"], dtype)
    return c, khash_cardinality(c, params["k"], g.deg[g.edges[:, 0]],
                                g.deg[g.edges[:, 1]], dtype)


def triangle_count(cards: torch.Tensor) -> torch.Tensor:
    """(1/3)·Σ of the per-edge cardinalities, in their dtype."""
    return torch.sum(cards) / 3.0


def local_clustering(g: RefGraph, cards: torch.Tensor) -> torch.Tensor:
    """c_v = t_v / max(d_v (d_v − 1), 1) with t_v the sum of the
    cardinalities of v's edges, in the cardinalities' dtype (the 2 of
    2·t_v / (d_v (d_v − 1)) cancels against each edge counting once per
    endpoint)."""
    t = torch.zeros(g.n, dtype=cards.dtype, device=cards.device)
    t.index_add_(0, g.edges[:, 0], cards)
    t.index_add_(0, g.edges[:, 1], cards)
    d = g.deg.to(cards.dtype)
    return t / torch.clamp(d * (d - 1.0), min=1.0)


def _up_suffix(g: RefGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first CSR slot of v's neighbours above v, their count) per v."""
    rows = g.rows()
    below = torch.bincount(rows[g.indices < rows], minlength=g.n)
    return g.indptr[:-1] + below, g.deg - below


def _pieces(count: torch.Tensor, cap: int
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(item, rank) int64 per slot of items holding ``count[i]`` slots,
    in runs of whole items of about ``cap`` slots."""
    cum = torch.cumsum(count, 0)
    total = int(cum[-1]) if cum.numel() else 0
    marks = torch.arange(1, -(-total // cap), device=count.device) * cap
    cuts = torch.searchsorted(cum, marks, right=True)
    bounds = [0, *cuts.tolist(), count.numel()]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        item = torch.repeat_interleave(
            torch.arange(lo, hi, device=count.device), count[lo:hi])
        if item.numel():
            first = cum[lo] - count[lo]
            rank = (torch.arange(item.numel(), device=count.device) + first
                    - (cum[item] - count[item]))
            yield item, rank


def four_cliques(g: RefGraph, data: torch.Tensor, num_hashes: int,
                 seed: int, dtype: torch.dtype) -> dict:
    """The Bloom 4-clique estimate of ``data`` (int32[n, W] Bloom rows).

    Triangles u < v < w: every edge (u, v) with every neighbour w > v of
    v, kept when all of w's hash bits are set in u's row. Each adds
    Eq. 2 of popcount(B_u & B_v & B_w) in ``dtype``; the blocks' sums
    accumulate in float64 when ``dtype`` is float64 and in float32
    otherwise. Returns the estimate (the total / 4, as float) and the
    wedge candidates and triangles counted.
    """
    words = data.shape[1]
    total_bits = 32 * words
    pos = bloom_positions(torch.arange(g.n, device=data.device), num_hashes,
                          total_bits, seed).to(torch.int32)
    flat = data.view(-1)
    first, up = _up_suffix(g)
    u_all, v_all = g.edges[:, 0], g.edges[:, 1]
    acc_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    total = torch.zeros((), dtype=acc_dtype, device=data.device)
    candidates = triangles = 0
    for item, rank in _pieces(up[v_all], PIECE):
        u = u_all[item]
        w = g.indices[first[v_all[item]] + rank]
        p = pos[w]
        word = flat[u[:, None] * words + (p >> 5)]
        closed = (((word >> (p & 31)) & 1) == 1).all(-1)
        keep = torch.nonzero(closed).squeeze(1)
        candidates += item.numel()
        triangles += keep.numel()
        # B_u & B_v once per edge with a closed triangle
        edge, at = torch.unique_consecutive(item[keep], return_inverse=True)
        heads = data[u_all[edge]] & data[v_all[edge]]
        w = w[keep]
        for s in range(0, keep.numel(), TUPLE_BLOCK):
            ones = counts.popcount_rows(heads[at[s:s + TUPLE_BLOCK]]
                                        & data[w[s:s + TUPLE_BLOCK]])
            total += torch.sum(bloom_cardinality(ones, total_bits,
                                                 num_hashes, dtype)
                               ).to(acc_dtype)
    return {"estimate": float(total / 4.0), "wedge_candidates": candidates,
            "triangles": triangles}
