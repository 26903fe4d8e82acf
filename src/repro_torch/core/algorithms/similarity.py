"""Vertex similarity measures (paper Listing 3).

Jaccard / Overlap / Common / Total derive from |N_u∩N_v| + exact degrees,
for any sketch kind. Adamic-Adar / Resource-Allocation need the
intersection *elements*: u's neighbours are taken by CSR range, in the
pieces of ``core/exact.py``, and kept when they lie in N_v (the exact
lookup; the walk starts from the endpoint of smaller degree) or pass the
Bloom membership test against B_v (a ``bf`` sketch, the paper's "set
membership" primitive). Their weights are summed per pair in float64 and
returned as float32; other sketch kinds raise ``ValueError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import engine as eng
from .. import exact
from ..graph import Graph
from ..sketches import SketchSet, bloom_positions, bloom_test


def similarity_from_cardinalities(inter: torch.Tensor, du: torch.Tensor,
                                  dv: torch.Tensor,
                                  measure: str) -> torch.Tensor:
    """Derive a cardinality-based similarity from |N_u∩N_v| + degrees.

    The shared scoring step of Listing 3/4: one per-edge cardinality pass
    (e.g. a MiningSession's cache) feeds any of these measures.
    """
    if measure == "common":
        return inter
    if measure == "total":
        return du + dv - inter
    if measure == "jaccard":
        return inter / torch.clamp(du + dv - inter, min=1.0)
    if measure == "overlap":
        return inter / torch.clamp(torch.minimum(du, dv), min=1.0)
    raise ValueError(measure)


def pair_similarity(graph: Graph, pairs: torch.Tensor, measure: str,
                    sketch: Optional[SketchSet] = None,
                    plan: Optional[eng.EnginePlan] = None,
                    **kw) -> torch.Tensor:
    """measure ∈ {jaccard, overlap, common, total, adamic_adar,
    resource_alloc}: float32[P] for int32[P, 2] vertex pairs."""
    if measure in ("jaccard", "overlap", "common", "total"):
        du = graph.deg[pairs[:, 0].long()].to(torch.float32)
        dv = graph.deg[pairs[:, 1].long()].to(torch.float32)
        plan = eng.resolve_plan(plan, graph, sketch, kw)
        inter = eng.edge_cardinalities(graph, sketch, plan, edges=pairs)
        return similarity_from_cardinalities(inter, du, dv, measure)
    if measure in ("adamic_adar", "resource_alloc"):
        return _common_neighbour_weights(graph, pairs, measure, sketch)
    raise ValueError(measure)


def _common_neighbour_weights(graph: Graph, pairs: torch.Tensor,
                              measure: str,
                              sketch: Optional[SketchSet]) -> torch.Tensor:
    """Σ over w ∈ N_u ∩ N_v (exact, or w ∈ N_u passing the Bloom test
    against B_v) of 1/log(d_w) (Adamic-Adar) or 1/d_w (Resource-Allocation),
    with the reference's clamps: float32[P]."""
    u = pairs[:, 0].to(torch.int64)
    v = pairs[:, 1].to(torch.int64)
    if sketch is None:
        # the set is symmetric: walk the smaller neighbourhood
        deg = graph.deg
        swap = deg[u] > deg[v]
        u, v = torch.where(swap, v, u), torch.where(swap, u, v)
        member = exact.key_member(graph)
    elif sketch.kind == "bf":
        def member(rows, w):
            return bloom_test(sketch.data, rows, bloom_positions(
                w, sketch.num_hashes, sketch.total_bits, sketch.seed))
    else:
        raise ValueError(f"{measure} needs exact or BF representation")
    out = torch.zeros(pairs.shape[0], dtype=torch.float64,
                      device=pairs.device)
    for item, _, w in exact.row_elements(graph, u):
        keep = member(v[item], w)
        dw = graph.deg[w[keep]].to(torch.float32)
        if measure == "adamic_adar":
            weight = 1.0 / torch.clamp(torch.log(torch.clamp(dw, min=2.0)),
                                       min=1e-6)
        else:
            weight = 1.0 / torch.clamp(dw, min=1.0)
        out.index_add_(0, item[keep], weight.to(torch.float64))
    return out.to(torch.float32)
