"""Vertex similarity measures (paper Listing 3).

Jaccard / Overlap / Common / Total derive from |N_u∩N_v| + exact degrees,
for any sketch kind. Adamic-Adar / Resource-Allocation need the
intersection *elements* (a Bloom membership test over the padded
adjacency, or the exact baseline of ``core/exact.py``); neither is ported
yet, so they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import engine as eng
from ..graph import Graph
from ..sketches import SketchSet


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
    """measure ∈ {jaccard, overlap, common, total}: float32[P] for int32[P, 2]
    vertex pairs (adamic_adar and resource_alloc are not ported yet)."""
    if measure in ("jaccard", "overlap", "common", "total"):
        du = graph.deg[pairs[:, 0].long()].to(torch.float32)
        dv = graph.deg[pairs[:, 1].long()].to(torch.float32)
        plan = eng.resolve_plan(plan, graph, sketch, kw)
        inter = eng.edge_cardinalities(graph, sketch, plan, edges=pairs)
        return similarity_from_cardinalities(inter, du, dv, measure)
    if measure in ("adamic_adar", "resource_alloc"):
        raise NotImplementedError(
            f"{measure} needs Bloom membership over the padded adjacency "
            "and core/exact.py, which are not ported yet")
    raise ValueError(measure)
