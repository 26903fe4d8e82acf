"""Triangle Counting (paper Listing 1 + §VII estimators TC_★).

TC_★ = (1/3) Σ_{(u,v)∈E} |N_u ∩ N_v|_★ over canonical edges, with a
ProbGraph estimator as the cardinality provider. Execution (chunking,
kernel dispatch, edge layout) is the mining engine's: pass an
``EnginePlan`` or per-call kwargs (``edge_chunk=``, ``use_kernel=``, ...).
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import engine as eng
from ..graph import Graph
from ..intersect import CardFn
from ..sketches import SketchSet


def triangle_count(graph: Graph, sketch: Optional[SketchSet] = None,
                   card_fn: Optional[CardFn] = None,
                   plan: Optional[eng.EnginePlan] = None, **kw) -> torch.Tensor:
    """Returns the float32 TC estimate."""
    plan = eng.resolve_plan(plan, graph, sketch, kw)
    return eng.sum_edge_cardinalities(graph, sketch, plan, card_fn) / 3.0


def local_clustering_coefficient(graph: Graph,
                                 sketch: Optional[SketchSet] = None,
                                 plan: Optional[eng.EnginePlan] = None,
                                 edge_cards: Optional[torch.Tensor] = None,
                                 **kw) -> torch.Tensor:
    """Per-vertex clustering coefficient c_v = 2·t_v / (d_v (d_v−1)) where t_v
    sums |N_u∩N_v| over v's incident edges (a TC application, paper §III-A).

    ``edge_cards`` lets a MiningSession reuse its shared per-edge pass. On
    CUDA the per-vertex sums use float atomics, so their order (and the
    last bits of t_v) varies from run to run.
    """
    if edge_cards is None:
        plan = eng.resolve_plan(plan, graph, sketch, kw)
        edge_cards = eng.edge_cardinalities(graph, sketch, plan)
    edges = graph.edges
    tv = torch.zeros(graph.n, dtype=torch.float32, device=edge_cards.device)
    tv.index_add_(0, edges[:, 0].long(), edge_cards)
    tv.index_add_(0, edges[:, 1].long(), edge_cards)
    d = graph.deg.to(torch.float32)
    denom = torch.clamp(d * (d - 1.0), min=1.0)
    return tv / denom
