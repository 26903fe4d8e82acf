"""Jarvis–Patrick clustering (paper Listing 4).

Two vertices u, v end up in the same cluster iff they are adjacent AND their
vertex similarity passes a threshold. Similarity ∈ {common (|N_u∩N_v| ≥ τ),
jaccard, overlap} — all driven by the |X∩Y| provider of any sketch kind.

Connected components over the kept edges run as data-parallel min-label
propagation: scatter-min over both endpoints, then pointer jumping, until
no label changes. The reference runs it in one ``lax.while_loop``; here the
loop is on the host, and reading ``changed`` costs one device sync per
iteration. The iteration count is kept in the ``cluster_cc_iterations``
gauge of :data:`repro_torch.obs.metrics.REGISTRY`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import engine as eng
from ...obs.metrics import REGISTRY
from ..graph import Graph
from ..sketches import SketchSet


def _connected_components(n: int, edges: torch.Tensor, keep: torch.Tensor,
                          max_iters: int = 200) -> torch.Tensor:
    """int32[n] labels: the smallest vertex id reachable over kept edges
    (after at most ``max_iters`` rounds, as the reference stops)."""
    u, v = edges[:, 0].long(), edges[:, 1].long()
    labels = torch.arange(n, dtype=torch.int32, device=edges.device)
    it, changed = 0, True
    while changed and it < max_iters:
        lu, lv = labels[u], labels[v]
        new_edge_label = torch.minimum(lu, lv)
        new = labels.scatter_reduce(0, u, torch.where(keep, new_edge_label,
                                                      lu), "amin")
        new.scatter_reduce_(0, v, torch.where(keep, new_edge_label, lv),
                            "amin")
        # pointer jumping: labels <- labels[labels] (halves chain length)
        new = new[new.long()]
        changed = bool(torch.any(new != labels))
        labels, it = new, it + 1
    REGISTRY.gauge("cluster_cc_iterations").set(it)
    return labels


def jarvis_patrick(graph: Graph, sketch: Optional[SketchSet] = None,
                   similarity: str = "common", threshold: float = 2.0,
                   plan: Optional[eng.EnginePlan] = None,
                   edge_cards: Optional[torch.Tensor] = None, **kw):
    """Returns (labels int32[n], num_clusters int64 scalar).

    similarity: 'common' (|N_u∩N_v| ≥ threshold), 'jaccard' or 'overlap'
    (ratio ≥ threshold). ``edge_cards`` lets a MiningSession reuse its
    shared per-edge cardinality pass.
    """
    from .similarity import similarity_from_cardinalities

    edges = graph.edges
    if edge_cards is None:
        plan = eng.resolve_plan(plan, graph, sketch, kw)
        edge_cards = eng.edge_cardinalities(graph, sketch, plan)
    du = graph.deg[edges[:, 0].long()].to(torch.float32)
    dv = graph.deg[edges[:, 1].long()].to(torch.float32)
    score = similarity_from_cardinalities(edge_cards, du, dv, similarity)
    keep = score >= threshold
    labels = _connected_components(graph.n, edges, keep)
    # every vertex is its own cluster when no kept edge touches it (the
    # paper counts all clusters)
    num = torch.sum(labels == torch.arange(graph.n, dtype=torch.int32,
                                           device=labels.device))
    return labels, num
