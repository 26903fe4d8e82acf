"""Batched mining engine: the shared execution seam for ProbGraph algorithms.

``EnginePlan`` describes *how* set-intersection work runs (chunking,
kernel dispatch, estimator selection, edge layout); ``session`` amortizes
one sketch build across queries; ``setexpr`` is the set-expression
compiler every sketch popcount routes through. Downstream packages import
from :mod:`repro_torch.engine.api`, the facade that pins the surface.
"""
from . import api, setexpr
from .engine import (
    MiningSession,
    edge_cardinalities,
    pair_cardinality_fn,
    resolve_plan,
    session,
    sum_edge_cardinalities,
    triple_cardinality_ones,
    tuple_cardinality_ones,
)
from .plan import (EnginePlan, fold_edges, fold_edges_masked, map_edges,
                   order_edges_by_hub, plan_for, pow2_bucket)

__all__ = [
    "EnginePlan", "MiningSession", "api", "edge_cardinalities",
    "fold_edges", "fold_edges_masked", "map_edges", "order_edges_by_hub",
    "pair_cardinality_fn", "plan_for", "pow2_bucket", "resolve_plan",
    "session", "setexpr", "sum_edge_cardinalities",
    "triple_cardinality_ones", "tuple_cardinality_ones",
]
