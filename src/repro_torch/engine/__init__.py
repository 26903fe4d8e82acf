"""Batched mining engine: the shared execution seam for ProbGraph algorithms.

``EnginePlan`` describes *how* set-intersection work runs (chunking,
kernel dispatch, estimator selection, edge layout); ``session`` amortizes
one sketch build across queries; ``setexpr`` is the set-expression
compiler every sketch popcount routes through. Downstream packages import
from :mod:`repro_torch.engine.api`, the facade that pins the surface.
"""
from . import api, setexpr
from .engine import (
    DeviceCarry,
    Footprint,
    MiningSession,
    edge_cardinalities,
    fuses_edge_pass,
    pair_cardinality_fn,
    resolve_plan,
    segment_cardinality_ones,
    session,
    shard_edge_cardinalities,
    sum_edge_cardinalities,
    triple_cardinality_ones,
    tuple_cardinality_ones,
    wedge_quad_ones,
    wedge_triple_ones,
)
from .plan import (EnginePlan, edge_shard, fold_edge_shard, fold_edges,
                   fold_edges_masked, hub_order, map_edges,
                   order_edges_by_hub, plan_for, pow2_bucket)

__all__ = [
    "DeviceCarry", "EnginePlan", "Footprint", "MiningSession", "api",
    "edge_cardinalities", "edge_shard", "fold_edge_shard",
    "fold_edges", "fold_edges_masked", "fuses_edge_pass", "hub_order",
    "map_edges", "order_edges_by_hub",
    "pair_cardinality_fn", "plan_for", "pow2_bucket", "resolve_plan",
    "segment_cardinality_ones", "session", "setexpr",
    "shard_edge_cardinalities", "sum_edge_cardinalities",
    "triple_cardinality_ones", "tuple_cardinality_ones", "wedge_quad_ones",
    "wedge_triple_ones",
]
