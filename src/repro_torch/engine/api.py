"""Stable engine facade for downstream packages (``launch``).

Downstream code imports plans, sessions, the fold/map executors and the
set-expression compiler from here instead of reaching into
``repro_torch.engine.engine`` / ``repro_torch.engine.plan``.
"""
from __future__ import annotations

from . import setexpr
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
from .plan import (
    EnginePlan,
    fold_edges,
    map_edges,
    order_edges_by_hub,
    plan_for,
    pow2_bucket,
)
from .setexpr import (
    CompiledSetExpr,
    Row,
    SetExpr,
    and_all,
    compile_expr,
    or_all,
    rows,
)

__all__ = [
    "CompiledSetExpr", "EnginePlan", "MiningSession", "Row", "SetExpr",
    "and_all", "compile_expr", "edge_cardinalities", "fold_edges",
    "map_edges", "or_all", "order_edges_by_hub", "pair_cardinality_fn",
    "plan_for", "pow2_bucket", "resolve_plan", "rows", "session", "setexpr",
    "sum_edge_cardinalities", "triple_cardinality_ones",
    "tuple_cardinality_ones",
]
