"""Uniform |N_u ∩ N_v| providers over ProbGraph estimators.

``make_pair_cardinality_fn(graph, sketch)`` returns a batched function
pairs[P,2] -> float32[P]: the paper's "plug in PG routines in place of
exact set intersections" (Listing 6). This slice ports the Bloom branch
(the AND, limit and OR estimators); the exact baseline and the MinHash
and KMV kinds come with a later slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import estimators as est
from .graph import Graph
from .sketches import SketchSet

CardFn = Callable[[torch.Tensor], torch.Tensor]


def make_pair_cardinality_fn(graph: Graph, sketch: Optional[SketchSet] = None,
                             *, use_kernel: bool = False,
                             variant: str = "union",
                             estimator: Optional[str] = None,
                             block_e: int = 8, block_w: int = 512) -> CardFn:
    """Build the batched pairs[P, 2] -> float32[P] cardinality provider."""
    if sketch is None:
        raise NotImplementedError(
            "exact intersections (sketch=None) are not ported yet")
    if sketch.kind != "bf":
        if sketch.kind in ("kh", "1h", "kmv"):
            raise NotImplementedError(
                f"sketch kind {sketch.kind!r} is not ported yet")
        raise ValueError(f"unknown sketch kind {sketch.kind}")

    # the kernel and the plain path are lowerings of one compiled set
    # expression, so their popcounts, and hence the estimates, are
    # identical; the lazy import keeps core -> engine out of load order
    from ..engine import setexpr

    kind = estimator or sketch.kind
    deg = graph.deg
    data = sketch.data
    b = sketch.num_hashes
    total_bits = data.shape[1] * 32
    u_row, v_row = setexpr.rows(2)
    expr = (u_row | v_row) if kind == "bf_or" else (u_row & v_row)
    ce = setexpr.compile_expr(expr, block_e=block_e, block_w=block_w,
                              use_kernel=use_kernel)

    def bf_fn(pairs: torch.Tensor) -> torch.Tensor:
        """Per-pair BF estimate from the compiled expression's ones."""
        ones = ce.ones(data, pairs)
        if kind == "bf_l":
            return ones.to(torch.float32) / b
        if kind == "bf_or":
            du = deg[pairs[:, 0].long()].to(torch.float32)
            dv = deg[pairs[:, 1].long()].to(torch.float32)
            union_est = est.bf_intersection_and_from_ones(ones, total_bits, b)
            return du + dv - union_est
        return est.bf_intersection_and_from_ones(ones, total_bits, b)
    return bf_fn
