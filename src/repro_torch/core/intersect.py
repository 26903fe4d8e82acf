"""Uniform |N_u ∩ N_v| providers over ProbGraph estimators.

``make_pair_cardinality_fn(graph, sketch)`` returns a batched function
pairs[P,2] -> float32[P]: the paper's "plug in PG routines in place of
exact set intersections" (Listing 6). Every sketch kind is ported: Bloom
(the AND, limit and OR estimators), k-Hash, 1-Hash (``variant`` "union"
or "naive") and KMV. ``use_kernel`` routes the Bloom popcounts and the
MinHash match counts through the CUDA kernels; the k-Hash and 1-Hash
naive counts then read each pair's rows from the sketch by id. The exact
baseline (``sketch=None``) needs ``core/exact.py`` and is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import estimators as est
from .graph import Graph
from .sketches import SketchSet, onehash_values

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
    if sketch.kind == "bf":
        return _bloom_fn(graph, sketch, use_kernel, estimator, block_e,
                         block_w)
    if sketch.kind not in ("kh", "1h", "kmv"):
        raise ValueError(f"unknown sketch kind {sketch.kind}")

    # lazy import: ``repro_torch.kernels`` imports ``core.estimators``
    from ..kernels import ops

    data, deg, n = sketch.data, graph.deg, sketch.n
    # with the kernels, the k-Hash and 1-Hash naive counts read each pair's
    # rows from the sketch by id (the gather form): no row copies
    count = None
    if use_kernel and sketch.kind == "kh":
        count = "khash_match_gather"
    elif use_kernel and sketch.kind == "1h" and variant == "naive":
        count = "mh_intersect_gather"

    def minhash_fn(pairs: torch.Tensor) -> torch.Tensor:
        """Per-pair MinHash/KMV estimate from the gathered sketch rows."""
        u, v = pairs[:, 0].long(), pairs[:, 1].long()
        du, dv = deg[u], deg[v]
        if count is not None:
            matches = getattr(ops, count)(data, pairs, n, use_kernel=True)
            return est.minhash_intersection(
                matches.to(torch.float32) / data.shape[1], du, dv)
        ru, rv = data.index_select(0, u), data.index_select(0, v)
        if sketch.kind == "kh":
            return est.khash_intersection(ru, rv, du, dv, n,
                                          use_kernel=use_kernel)
        if sketch.kind == "kmv":
            return est.kmv_intersection(ru, rv, du, dv)
        if variant == "naive":
            return est.onehash_intersection(ru, rv, None, None, du, dv, n,
                                            "naive", use_kernel=use_kernel)
        return est.onehash_intersection(
            ru, rv, onehash_values(ru, n, sketch.seed),
            onehash_values(rv, n, sketch.seed), du, dv, n, variant)
    return minhash_fn


def _bloom_fn(graph: Graph, sketch: SketchSet, use_kernel: bool,
              estimator: Optional[str], block_e: int, block_w: int) -> CardFn:
    """The Bloom branch: one compiled set expression per estimator."""
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
