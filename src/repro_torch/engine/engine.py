"""Batched mining engine: one execution seam for the ProbGraph algorithms.

  * ``pair_cardinality_fn`` — the |N_u ∩ N_v| provider, plan-dispatched
    between the CUDA popcount kernels and the plain PyTorch path.
  * ``edge_cardinalities`` / ``sum_edge_cardinalities`` — chunked per-edge
    map / fold over an edge list with the degree-ordered layout.
  * ``tuple_cardinality_ones`` / ``triple_cardinality_ones`` — the k-way
    popcount provider over row-index tuples, compiled from the k-way AND
    set expression (``repro_torch.engine.setexpr``);
    ``segment_cardinality_ones`` — the same over tuples grouped by their
    first k-1 rows (the clique passes' form); ``wedge_triple_ones``
    / ``wedge_quad_ones`` — the same over the reference's wedge grids.
  * ``session`` — build the sketch once (Bloom, k-Hash, 1-Hash or KMV;
    or none, the exact baseline) and run TC, LCC, 4- and 5-clique counts,
    Jarvis–Patrick clustering, the similarities and local clustering over
    it (TC, LCC and clustering share one per-edge cardinality pass).

Edge sharding (``shard_edges=True``), the streaming refresh
(``DeviceCarry``) and the footprints of the serving tier come with later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..core.estimators import _popcount_words
from ..core.graph import Graph
from ..core.intersect import CardFn, make_pair_cardinality_fn
from ..core.sketches import SketchSet, build as build_sketch
from ..kernels import fused_expr, ref
from ..obs import trace
from . import setexpr
from .plan import (EnginePlan, fold_edges, map_edges, order_edges_by_hub,
                   plan_for)

_PLAN_KWARGS = ("edge_chunk", "block_e", "block_w", "use_kernel",
                "degree_order", "estimator", "variant", "shard_edges",
                "sweep_cap", "frontier_mode", "frontier_cap")


def resolve_plan(plan: Optional[EnginePlan], graph: Graph,
                 sketch: Optional[SketchSet] = None, kw: Optional[dict] = None
                 ) -> EnginePlan:
    """Merge per-call kwargs (edge_chunk=, use_kernel=, ...) into a plan."""
    kw = kw or {}
    unknown = set(kw) - set(_PLAN_KWARGS)
    if unknown:
        raise TypeError(f"unknown plan option(s): {sorted(unknown)}")
    plan = plan_for(graph, sketch, **kw) if plan is None else (
        plan.with_(**kw) if kw else plan)
    if plan.shard_edges:
        raise NotImplementedError("shard_edges=True is not ported yet")
    return plan


def pair_cardinality_fn(graph: Graph, sketch: Optional[SketchSet],
                        plan: EnginePlan) -> CardFn:
    """The single |N_u ∩ N_v| seam, dispatched by the plan."""
    return make_pair_cardinality_fn(
        graph, sketch, use_kernel=plan.use_kernel, variant=plan.variant,
        estimator=plan.estimator, block_e=plan.block_e, block_w=plan.block_w)


def edge_cardinalities(graph: Graph, sketch: Optional[SketchSet],
                       plan: EnginePlan,
                       edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge |N_u ∩ N_v| (float32[m]) in the caller's edge order.

    The degree-ordered layout is applied internally (and inverted on the
    way out) so the kernel sees hub-clustered tuples.
    """
    fn = pair_cardinality_fn(graph, sketch, plan)
    edges = graph.edges if edges is None else edges
    if plan.degree_order and edges.shape[0] > 1:
        edges_s, inv = order_edges_by_hub(graph, edges)
        return map_edges(edges_s, fn, plan)[inv]
    return map_edges(edges, fn, plan)


def sum_edge_cardinalities(graph: Graph, sketch: Optional[SketchSet],
                           plan: EnginePlan,
                           card_fn: Optional[CardFn] = None) -> torch.Tensor:
    """Σ_{(u,v)∈E} |N_u ∩ N_v| — the TC numerator, fold-executed."""
    if plan.shard_edges:
        raise NotImplementedError("shard_edges=True is not ported yet")
    fn = card_fn or pair_cardinality_fn(graph, sketch, plan)
    edges = graph.edges
    if plan.degree_order and edges.shape[0] > 1:
        edges, _ = order_edges_by_hub(graph, edges)   # sums need no unsort

    def chunk(pairs, mask):
        """Masked partial sum of one edge chunk's cardinalities."""
        return torch.sum(torch.where(mask, fn(pairs), 0.0))

    return fold_edges(edges, chunk, plan)


def tuple_cardinality_ones(sketch: SketchSet, tuples: torch.Tensor,
                           plan: EnginePlan) -> torch.Tensor:
    """popcnt(AND of the k referenced rows) per tuple — int32[T].

    ``tuples`` is int32[T, k]; the cached compiled k-way AND runs in the
    gather kernel (``plan.use_kernel``) or the plain version, with
    identical popcounts.
    """
    if sketch.kind != "bf":
        raise ValueError("tuple_cardinality_ones needs a Bloom sketch")
    k = tuples.shape[1]
    ce = setexpr.compile_expr(setexpr.and_all(*setexpr.rows(k)),
                              block_e=plan.block_e, block_w=plan.block_w,
                              use_kernel=plan.use_kernel)
    return ce.ones(sketch.data, tuples)


def segment_cardinality_ones(sketch: SketchSet, heads: torch.Tensor,
                             offsets: torch.Tensor, tails: torch.Tensor,
                             plan: EnginePlan) -> torch.Tensor:
    """popcnt(AND of a segment's k-1 head rows and each of its tail rows)
    per tail — int32[T].

    ``heads`` int32[S, k-1] (k = 2..4), ``offsets`` int32/int64[S+1]
    ascending from 0 to T, ``tails`` int32[T]: the tuples of
    :func:`tuple_cardinality_ones`, grouped by their first k-1 rows. The
    segmented kernel (``plan.use_kernel``) reads each segment's head rows
    once; the plain version expands the tuples. Identical popcounts.
    """
    if sketch.kind != "bf":
        raise ValueError("segment_cardinality_ones needs a Bloom sketch")
    if plan.use_kernel:
        if not sketch.data.is_cuda:
            raise ValueError(
                "use_kernel=True needs CUDA tensors; the plain PyTorch path "
                "is use_kernel=False")
        return fused_expr.fused_segment_popcount(sketch.data, heads, offsets,
                                                 tails)
    return ref.fused_segment_popcount(sketch.data, heads, offsets, tails)


def triple_cardinality_ones(sketch: SketchSet, triples: torch.Tensor,
                            plan: EnginePlan) -> torch.Tensor:
    """popcnt(Bu & Bv & Bw) per (u, v, w) triple — int32[T]."""
    return tuple_cardinality_ones(sketch, triples, plan)


def _grid_ones(sketch: SketchSet, cols: list, plan: EnginePlan
               ) -> torch.Tensor:
    """popcnt(AND of the rows named by broadcastable id grids ``cols``):
    int32 over their broadcast shape. The kernel path flattens the grids to
    tuples for :func:`tuple_cardinality_ones`; the plain path gathers each
    grid's rows once and ANDs them broadcast.

    The grid providers below keep the reference's signatures and layouts
    for parity with its engine; the port's own clique path enumerates
    from the CSR and calls :func:`segment_cardinality_ones`."""
    shape = torch.broadcast_shapes(*(c.shape for c in cols))
    if plan.use_kernel:
        tuples = torch.stack([c.expand(shape).reshape(-1) for c in cols],
                             dim=1).to(torch.int32)
        return tuple_cardinality_ones(sketch, tuples, plan).reshape(shape)
    acc = None
    for c in cols:
        rows = ref.gather_rows(sketch.data, c.reshape(-1)).reshape(
            *c.shape, sketch.data.shape[1])
        acc = rows if acc is None else acc & rows
    return _popcount_words(acc)


def wedge_triple_ones(sketch: SketchSet, u: torch.Tensor, v: torch.Tensor,
                      w_grid: torch.Tensor, plan: EnginePlan) -> torch.Tensor:
    """popcnt(Bu & Bv & Bw) over a wedge grid: u, v int32[C], w int32[C, d]
    -> int32[C, d] (the 4-clique triple-intersection provider)."""
    return _grid_ones(sketch, [u[:, None], v[:, None], w_grid], plan)


def wedge_quad_ones(sketch: SketchSet, u: torch.Tensor, v: torch.Tensor,
                    w_grid: torch.Tensor, x_grid: torch.Tensor,
                    plan: EnginePlan) -> torch.Tensor:
    """popcnt(Bu & Bv & Bw & Bx) over a wedge-pair grid: u, v int32[C],
    w int32[C, dw], x int32[C, dx] -> int32[C, dw, dx] (the 5-clique 4-way
    intersection provider)."""
    return _grid_ones(sketch, [u[:, None, None], v[:, None, None],
                               w_grid[:, :, None], x_grid[:, None, :]], plan)


# ----------------------------------------------------------------------------
# multi-query session
# ----------------------------------------------------------------------------

class MiningSession:
    """Amortizes one sketch build and one per-edge cardinality pass across
    TC, LCC, Jarvis–Patrick and similarity queries on the same graph."""

    def __init__(self, graph: Graph, sketch: Optional[SketchSet],
                 plan: EnginePlan):
        self.graph = graph
        self.sketch = sketch
        self.plan = plan
        self._edge_cards: Optional[torch.Tensor] = None

    def fork(self) -> "MiningSession":
        """Twin sharing this session's state by reference; fields are only
        ever rebound, never edited in place."""
        new = MiningSession(self.graph, self.sketch, self.plan)
        new._edge_cards = self._edge_cards
        return new

    def edge_cardinalities(self) -> torch.Tensor:
        """Cached |N_u ∩ N_v| over graph.edges (the shared mining pass)."""
        if self._edge_cards is None:
            with trace.span("engine.edge_cards",
                            edges=int(self.graph.m)) as sp:
                self._edge_cards = sp.fence(edge_cardinalities(
                    self.graph, self.sketch, self.plan))
        return self._edge_cards

    def triangle_count(self) -> torch.Tensor:
        """Scalar TC estimate from the shared per-edge cardinality pass."""
        return torch.sum(self.edge_cardinalities()) / 3.0

    def local_clustering(self) -> torch.Tensor:
        """Per-vertex clustering coefficients float32[n] (shared pass)."""
        from ..core.algorithms.tc import local_clustering_coefficient
        return local_clustering_coefficient(
            self.graph, self.sketch, plan=self.plan,
            edge_cards=self.edge_cardinalities())

    def jarvis_patrick(self, similarity: str = "common",
                       threshold: float = 2.0):
        """Jarvis–Patrick clustering ``(labels int32[n], num_clusters)``."""
        from ..core.algorithms.clustering import jarvis_patrick
        return jarvis_patrick(self.graph, self.sketch, similarity, threshold,
                              plan=self.plan,
                              edge_cards=self.edge_cardinalities())

    def four_clique_count(self, **kw) -> torch.Tensor:
        """Scalar 4-clique count estimate (3-way sketch intersections)."""
        from ..core.algorithms.cliques import four_clique_count
        return four_clique_count(self.graph, self.sketch, plan=self.plan, **kw)

    def five_clique_count(self, **kw) -> torch.Tensor:
        """Scalar 5-clique count estimate (4-way sketch intersections)."""
        from ..core.algorithms.cliques import five_clique_count
        return five_clique_count(self.graph, self.sketch, plan=self.plan,
                                 **kw)

    def similarity(self, pairs: torch.Tensor, measure: str = "jaccard"
                   ) -> torch.Tensor:
        """Similarity scores float32[P] for vertex pairs int32[P, 2]."""
        from ..core.algorithms.similarity import pair_similarity
        return pair_similarity(self.graph, pairs, measure, self.sketch,
                               plan=self.plan)

    def local_cluster(self, seeds, alpha: float = 0.15, eps: float = 1e-4,
                      **kw):
        """Seed-centric local clustering (PPR push + sketch-gated sweep).

        Args:
          seeds: int[S] (or scalar) seed vertex ids; the whole batch runs
                 as one batched push + sweep.
          alpha: PPR teleport probability.
          eps:   push tolerance (residual threshold per unit degree).
          **kw:  forwarded to
                 :func:`repro_torch.core.algorithms.localcluster.local_cluster`
                 (e.g. ``max_iters=``, or plan overrides such as
                 ``frontier_mode=`` / ``frontier_cap=``).

        Returns:
          A :class:`~repro_torch.core.algorithms.localcluster.
          LocalClusterResult`. A Bloom session's sweep counts its cut
          increments with the dense AND2 popcount (the CUDA kernel when
          ``plan.use_kernel``); any other session counts them exactly.
        """
        from ..core.algorithms.localcluster import local_cluster
        with trace.span("engine.local_cluster", alpha=float(alpha),
                        eps=float(eps)) as sp:
            res = local_cluster(self.graph, seeds, alpha, eps, self.sketch,
                                plan=self.plan, **kw)
            sp.set(sparse=res.frontier is not None, spilled=bool(res.spilled))
            return res

    def edge_similarity(self, measure: str = "jaccard") -> torch.Tensor:
        """Similarity scores over graph.edges from the cached shared pass."""
        from ..core.algorithms.similarity import similarity_from_cardinalities
        edges = self.graph.edges
        du = self.graph.deg[edges[:, 0].long()].to(torch.float32)
        dv = self.graph.deg[edges[:, 1].long()].to(torch.float32)
        return similarity_from_cardinalities(self.edge_cardinalities(),
                                             du, dv, measure)

    def stats(self) -> dict:
        """Session facts: graph sizes, sketch kind/bytes, JSON-able plan."""
        sk = self.sketch
        return {
            "n": self.graph.n, "m": self.graph.m,
            "sketch": sk.kind if sk is not None else "exact",
            "sketch_bytes": int(sk.data.numel() * sk.data.element_size())
            if sk is not None else 0,
            "plan": dataclasses.asdict(self.plan),
        }


def session(graph: Graph, sketch: Optional[SketchSet] | str = "bf",
            storage_budget: float = 0.25, num_hashes: int = 2, seed: int = 0,
            plan: Optional[EnginePlan] = None,
            device: DeviceLike = DEFAULT_DEVICE, **plan_kw) -> MiningSession:
    """Open a multi-query mining session over one shared sketch build.

    The graph (and a prebuilt sketch) move to ``device`` first; with no
    CUDA device, the default ``"cuda"`` raises instead of running on the
    CPU. ``sketch`` may be a prebuilt SketchSet or a kind string ("bf" |
    "kh" | "1h" | "kmv") to build here; ``None`` runs the exact baseline
    (``core/exact.py``: exact counts over the CSR, as float32).
    """
    dev = resolve_device(device)
    graph = graph.to(dev)
    if isinstance(sketch, str):
        sketch = build_sketch(graph, sketch, storage_budget,
                              num_hashes=num_hashes, seed=seed)
    elif sketch is not None and sketch.data.device != dev:
        sketch = dataclasses.replace(sketch, data=sketch.data.to(dev))
    return MiningSession(graph, sketch, resolve_plan(plan, graph, sketch,
                                                     plan_kw))
