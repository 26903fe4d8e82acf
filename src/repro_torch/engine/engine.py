"""Batched mining engine: one execution seam for the ProbGraph algorithms.

  * ``pair_cardinality_fn`` — the |N_u ∩ N_v| provider, plan-dispatched
    between the CUDA popcount kernels and the plain PyTorch path.
  * ``edge_cardinalities`` / ``sum_edge_cardinalities`` — per-edge map /
    fold over an edge list with the degree-ordered layout, in chunks (the
    Bloom AND map on CUDA: one kernel launch, ``fuses_edge_pass``); the
    fold optionally split over the ranks of the active mesh
    (``shard_edges``, ``repro_torch.distributed.sharding`` rules), each
    rank's part being ``shard_edge_cardinalities``.
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
  * ``MiningSession.refresh`` with a host carry or a :class:`DeviceCarry`
    — the streaming tier's delta-aware cache refresh — and
    :class:`Footprint`, the serving tier's invalidation unit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..core.estimators import _popcount_words
from ..core.graph import Graph
from ..core.intersect import CardFn, make_pair_cardinality_fn
from ..core.sketches import SketchSet, build as build_sketch
from ..distributed import sharding
from ..kernels import fused_expr, ref
from ..obs import trace
from . import setexpr
from .plan import (EnginePlan, fold_edge_shard, fold_edges, hub_order,
                   map_edges, order_edges_by_hub, plan_for)

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
    if plan is None:
        return plan_for(graph, sketch, **kw)
    return plan.with_(**kw) if kw else plan


def pair_cardinality_fn(graph: Graph, sketch: Optional[SketchSet],
                        plan: EnginePlan) -> CardFn:
    """The single |N_u ∩ N_v| seam, dispatched by the plan."""
    return make_pair_cardinality_fn(
        graph, sketch, use_kernel=plan.use_kernel, variant=plan.variant,
        estimator=plan.estimator, block_e=plan.block_e, block_w=plan.block_w)


def fuses_edge_pass(sketch: Optional[SketchSet], plan: EnginePlan,
                    device: torch.device) -> bool:
    """Whether :func:`edge_cardinalities` over edges on ``device`` runs as
    one launch of the AND2 gather kernel with Eq. 2 in its store
    (``fused_expr.fused_gather_cardinality``): a Bloom sketch under the AND
    estimator, ``plan.use_kernel``, a CUDA device. Every other pass keeps
    the chunked :func:`~repro_torch.engine.plan.map_edges`."""
    return (sketch is not None and sketch.kind == "bf"
            and (plan.estimator or sketch.kind) == "bf"
            and plan.use_kernel and torch.device(device).type == "cuda")


def edge_cardinalities(graph: Graph, sketch: Optional[SketchSet],
                       plan: EnginePlan,
                       edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge |N_u ∩ N_v| (float32[m]) in the caller's edge order.

    The degree-ordered layout is applied internally (and inverted on the
    way out) so the kernel sees hub-clustered tuples; the fused pass
    (:func:`fuses_edge_pass`) visits the edges in hub order and stores each
    cardinality at its edge's place.
    """
    edges = graph.edges if edges is None else edges
    hubs = plan.degree_order and edges.shape[0] > 1
    if fuses_edge_pass(sketch, plan, edges.device):
        return fused_expr.fused_gather_cardinality(
            sketch.data, edges.to(torch.int32), sketch.num_hashes,
            order=hub_order(graph, edges) if hubs else None)
    fn = pair_cardinality_fn(graph, sketch, plan)
    if hubs:
        edges_s, inv = order_edges_by_hub(graph, edges)
        return map_edges(edges_s, fn, plan)[inv]
    return map_edges(edges, fn, plan)


def _fold_inputs(graph: Graph, sketch: Optional[SketchSet],
                 plan: EnginePlan, card_fn: Optional[CardFn]):
    """The edge list the fold runs over and its chunk function."""
    fn = card_fn or pair_cardinality_fn(graph, sketch, plan)
    edges = graph.edges
    if plan.degree_order and edges.shape[0] > 1:
        edges = edges[hub_order(graph, edges)]   # sums need no unsort

    def chunk(pairs, mask):
        """Masked partial sum of one edge chunk's cardinalities."""
        return torch.sum(torch.where(mask, fn(pairs), 0.0))

    return edges, chunk


def sum_edge_cardinalities(graph: Graph, sketch: Optional[SketchSet],
                           plan: EnginePlan,
                           card_fn: Optional[CardFn] = None) -> torch.Tensor:
    """Σ_{(u,v)∈E} |N_u ∩ N_v| — the TC numerator, fold-executed."""
    edges, chunk = _fold_inputs(graph, sketch, plan, card_fn)
    if plan.shard_edges:
        return _sharded_fold(edges, chunk, plan)
    return fold_edges(edges, chunk, plan)


def shard_edge_cardinalities(graph: Graph, sketch: Optional[SketchSet],
                             plan: EnginePlan, index: int, nshards: int,
                             card_fn: Optional[CardFn] = None
                             ) -> torch.Tensor:
    """The part of :func:`sum_edge_cardinalities` that the rank holding
    edge shard ``index`` of ``nshards`` computes before the reduction
    (float32 scalar): the fold over its block of the edges in the fold's
    order (hub order with ``plan.degree_order``; ``fold_edge_shard``)."""
    edges, chunk = _fold_inputs(graph, sketch, plan, card_fn)
    return fold_edge_shard(edges, chunk, plan, index, nshards)


def _sharded_fold(edges: torch.Tensor, chunk_fn, plan: EnginePlan
                  ) -> torch.Tensor:
    """The masked edge fold split over the active mesh's edge dims.

    Without an active mesh, or when the rules give the edge list no mesh
    dim, this is the local fold (the reference's semantics). Otherwise
    each rank folds its shard's block (:func:`fold_edge_shard`) and the
    partials are summed by an ``all_reduce`` over each edge dim's group in
    turn. Fixed-size sketch rows mean every shard does the same work — the
    paper's no-straggler property.
    """
    mesh = sharding.active_mesh()
    if mesh is None:
        return fold_edges(edges, chunk_fn, plan)
    axes = sharding.spec_axes(sharding.spec_for(("edge", None), mesh=mesh)[0])
    if not axes:
        return fold_edges(edges, chunk_fn, plan)
    if mesh.device_type != edges.device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but the edges "
                         f"are on {edges.device.type!r}")
    sizes = sharding.axis_sizes(mesh)
    nshards = int(np.prod([sizes[a] for a in axes]))
    local = fold_edge_shard(edges, chunk_fn, plan,
                            sharding.mesh_index(mesh, axes), nshards)
    for a in axes:
        dist.all_reduce(local, group=mesh.get_group(a))
    return local


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
# answer footprints (the serving tier's invalidation unit)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Footprint:
    """The vertex set one answer was computed from.

    A pair score reads exactly two sketch rows and two degrees, a
    membership test one row, a local cluster the rows/degrees of its PPR
    support — so ``vertices`` lists exactly the vertex ids whose adjacency,
    degree, or sketch row the answer depends on. A result cached above the
    engine stays valid until a delta touches (or a maintenance flush
    rebuilds) a footprint vertex; ``vertices is None`` marks whole-graph
    answers (triangle counts fold every edge) that no delta can survive.
    """

    vertices: Optional[np.ndarray]

    @classmethod
    def whole_graph(cls) -> "Footprint":
        """Footprint of an answer that reads every edge (e.g. TC)."""
        return cls(None)

    @classmethod
    def of(cls, *vertex_sets) -> "Footprint":
        """Union footprint of the given vertex id arrays / scalars."""
        arrs = [np.asarray(a, dtype=np.int64).reshape(-1)
                for a in vertex_sets if a is not None]
        arrs = [a for a in arrs if a.size]
        if not arrs:
            return cls(np.zeros(0, np.int64))
        return cls(np.unique(np.concatenate(arrs)))

    @property
    def is_whole_graph(self) -> bool:
        """True when the answer depends on the entire graph."""
        return self.vertices is None

    def intersects(self, vertices) -> bool:
        """Does any of ``vertices`` invalidate this footprint?"""
        if self.vertices is None:
            return True
        return bool(np.isin(np.asarray(vertices, dtype=np.int64),
                            self.vertices).any())


# ----------------------------------------------------------------------------
# multi-query session
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceCarry:
    """Device-resident carry for :meth:`MiningSession.refresh`.

    A streaming graph derives the position carry on its device (from its
    edge-list splice) and uploads only the delta-sized recompute set, so
    refresh traffic scales with the delta.

    Attributes:
      carry:         int[>= m_new] device — new edge j carried old position
                     ``carry[j]`` (>= 0), or < 0 for an inserted edge. Entries
                     in the recompute set may be stale; they are overwritten.
      recompute_pos: int[R_b] device — positions whose cached cardinality
                     must be recomputed (covers every carry < 0 and every
                     edge with an invalidated endpoint); entries >= m_new
                     are padding and are dropped.
      n_recompute:   the true number R of recomputed positions.
      edges_full:    int32[E_cap, 2] device — the capacity-padded edge buffer
                     the recompute edges are gathered from (rows past m are
                     the sentinel ``(n, n)``).
    """

    carry: torch.Tensor
    recompute_pos: torch.Tensor
    n_recompute: int
    edges_full: torch.Tensor


def _carry_cards(old_cards: torch.Tensor, carry: torch.Tensor,
                 m_new: int) -> torch.Tensor:
    """Gather the carried cardinalities of the first ``m_new`` positions
    (negative carries clip to 0; the caller overwrites those)."""
    c = carry[:m_new].to(torch.int64).clamp(0, old_cards.shape[0] - 1)
    return old_cards[c]


def _carry_scatter_cards(old_cards: torch.Tensor, carry: torch.Tensor,
                         pos: torch.Tensor, sub: torch.Tensor,
                         m_new: int) -> torch.Tensor:
    """Carried cardinalities with the recomputed subset written over them.

    Padded positions (>= m_new) are sent to one spare slot past the end,
    which is cut off: torch has no scatter mode that drops them."""
    cards = torch.empty(m_new + 1, dtype=old_cards.dtype,
                        device=old_cards.device)
    cards[:m_new] = _carry_cards(old_cards, carry, m_new)
    pos = pos.to(torch.int64)
    cards[torch.where(pos < m_new, pos, m_new)] = sub
    return cards[:m_new]


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
            m = int(self.graph.m)
            # ``chunks`` counts edges in units of ``edge_chunk`` on both
            # paths; the fused pass launches once
            with trace.span("engine.edge_cards", edges=m,
                            chunks=-(-m // self.plan.edge_chunk),
                            fused=fuses_edge_pass(self.sketch, self.plan,
                                                  self.graph.edges.device)
                            ) as sp:
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

    def refresh(self, graph: Graph, sketch: Optional[SketchSet] = None,
                carry_index=None) -> Optional[int]:
        """Delta-aware cache invalidation: repoint the session at an updated
        (graph, sketch) and recompute only the invalidated edge cardinalities.

        ``carry_index[j]`` is the position of new edge j in the *previous*
        ``graph.edges`` when its cached cardinality is still valid (neither
        endpoint's neighborhood, degree, or sketch row changed), or -1 to
        recompute. With ``carry_index=None`` the whole cache is dropped.
        A :class:`DeviceCarry` keeps the whole exchange on the device
        (carried values are gathered by the device permutation, only the
        delta-sized recompute positions were uploaded). Returns the number
        of per-edge cardinalities recomputed, or ``None`` when the cache was
        dropped instead (the full pass then happens lazily).

        Per-pair estimators are elementwise in the pair, so recomputing only
        the invalidated subset is bit-identical to a from-scratch pass.
        """
        with trace.span("engine.refresh") as sp:
            result = self._refresh(graph, sketch, carry_index)
            sp.set(recomputed=-1 if result is None else result)
            if self._edge_cards is not None:
                sp.fence(self._edge_cards)
            return result

    def _refresh(self, graph, sketch, carry_index):
        old_cards = self._edge_cards
        self.graph = graph
        if sketch is not None:
            self.sketch = sketch
        if (old_cards is None or carry_index is None
                or int(old_cards.shape[0]) == 0):
            self._edge_cards = None
            return None
        if isinstance(carry_index, DeviceCarry):
            return self._refresh_device(old_cards, carry_index)
        carry = np.asarray(carry_index, dtype=np.int64)
        dev = old_cards.device
        if carry.shape[0] == 0:
            self._edge_cards = torch.zeros(0, dtype=torch.float32, device=dev)
            return 0
        recompute = np.nonzero(carry < 0)[0]
        cards = old_cards[torch.from_numpy(np.where(carry < 0, 0, carry))
                          .to(dev)]
        if recompute.size:
            idx = torch.from_numpy(recompute).to(dev)
            cards[idx] = edge_cardinalities(self.graph, self.sketch,
                                            self.plan,
                                            edges=self.graph.edges[idx])
        self._edge_cards = cards
        return int(recompute.size)

    def _refresh_device(self, old_cards: torch.Tensor,
                        dc: DeviceCarry) -> int:
        """Device-side cache carry: gather by the splice permutation, then
        recompute only the invalidated positions (edges gathered on the
        device, no host round-trip)."""
        m_new = self.graph.m
        if m_new == 0:
            self._edge_cards = torch.zeros(0, dtype=torch.float32,
                                           device=old_cards.device)
            return 0
        if dc.n_recompute:
            # padded positions hit sentinel rows (n, n): clamp the vertex id
            # to a real row first, as the kernels read rows by raw id and
            # the plain path must compute the same numbers; the scatter
            # then drops those cardinalities
            sub_edges = torch.clamp(
                dc.edges_full[dc.recompute_pos.to(torch.int64)],
                max=max(self.graph.n - 1, 0))
            sub = edge_cardinalities(self.graph, self.sketch, self.plan,
                                     edges=sub_edges)
            self._edge_cards = _carry_scatter_cards(
                old_cards, dc.carry, dc.recompute_pos, sub, m_new)
        else:
            self._edge_cards = _carry_cards(old_cards, dc.carry, m_new)
        return int(dc.n_recompute)

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
