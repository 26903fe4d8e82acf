"""k-Clique counting (paper Listing 2, reformulated to expose |X∩Y∩Z|).

Formulation, as in ``repro.core.algorithms.cliques``: enumerate ordered
triangles u<v<w (canonical edge (u, v) × wedge w∈N_v, w>v, plus the
closing test w∈N_u), then

    cc4 = (1/4) Σ_{triangles u<v<w} |N_u ∩ N_v ∩ N_w|

and one level up, 4-cliques u<v<w<x (w and x both from N_v, closed against
N_u and against each other), then

    cc5 = (1/5) Σ_{4-cliques u<v<w<x} |N_u ∩ N_v ∩ N_w ∩ N_x|.

Intersections: ``exact`` walks the CSR row of least degree and looks the
others up (``core.exact.common_count``); ``bf`` is popcount(AND of the
Bloom rows), Eq. 2, over segments that share their first k-1 rows (the
segmented kernel on CUDA, which reads them once per segment); ``kh``
(4-cliques only) is the reference's 3-way aligned-match
inclusion–exclusion. The closing tests
use Bloom membership for a ``bf`` sketch (unless ``exact_closing_test``)
and an exact edge lookup otherwise.

The reference lays each edge chunk's candidates on a ``[C, d_max]`` grid
over the padded adjacency (``[C, d_max, d_max]`` for 5-cliques); at
Kronecker scale 21 such grids would hold ~3e12 slots. Here the candidates
w > v of an edge (u, v) are a suffix of v's sorted CSR row, enumerated in
pieces of about ``_CHUNK_CANDIDATES`` (whole edges); only the closing
test's survivors go on, to the popcount in launches of at most
``_LAUNCH_TUPLES`` tuples. For ``bf`` a piece's survivors reach the kernel
as segments: the heads (u, v) per canonical edge, or (u, v, w) per
triangle, and one tail row per tuple, never as stacked [T, k] tuples. The
kernels take any tuple count, so nothing is
padded (the reference's pow2 padding bounds XLA recompiles, which a CUDA
kernel does not have). Each tuple's value is the reference's — the same
masks, Bloom false positives of the closing test included — and only the
summation order differs: sums run in float64 and the count is returned
as float32.

Each call sets gauges of :data:`repro_torch.obs.metrics.REGISTRY`:
``clique_wedge_candidates`` (Σ over canonical edges of |{w∈N_v: w>v}|),
``clique_triangles`` (closing-test survivors), and for 5-cliques
``clique_pair_candidates`` (survivor pairs w<x of one edge) and
``clique_quads`` (pairs that close). Each call is traced as the span
``clique.count`` (``k``, ``kind``), fenced on the count.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from ... import engine as eng
from ...obs import trace
from ...obs.metrics import REGISTRY
from .. import estimators as est
from ..exact import common_count, key_member, pieces
from ..graph import Graph, edge_keys, has_edge
from ..sketches import SketchSet, bloom_positions, bloom_test

#: wedge candidates (or candidate pairs) one enumeration piece holds, about;
#: each takes a few int64 temporaries, so a piece stays near 2 GiB
_CHUNK_CANDIDATES = 1 << 25

#: tuples per popcount launch (bounds the estimators' temporaries)
_LAUNCH_TUPLES = 1 << 22


@dataclasses.dataclass(frozen=True)
class _Csr:
    """The CSR views and closing test one clique count shares."""

    graph: Graph
    up_first: torch.Tensor   # int64[n]: CSR slot of the first neighbour > v
    up_count: torch.Tensor   # int64[n]: number of neighbours > v
    keys: torch.Tensor       # int64[m]: sorted canonical edge keys
    closes: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def neighbour(self, slots: torch.Tensor) -> torch.Tensor:
        """int64 neighbour ids at CSR ``slots``."""
        return self.graph.indices[slots].to(torch.int64)


def _csr(graph: Graph, sketch: Optional[SketchSet],
         exact_closing_test: bool) -> _Csr:
    """Up-neighbour suffixes, edge keys and the closing test ``closes(a,
    b)``: b ∈ N_a by Bloom membership (a ``bf`` sketch, unless
    ``exact_closing_test``) or by edge lookup."""
    n, dev = graph.n, graph.device
    deg = graph.deg.to(torch.int64)
    row = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                  output_size=graph.indices.numel())
    below = torch.bincount(row[graph.indices.to(torch.int64) < row],
                           minlength=n)
    del row
    keys = edge_keys(graph)
    if sketch is not None and sketch.kind == "bf" and not exact_closing_test:
        # every vertex's bit positions, int32 [n·b] flat: one element per
        # gathered index (a [n, b] row gather is slow on CUDA)
        nh = sketch.num_hashes
        pos = bloom_positions(torch.arange(n, device=dev), nh,
                              sketch.total_bits, sketch.seed
                              ).to(torch.int32).reshape(-1)
        hashes = torch.arange(nh, device=dev)

        def closes(a, b):
            return bloom_test(sketch.data, a, pos[b[:, None] * nh + hashes])
    else:
        def closes(a, b):
            return has_edge(keys, n, a, b)
    return _Csr(graph, graph.indptr[:-1].to(torch.int64) + below,
                deg - below, keys, closes)


def _triangles(csr: _Csr, edges: torch.Tensor, cap: int, stats: dict):
    """Closed wedges of canonical ``edges`` (int[E, 2], u < v), in pieces.

    Yields (lo, hi, edge, w) per piece: the piece's edges lo <= e < hi
    (host ints) and, int64 per survivor of the closing test among the
    candidates w ∈ N_v, w > v, its edge index and w, edge-major (``edge``
    ascending) and w ascending within an edge; every edge's survivors lie
    in one piece.
    """
    u, v = edges[:, 0].to(torch.int64), edges[:, 1].to(torch.int64)
    for lo, hi, item, rank in pieces(csr.up_count[v], cap):
        ww = csr.neighbour(csr.up_first[v[item]] + rank)
        keep = torch.nonzero(csr.closes(u[item], ww)).squeeze(1)
        stats["clique_wedge_candidates"] += item.numel()
        stats["clique_triangles"] += keep.numel()
        yield lo, hi, item[keep], ww[keep]


def _pairs(csr: _Csr, edge: torch.Tensor, w: torch.Tensor, cap: int,
           stats: dict):
    """4-cliques u<v<w<x of one piece (edge, w) of :func:`_triangles`:
    pairs w < x of one edge's survivors whose (w, x) closes too.

    Yields (lo, hi, i, x) per run: the run's triangles lo <= i < hi of the
    piece (host ints), and int64 per 4-clique its triangle ``i``
    (ascending) and x.
    """
    # survivors after each one on the same edge (edge is sorted)
    later = (torch.searchsorted(edge, edge, right=True) - 1
             - torch.arange(edge.numel(), device=edge.device))
    for lo, hi, i, rank in pieces(later, cap):
        x = w[i + 1 + rank]
        keep = torch.nonzero(csr.closes(w[i], x)).squeeze(1)
        stats["clique_pair_candidates"] += i.numel()
        stats["clique_quads"] += keep.numel()
        yield lo, hi, i[keep], x[keep]


def _stacked_triangles(edges: torch.Tensor, edge: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """int64[T, 3] (u, v, w) of a piece of :func:`_triangles`."""
    return torch.cat([edges[edge].to(torch.int64), w[:, None]], dim=1)


def _quads(csr: _Csr, edges: torch.Tensor, cap: int, stats: dict):
    """The 4-cliques of :func:`_pairs` as int64[Q, 4] (u, v, w, x), one
    piece per run."""
    for _, _, edge, w in _triangles(csr, edges, cap, stats):
        tri = _stacked_triangles(edges, edge, w)
        for _, _, i, x in _pairs(csr, edge, w, cap, stats):
            yield torch.cat([tri[i], x[:, None]], dim=1)


def _offsets(item: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """int64[hi - lo + 1]: where each of the items lo..hi-1 starts in the
    sorted int64 ``item`` (the end of the last at the end)."""
    return torch.searchsorted(item, torch.arange(lo, hi + 1,
                                                 device=item.device))


def _triangle_segments(csr: _Csr, edges: torch.Tensor, cap: int,
                       stats: dict):
    """The closed triangles of :func:`_triangles` as segments, one per
    piece: heads int32[E, 2] the piece's edges (u, v), int64 offsets, tails
    int32 the survivors w."""
    for lo, hi, edge, w in _triangles(csr, edges, cap, stats):
        yield edges[lo:hi], _offsets(edge, lo, hi), w.to(torch.int32)


def _quad_segments(csr: _Csr, edges: torch.Tensor, cap: int, stats: dict):
    """The 4-cliques of :func:`_pairs` as segments, one per run: heads
    int32[R, 3] the run's triangles (u, v, w), int64 offsets, tails int32
    the closing x."""
    for _, _, edge, w in _triangles(csr, edges, cap, stats):
        heads = _stacked_triangles(edges, edge, w).to(torch.int32)
        for lo, hi, i, x in _pairs(csr, edge, w, cap, stats):
            yield heads[lo:hi], _offsets(i, lo, hi), x.to(torch.int32)


def segment_launches(heads: torch.Tensor, offsets: torch.Tensor,
                     tails: torch.Tensor):
    """Cut segments into launches of at most ``_LAUNCH_TUPLES`` tails:
    yields (heads, offsets, tails) per launch, the offsets clamped to the
    launch's tails (a launch may cut a segment)."""
    for s in range(0, tails.shape[0], _LAUNCH_TUPLES):
        part = tails[s:s + _LAUNCH_TUPLES]
        yield heads, (offsets - s).clamp_(0, part.shape[0]), part


def _stats(*names: str) -> dict:
    return dict.fromkeys(names, 0)


def closed_triangles(graph: Graph, sketch: Optional[SketchSet] = None,
                     exact_closing_test: bool = False, *,
                     edges: Optional[torch.Tensor] = None
                     ) -> Iterator[torch.Tensor]:
    """The triangles u<v<w a 4-clique count sums over, as int64[T, 3]
    pieces: w ∈ N_v with w > v, closed by the sketch's test (see
    :func:`four_clique_count`). ``edges`` (canonical, default
    ``graph.edges``) picks the edges (u, v) to start from."""
    csr = _csr(graph, sketch, exact_closing_test)
    edges = graph.edges if edges is None else edges
    stats = _stats("clique_wedge_candidates", "clique_triangles")
    for _, _, edge, w in _triangles(csr, edges, _CHUNK_CANDIDATES, stats):
        yield _stacked_triangles(edges, edge, w)


def closed_quads(graph: Graph, sketch: Optional[SketchSet] = None,
                 exact_closing_test: bool = False, *,
                 edges: Optional[torch.Tensor] = None
                 ) -> Iterator[torch.Tensor]:
    """The 4-cliques u<v<w<x a 5-clique count sums over, as int64[Q, 4]
    pieces (see :func:`five_clique_count`)."""
    csr = _csr(graph, sketch, exact_closing_test)
    edges = graph.edges if edges is None else edges
    stats = _stats("clique_wedge_candidates", "clique_triangles",
                   "clique_pair_candidates", "clique_quads")
    yield from _quads(csr, edges, _CHUNK_CANDIDATES, stats)


def closed_segments(graph: Graph, sketch: Optional[SketchSet] = None,
                    k: int = 3, exact_closing_test: bool = False, *,
                    edges: Optional[torch.Tensor] = None
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
    """The tuples of :func:`closed_triangles` (``k`` = 3) or
    :func:`closed_quads` (``k`` = 4) as the Bloom passes give them to the
    popcount: segments (int32 heads[S, k-1], int64 offsets[S+1], int32
    tails[T]) that share their first k-1 rows, in the same order."""
    if k not in (3, 4):
        raise ValueError(f"closed segments of k = 3 or 4, not {k}")
    csr = _csr(graph, sketch, exact_closing_test)
    edges = graph.edges if edges is None else edges
    stats = _stats("clique_wedge_candidates", "clique_triangles",
                   "clique_pair_candidates", "clique_quads")
    segments = _triangle_segments if k == 3 else _quad_segments
    yield from segments(csr, edges, _CHUNK_CANDIDATES, stats)


def _fold_segments(sketch: SketchSet, plan: eng.EnginePlan, segments,
                   total: torch.Tensor) -> torch.Tensor:
    """``total`` + Σ Eq. 2 on popcount(AND of the Bloom rows) over the
    tuples of ``segments`` ((heads, offsets, tails) each; see
    :func:`repro_torch.engine.segment_cardinality_ones`), in the launches
    of :func:`segment_launches`."""
    for heads, offsets, tails in segments:
        for launch in segment_launches(heads, offsets, tails):
            ones = eng.segment_cardinality_ones(sketch, *launch, plan)
            total = total + torch.sum(est.bf_intersection_and_from_ones(
                ones, sketch.total_bits, sketch.num_hashes),
                dtype=torch.float64)
    return total


def _khash_triple(graph: Graph, sketch: SketchSet, plan: eng.EnginePlan,
                  u: torch.Tensor, v: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
    """|N_u ∩ N_v ∩ N_w| from k-Hash rows: J3·(S1 − S2)/(1 − J3), with
    the pairwise MinHash estimates in S2 (the reference's formula)."""
    n = graph.n
    mu, mv, mw = (sketch.data.index_select(0, x) for x in (u, v, w))
    valid3 = (mu < n) & (mv < n) & (mw < n)
    j3 = torch.sum((mu == mv) & (mv == mw) & valid3, dim=-1).to(
        torch.float32) / sketch.k
    du, dv, dw = (graph.deg[x].to(torch.float32) for x in (u, v, w))
    s1 = du + dv + dw

    def inter(ma, mb, da, db):
        return est.minhash_intersection(
            est.khash_jaccard(ma, mb, n, use_kernel=plan.use_kernel), da, db)

    s2 = inter(mu, mv, du, dv) + inter(mu, mw, du, dw) + inter(mv, mw, dv, dw)
    j3 = torch.clamp(j3, max=0.999)
    return torch.clamp(j3 * (s1 - s2) / (1.0 - j3), min=0.0)


def _fold(tuples: torch.Tensor, values: Callable[[torch.Tensor],
                                                   torch.Tensor],
          total: torch.Tensor) -> torch.Tensor:
    """``total`` + Σ values(tuples), in launches of ``_LAUNCH_TUPLES``."""
    for s in range(0, tuples.shape[0], _LAUNCH_TUPLES):
        total = total + torch.sum(values(tuples[s:s + _LAUNCH_TUPLES]),
                                  dtype=torch.float64)
    return total


def _publish(stats: dict) -> None:
    for name, value in stats.items():
        REGISTRY.gauge(name).set(value)


def four_clique_count(graph: Graph, sketch: Optional[SketchSet] = None,
                      plan: Optional[eng.EnginePlan] = None,
                      exact_closing_test: bool = False,
                      **kw) -> torch.Tensor:
    """Scalar 4-clique count: (1/4) Σ_{triangles u<v<w} |N_u ∩ N_v ∩ N_w|.

    ``sketch`` None counts exactly; a ``bf`` or ``kh`` sketch estimates.
    The plan (or ``kw``) picks kernel or plain path; its ``edge_chunk``
    does not apply here: pieces are sized by ``_CHUNK_CANDIDATES``.
    """
    kind = sketch.kind if sketch is not None else "exact"
    if kind not in ("exact", "bf", "kh"):
        raise ValueError(f"4-clique not supported for sketch kind {kind}")
    plan = eng.resolve_plan(plan, graph, sketch, kw)
    with trace.span("clique.count", k=4, kind=kind) as sp:
        csr = _csr(graph, sketch, exact_closing_test)
        if kind == "kh":
            def values(t):
                return _khash_triple(graph, sketch, plan, t[:, 0], t[:, 1],
                                     t[:, 2])
        elif kind == "exact":
            member = key_member(graph, csr.keys)

            def values(t):
                return common_count(graph, t, member, _CHUNK_CANDIDATES)
        edges = graph.edges
        stats = _stats("clique_wedge_candidates", "clique_triangles")
        total = torch.zeros((), dtype=torch.float64, device=graph.device)
        if kind == "bf":
            total = _fold_segments(sketch, plan, _triangle_segments(
                csr, edges, _CHUNK_CANDIDATES, stats), total)
        else:
            for _, _, edge, w in _triangles(csr, edges, _CHUNK_CANDIDATES,
                                            stats):
                total = _fold(_stacked_triangles(edges, edge, w), values,
                              total)
        _publish(stats)
        return sp.fence((total / 4.0).to(torch.float32))


def five_clique_count(graph: Graph, sketch: Optional[SketchSet] = None,
                      plan: Optional[eng.EnginePlan] = None,
                      exact_closing_test: bool = False,
                      **kw) -> torch.Tensor:
    """Scalar 5-clique count via 4-way intersections:
    (1/5) Σ_{4-cliques u<v<w<x} |N_u ∩ N_v ∩ N_w ∩ N_x|.

    Each 4-clique is enumerated once from its canonical edge (u, v): w and
    x are closing-test survivors of that edge with w < x, and (w, x) must
    close too. Exact (``sketch`` None) and ``bf`` only; other kinds raise.
    ``kw`` and ``plan`` as in :func:`four_clique_count`.
    """
    kind = sketch.kind if sketch is not None else "exact"
    if kind not in ("exact", "bf"):
        raise ValueError(f"5-clique not supported for sketch kind {kind}")
    plan = eng.resolve_plan(plan, graph, sketch, kw)
    with trace.span("clique.count", k=5, kind=kind) as sp:
        csr = _csr(graph, sketch, exact_closing_test)
        member = key_member(graph, csr.keys)

        def values(t):
            return common_count(graph, t, member, _CHUNK_CANDIDATES)
        edges = graph.edges
        stats = _stats("clique_wedge_candidates", "clique_triangles",
                       "clique_pair_candidates", "clique_quads")
        total = torch.zeros((), dtype=torch.float64, device=graph.device)
        if kind == "bf":
            total = _fold_segments(sketch, plan, _quad_segments(
                csr, edges, _CHUNK_CANDIDATES, stats), total)
        else:
            for quads in _quads(csr, edges, _CHUNK_CANDIDATES, stats):
                total = _fold(quads, values, total)
        _publish(stats)
        return sp.fence((total / 5.0).to(torch.float32))


__all__ = ["closed_quads", "closed_segments", "closed_triangles",
           "five_clique_count", "four_clique_count", "segment_launches"]
