"""Local graph clustering: batched PPR forward push + sketch-gated sweep cuts.

The seed-centric workload (Andersen–Chung–Lang / PPR-Nibble, parallelized as
in Shun et al. 2016 and frontier-formulated as in GBBS), as in
``repro.core.algorithms.localcluster``: given seed vertices, find
low-conductance clusters around them. Two phases:

  1. **Forward push** — approximate personalized PageRank, in one of two
     frontier layouts selected by ``plan.frontier_mode``:

     * **dense** — ``r`` residual and ``p`` estimate as ``[S, n]`` float
       tensors; one synchronous round pushes *every* vertex over the ACL
       threshold at once through an edge-parallel ``index_add_`` over
       ``graph.edges``. One host sync per round decides whether to go on.
     * **sparse** — each seed's support lives in a capped ``[S, cap]``
       index+value table (``idx`` ascending vertex ids padded with the
       sentinel ``n``, plus ``p``/``r`` values), with ``cap =
       O(1/(alpha·eps))`` from the ACL work bound. A round expands the
       CSR rows of the *active* entries only (a ragged expansion: each
       push on v retires at least alpha·eps·d(v) of a total mass of 1, so
       a seed expands at most 1/(alpha·eps) slots over all rounds), then
       merges table and candidates with one stable sort by (seed, id)
       and segment sums. Memory scales with the support, never with ``n``
       or ``d_max``. More than ``cap`` distinct ids in a round *spills*:
       the loop stops and the caller re-runs the dense push (a performance
       event, never a correctness event).

     Both layouts implement the same synchronous ACL dynamics.

  2. **Sweep cut** — order vertices by degree-normalized PPR mass (score
     ties by smallest id, by a stable descending sort) and scan prefixes
     ``S_1 ⊂ S_2 ⊂ …`` for the minimum conductance ``φ(S) = cut(S) /
     min(vol(S), vol(V∖S))``. The cut increment of step j is ``d(v_j) −
     2·|N(v_j) ∩ S_{j-1}|``. With a Bloom sketch the swept prefix is itself
     a Bloom filter (exclusive prefix-OR of single-vertex rows under the
     sketch's hash family) and each step is one dense AND2 popcount
     between ``B(N(v_j))`` and ``B(S_{j-1})`` (``fused_rows_popcount`` on
     the card when ``plan.use_kernel``); otherwise neighbours are counted
     exactly by their sweep rank, over the CSR.

No step reads the padded adjacency ``graph.adj``. ``core.bounds.
sweep_cut_rmse`` / ``bloom_words_for_conductance`` size the Bloom filter
from a target conductance error.

Against the reference: its ``top_k`` breaks score ties by smallest index,
which the stable sort reproduces; its pow2 padding of edges and seeds
bounds XLA recompiles and is not needed here. On CUDA the pushes' and the
power iteration's ``index_add_`` are float atomics, so their sums (and
the last bits of ``p``/``r``) vary from run to run; the sweep's integer
counts do not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ... import engine as eng
from ...obs import trace
from ...obs.metrics import REGISTRY
from ..estimators import bf_intersection_and_from_ones, popcount32
from ..exact import row_elements
from ..graph import Graph
from ..sketches import SketchSet, bloom_rows


@dataclasses.dataclass(frozen=True)
class SparseFrontier:
    """Capped per-seed PPR support: the sparse push's index+value buffers.

    Attributes:
      idx: int32[S, cap]   support vertex ids, ascending per row; pad = n.
      p:   float32[S, cap] PPR estimates aligned with ``idx``.
      r:   float32[S, cap] final residuals aligned with ``idx``.
      iterations: int      push rounds executed.
      overflowed: bool     True when some round needed more than ``cap``
                           distinct support vertices — the buffers are then
                           truncated mid-round and MUST NOT be consumed;
                           callers re-run the dense push (a spill).
      n: int               vertex count (the id sentinel).
    """

    idx: torch.Tensor
    p: torch.Tensor
    r: torch.Tensor
    iterations: int
    overflowed: bool
    n: int

    @property
    def cap(self) -> int:
        """Slots per seed (the pow2-bucketed frontier capacity)."""
        return int(self.idx.shape[1])

    def sizes(self) -> np.ndarray:
        """int64[S]: occupied slots (support size) per seed (host-side)."""
        return (self.idx < self.n).sum(1).cpu().numpy().astype(np.int64)

    def densify(self):
        """Scatter back to dense ``(p, r)`` float32[S, n] (test/debug aid)."""
        s_batch = self.idx.shape[0]
        idx = self.idx.to(torch.int64)
        # width n+1 gives sentinel ids a scratch column sliced away below
        p = torch.zeros((s_batch, self.n + 1), dtype=torch.float32,
                        device=idx.device)
        r = torch.zeros_like(p)
        p.scatter_add_(1, idx, self.p)
        r.scatter_add_(1, idx, self.r)
        return p[:, :self.n], r[:, :self.n]


@dataclasses.dataclass(frozen=True)
class LocalClusterResult:
    """Per-seed output of :func:`local_cluster` (a batched sweep).

    Attributes:
      order:       int32[S, k]   sweep order (entries past ``support`` are
                                 the sentinel n).
      conductance: float32[S, k] conductance of each swept prefix (``inf``
                                 at invalid prefixes).
      best_idx:    int32[S]      prefix index minimizing conductance.
      best_conductance: float32[S] the minimum (``inf`` when the seed
                                 admits no valid prefix).
      best_size:   int32[S]      best_idx + 1, or 0 without a valid prefix.
      support:     int32[S]      positive-mass vertices swept (≤ k).
      ppr, residual: float32[S, n] dense push output (``None`` on the
                                 sparse path, whose data is ``frontier``).
      iterations:  int           push rounds.
      frontier:    the :class:`SparseFrontier` (sparse path only).
      spilled:     bool          the sparse push overflowed and the dense
                                 push recomputed the answer.
    """

    order: torch.Tensor
    conductance: torch.Tensor
    best_idx: torch.Tensor
    best_conductance: torch.Tensor
    best_size: torch.Tensor
    support: torch.Tensor
    ppr: Optional[torch.Tensor]
    residual: Optional[torch.Tensor]
    iterations: int
    frontier: Optional[SparseFrontier] = None
    spilled: bool = False

    def members(self, s: int) -> np.ndarray:
        """Vertex ids of seed ``s``'s best cluster (host-side)."""
        k = int(self.best_size[s])
        return self.order[s, :k].cpu().numpy()

    def footprint(self, s: int) -> np.ndarray:
        """Vertex ids seed ``s``'s answer depends on (sorted int64): every
        vertex that ever held PPR mass or residual during the push."""
        if self.frontier is not None:
            idx = self.frontier.idx[s].cpu().numpy()
            p = self.frontier.p[s].cpu().numpy()
            r = self.frontier.r[s].cpu().numpy()
            keep = (idx < self.frontier.n) & ((p > 0) | (r > 0))
            return idx[keep].astype(np.int64)
        p = self.ppr[s].cpu().numpy()
        r = self.residual[s].cpu().numpy()
        return np.nonzero((p > 0) | (r > 0))[0].astype(np.int64)


def _seeds(graph: Graph, seeds) -> torch.Tensor:
    """Seed ids as int64[S] on the graph's device."""
    return torch.as_tensor(seeds, device=graph.device).to(
        torch.int64).reshape(-1)


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar, so products round as the reference's traced
    float32 scalars do."""
    return torch.tensor(float(x), dtype=torch.float32, device=device)


# ----------------------------------------------------------------------------
# phase 1: batched approximate PPR (ACL forward push, synchronous frontier)
# ----------------------------------------------------------------------------

def ppr_push(graph: Graph, seeds, alpha: float = 0.15, eps: float = 1e-4,
             max_iters: int = 200):
    """Batched ACL forward push: approximate PPR for a batch of seeds.

    Reads only ``deg`` and ``edges``. Iterates until every residual
    satisfies ``r[v] < eps·max(d(v), 1)`` or ``max_iters`` rounds.

    Returns:
      ``(p, r, iters)``: PPR estimates float32[S, n], final residuals
      float32[S, n], and the number of rounds (int).
    """
    seeds = _seeds(graph, seeds)
    n, dev = graph.n, graph.device
    alpha_t, eps_t = _f32(alpha, dev), _f32(eps, dev)
    deg = graph.deg.to(torch.float32)
    has = deg > 0
    thresh = eps_t * torch.clamp(deg, min=1.0)
    s_batch = seeds.numel()
    p = torch.zeros((s_batch, n), dtype=torch.float32, device=dev)
    r = torch.zeros_like(p)
    r[torch.arange(s_batch, device=dev), seeds] = 1.0
    src = graph.edges[:, 0].to(torch.int64)
    dst = graph.edges[:, 1].to(torch.int64)
    iters = 0
    active = r >= thresh
    while iters < max_iters and bool(active.any()):
        push = torch.where(active, r, 0.0)
        # isolated vertices (deg 0) absorb their whole mass into p
        p = p + torch.where(has, alpha_t * push, push)
        give = torch.where(has, (1.0 - alpha_t) * push
                           / torch.clamp(deg, min=1.0), 0.0)
        # edge-parallel propagate: each canonical edge carries mass both
        # ways
        recv = torch.zeros_like(r)
        recv.index_add_(1, dst, give[:, src])
        recv.index_add_(1, src, give[:, dst])
        r = torch.where(active, 0.0, r) + recv
        iters += 1
        active = r >= thresh
    return p, r, iters


# auto mode only goes sparse when the capped buffers undercut the dense
# [S, n] tensors by at least this factor
_AUTO_SPARSE_FACTOR = 8


def frontier_cap_for(alpha: float, eps: float, n: int,
                     override: Optional[int] = None) -> int:
    """Sparse-frontier capacity: pow2 bucket of the ACL support bound
    ``ceil(1/(alpha·eps))`` (or ``override``), clamped to ``pow2(n)`` and
    to ≥ 2. Undersizing only risks a spill, never a wrong answer."""
    if override is not None:
        cap = int(override)
    else:
        cap = int(math.ceil(1.0 / (float(alpha) * float(eps))))
    return min(eng.plan.pow2_bucket(cap, lo=2), eng.plan.pow2_bucket(n, lo=2))


def resolve_frontier_mode(plan: eng.EnginePlan, n: int, alpha: float,
                          eps: float) -> str:
    """Dense-vs-sparse plan selection ("auto" resolves by cap-vs-n ratio)."""
    mode = plan.frontier_mode
    if mode not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown frontier_mode: {mode!r}")
    if mode != "auto":
        return mode
    cap = frontier_cap_for(alpha, eps, n, plan.frontier_cap)
    return "sparse" if cap * _AUTO_SPARSE_FACTOR <= n else "dense"


def _sparse_rounds(graph: Graph, seeds: torch.Tensor, alpha: float,
                   eps: float, cap: int, max_iters: int):
    """The sparse push's rounds: (idx int32[S, cap], p, r, rounds,
    overflowed).

    A round's merge keeps the reference's order: the table's entries
    first, then the candidates in (slot, neighbour) order, stably sorted
    by (seed, id); each id's values are summed in that order into the slot
    of its rank among the seed's distinct ids.
    """
    n, dev = graph.n, graph.device
    alpha_t, eps_t = _f32(alpha, dev), _f32(eps, dev)
    deg = graph.deg.to(torch.float32)
    s_batch = seeds.numel()
    idx = torch.full((s_batch, cap), n, dtype=torch.int64, device=dev)
    idx[:, 0] = seeds
    p = torch.zeros((s_batch, cap), dtype=torch.float32, device=dev)
    r = torch.zeros_like(p)
    r[:, 0] = 1.0

    def state(idx):
        """Degrees of table entries (sentinel slots read 0) and validity."""
        valid = idx < n
        return torch.where(valid, deg[idx.clamp(max=n - 1)], 0.0), valid

    iters, overflowed = 0, False
    d, valid = state(idx)
    active = valid & (r >= eps_t * torch.clamp(d, min=1.0))
    while iters < max_iters and bool(active.any()):
        push = torch.where(active, r, 0.0)
        p = p + torch.where(d > 0, alpha_t * push, push)
        give = torch.where(d > 0, (1.0 - alpha_t) * push
                           / torch.clamp(d, min=1.0), 0.0)
        r = torch.where(active, 0.0, r)
        # the table's valid entries, then the active entries' neighbours
        slot = torch.nonzero(valid.reshape(-1)).squeeze(1)
        act = torch.nonzero(active.reshape(-1)).squeeze(1)
        row, ids = [slot // cap], [idx.reshape(-1)[slot]]
        vals_p, vals_r = [p.reshape(-1)[slot]], [r.reshape(-1)[slot]]
        for item, _, w in row_elements(graph, idx.reshape(-1)[act]):
            row.append(act[item] // cap)
            ids.append(w)
            vals_p.append(torch.zeros(w.numel(), dtype=torch.float32,
                                      device=dev))
            vals_r.append(give.reshape(-1)[act[item]])
        row, ids = torch.cat(row), torch.cat(ids)
        key, perm = torch.sort(row * (n + 1) + ids, stable=True)
        row, ids = row[perm], ids[perm]
        head = torch.ones_like(key, dtype=torch.bool)
        head[1:] = key[1:] != key[:-1]
        seg = torch.cumsum(head, 0) - 1
        count = torch.bincount(row[head], minlength=s_batch)
        rank = seg - (torch.cumsum(count, 0) - count)[row]
        overflowed = bool((count > cap).any())
        keep = rank < cap
        at = row * cap + rank
        new_idx = torch.full((s_batch * cap,), n, dtype=torch.int64,
                             device=dev)
        new_idx[at[head & keep]] = ids[head & keep]
        new_p = torch.zeros(s_batch * cap, dtype=torch.float32, device=dev)
        new_r = torch.zeros_like(new_p)
        new_p.index_add_(0, at[keep], torch.cat(vals_p)[perm][keep])
        new_r.index_add_(0, at[keep], torch.cat(vals_r)[perm][keep])
        idx = new_idx.view(s_batch, cap)
        p, r = new_p.view(s_batch, cap), new_r.view(s_batch, cap)
        iters += 1
        if overflowed:
            break
        d, valid = state(idx)
        active = valid & (r >= eps_t * torch.clamp(d, min=1.0))
    return idx.to(torch.int32), p, r, iters, overflowed


def ppr_push_sparse(graph: Graph, seeds, alpha: float = 0.15,
                    eps: float = 1e-4, max_iters: int = 200,
                    frontier_cap: Optional[int] = None) -> SparseFrontier:
    """Sparse-frontier ACL push: same dynamics as :func:`ppr_push`, memory
    ``O(S · cap)`` with ``cap = O(1/(alpha·eps))`` instead of ``O(S · n)``.

    Reads ``deg`` and the CSR. Check ``overflowed`` before consuming the
    result: True means the cap was exceeded mid-round and the buffers are
    truncated — callers must fall back to the dense push (spill).
    """
    seeds = _seeds(graph, seeds)
    s = seeds.numel()
    cap = frontier_cap_for(alpha, eps, graph.n, frontier_cap)
    with trace.span("ppr.push", mode="sparse", n=int(graph.n), cap=int(cap),
                    seeds=int(s)) as sp:
        idx, p, r, iters, ovf = _sparse_rounds(graph, seeds, alpha, eps,
                                               cap, max_iters)
        fr = SparseFrontier(idx=idx, p=p, r=r, iterations=iters,
                            overflowed=ovf, n=graph.n)
        size = int(fr.sizes().max()) if s else 0
        sp.set(frontier_size=size, spilled=ovf)
        REGISTRY.histogram("ppr.frontier_size").observe(size)
    return fr


def ppr_power_iteration(graph: Graph, seeds, alpha: float = 0.15,
                        iters: int = 200) -> torch.Tensor:
    """Dense power-iteration PPR reference: ``p ← α·e_s + (1−α)·A D⁻¹ p``,
    the fixed point :func:`ppr_push` approximates. Returns float32[S, n]."""
    seeds = _seeds(graph, seeds)
    n, dev = graph.n, graph.device
    deg = graph.deg.to(torch.float32)
    has = deg > 0
    src = graph.edges[:, 0].to(torch.int64)
    dst = graph.edges[:, 1].to(torch.int64)
    s_batch = seeds.numel()
    e_s = torch.zeros((s_batch, n), dtype=torch.float32, device=dev)
    e_s[torch.arange(s_batch, device=dev), seeds] = 1.0
    p = e_s
    for _ in range(iters):
        give = torch.where(has, p / torch.clamp(deg, min=1.0), 0.0)
        recv = torch.zeros_like(p)
        recv.index_add_(1, dst, give[:, src])
        recv.index_add_(1, src, give[:, dst])
        # deg-0 vertices hold their mass (matches push's absorb-to-p)
        hold = torch.where(has, 0.0, p)
        p = alpha * e_s + (1.0 - alpha) * (recv + hold)
    return p


# ----------------------------------------------------------------------------
# phase 2: sweep cut with sketch-gated cut increments
# ----------------------------------------------------------------------------

def _vertex_bloom_rows(order: torch.Tensor, n: int, words: int,
                       num_hashes: int, seed: int) -> torch.Tensor:
    """int32[S, k, words]: single-vertex Bloom rows for the sweep order,
    built by the sketch's own builder (same hash family and bit layout);
    the sentinel n gets an empty row."""
    s_batch, k = order.shape
    flat = order.reshape(-1)
    valid = flat < n
    indptr = torch.zeros(flat.numel() + 1, dtype=torch.int64,
                         device=order.device)
    indptr[1:] = torch.cumsum(valid, 0)
    rows = bloom_rows(indptr, flat[valid], words, num_hashes, seed)
    return rows.reshape(s_batch, k, words)


def _prefix_or(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-OR along dim 1 in ceil(log2 k) doubling steps."""
    shift = 1
    while shift < x.shape[1]:
        x = torch.cat([x[:, :shift], x[:, shift:] | x[:, :-shift]], dim=1)
        shift *= 2
    return x


def sweep_operands(sketch: SketchSet, order: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Bloom sweep's two dense AND2 operands, int32[S·k, words] each:
    the neighbourhood row ``B(N(order_j))`` and the exclusive prefix
    filter ``B(S_{j-1})`` of every step (row ``s·k + j``)."""
    words = sketch.data.shape[1]
    safe = torch.where(order < sketch.n, order, 0).to(torch.int64)
    elem = _vertex_bloom_rows(order, sketch.n, words, sketch.num_hashes,
                              sketch.seed)
    prefix = torch.cat([torch.zeros_like(elem[:, :1]),
                        _prefix_or(elem)[:, :-1]], dim=1)     # exclusive
    return (sketch.data[safe].reshape(-1, words),
            prefix.reshape(-1, words))


def _prefix_intersections(graph: Graph, order: torch.Tensor,
                          sketch: Optional[SketchSet],
                          plan: eng.EnginePlan) -> torch.Tensor:
    """float32[S, k]: |N(order_j) ∩ {order_0..order_{j-1}}| per sweep step.

    Bloom path (kind "bf"): the exclusive prefix-OR of single-vertex rows
    is ``B(S_{j-1})``; one AND+popcount against ``B(N(order_j))`` per
    step, through the compiled 2-way AND in dense form; then the OR
    estimator, since |N(v_j)| = d(v_j) and |S_{j-1}| = j are known.
    Exact path: each swept vertex's CSR row, counting neighbours whose
    sweep rank is smaller.
    """
    from ...engine import setexpr

    n = graph.n
    s_batch, k = order.shape
    safe = torch.where(order < n, order, 0).to(torch.int64)
    if sketch is not None and sketch.kind == "bf":
        nbr_rows, prefix = sweep_operands(sketch, order)
        u_row, v_row = setexpr.rows(2)
        ce = setexpr.compile_expr(u_row & v_row, block_w=plan.block_w,
                                  use_kernel=plan.use_kernel)
        ones_and = ce.ones_rows(nbr_rows, prefix)
        ones_or = (popcount32(nbr_rows).sum(-1) + popcount32(prefix).sum(-1)
                   - ones_and).view(s_batch, k)
        union_est = bf_intersection_and_from_ones(ones_or, sketch.total_bits,
                                                  sketch.num_hashes)
        d_j = graph.deg[safe].to(torch.float32)
        psize = torch.arange(k, dtype=torch.float32,
                             device=order.device)[None, :]  # |S_{j-1}| = j
        est = d_j + psize - union_est
        # an intersection is bounded by the smaller of the two true sets
        return torch.minimum(torch.clamp(est, min=0.0),
                             torch.minimum(d_j, psize))

    # exact: rank-compare over the CSR rows of the swept vertices
    rank = torch.full((s_batch, n + 1), k, dtype=torch.int32,
                      device=order.device)
    steps = torch.arange(k, dtype=torch.int32, device=order.device)
    rank[torch.arange(s_batch, device=order.device)[:, None],
         order.to(torch.int64)] = steps.expand(s_batch, k)
    rank[:, n] = k                                    # the sentinel's column
    flat = torch.nonzero(order.reshape(-1) < n).squeeze(1)
    out = torch.zeros(s_batch * k, dtype=torch.int64, device=order.device)
    for item, _, w in row_elements(graph, safe.reshape(-1)[flat]):
        at = flat[item]
        hit = rank[at // k, w] < (at % k)
        out += torch.bincount(at[hit], minlength=s_batch * k)
    return out.view(s_batch, k).to(torch.float32)


def _sweep_scan(graph: Graph, order: torch.Tensor, in_sweep: torch.Tensor,
                sketch: Optional[SketchSet], plan: eng.EnginePlan):
    """Conductance scan over an already-derived sweep order, shared by the
    dense and sparse entries: on the same ``(order, in_sweep)`` the two
    paths' profiles are bit-identical."""
    n = graph.n
    deg = graph.deg.to(torch.float32)
    support = in_sweep.sum(1).to(torch.int32)
    d_j = torch.where(in_sweep, deg[order.to(torch.int64).clamp(max=n - 1)],
                      0.0)
    inter = torch.where(in_sweep,
                        _prefix_intersections(graph, order, sketch, plan), 0.0)
    vol = torch.cumsum(d_j, 1)
    cut = torch.clamp(torch.cumsum(d_j - 2.0 * inter, 1), min=0.0)
    vol_rest = _f32(2.0 * graph.m, order.device) - vol
    denom = torch.minimum(vol, vol_rest)
    ok = in_sweep & (denom > 0.0)
    conductance = torch.where(ok, cut / torch.clamp(denom, min=1.0),
                              torch.inf)
    return order, conductance, support


def _top(score: torch.Tensor, k: int):
    """The k largest scores per row and their positions, ties by smallest
    position (as ``jax.lax.top_k``)."""
    top, pos = torch.sort(score, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]


def sweep_cut(graph: Graph, ppr, sketch: Optional[SketchSet] = None,
              plan: Optional[eng.EnginePlan] = None):
    """Batched sweep-cut conductance scan over degree-normalized PPR mass.

    Args:
      graph:  the graph the PPR vectors live on.
      ppr:    float32[S, n] PPR estimates (from :func:`ppr_push`) or a
              :class:`SparseFrontier` (from :func:`ppr_push_sparse`), whose
              support table is swept directly.
      sketch: a Bloom sketch routes the cut increments through
              prefix-filter AND+popcounts; anything else (or None) counts
              them exactly.
      plan:   ``plan.sweep_cap`` bounds the swept prefix length and
              ``plan.use_kernel`` launches the CUDA popcount.

    Returns:
      ``(order, conductance, support)`` — int32[S, k] sweep order,
      float32[S, k] per-prefix conductance (inf at invalid prefixes), and
      int32[S] number of positive-mass vertices swept.
    """
    plan = plan if plan is not None else eng.plan_for(graph, sketch)
    n = graph.n
    deg = graph.deg.to(torch.float32)
    if isinstance(ppr, SparseFrontier):
        idx = ppr.idx.to(torch.int64)
        valid = idx < n
        d = torch.where(valid, deg[idx.clamp(max=n - 1)], 1.0)
        # invalid slots score -1 so they sort after every real score; the
        # table is ascending by id, so ties go to the smallest id
        score = torch.where(valid, ppr.p / torch.clamp(d, min=1.0), -1.0)
        top, pos = _top(score, max(1, min(int(plan.sweep_cap), ppr.cap, n)))
        order = idx.gather(1, pos)
    else:
        score = ppr / torch.clamp(deg, min=1.0)[None, :]
        top, order = _top(score, max(1, min(int(plan.sweep_cap), n)))
    in_sweep = top > 0.0
    order = torch.where(in_sweep, order, n).to(torch.int32)
    return _sweep_scan(graph, order, in_sweep, sketch, plan)


def local_cluster(graph: Graph, seeds, alpha: float = 0.15, eps: float = 1e-4,
                  sketch: Optional[SketchSet] = None,
                  plan: Optional[eng.EnginePlan] = None,
                  max_iters: int = 200, **kw) -> LocalClusterResult:
    """Seed-centric local clustering: PPR push then a sweep-cut scan.

    Args:
      graph:  the graph.
      seeds:  int[S] (or scalar) seed vertex ids.
      alpha:  PPR teleport probability.
      eps:    push tolerance (smaller = larger support, better clusters).
      sketch: optional SketchSet ("bf" engages the prefix-filter sweep;
              others count exactly).
      plan:   EnginePlan or per-call kwargs (``sweep_cap=``,
              ``use_kernel=``, ``frontier_mode=``, ``frontier_cap=``).
      max_iters: push round cap.

    Returns:
      A :class:`LocalClusterResult`. A sparse-path overflow spills to the
      dense push (``result.spilled``; the ``ppr.spill`` counter counts it).
    """
    plan = eng.resolve_plan(plan, graph, sketch, kw)
    seeds = _seeds(graph, seeds)
    mode = resolve_frontier_mode(plan, graph.n, alpha, eps)
    frontier = None
    spilled = False
    if mode == "sparse":
        fr = ppr_push_sparse(graph, seeds, alpha, eps, max_iters,
                             plan.frontier_cap)
        if fr.overflowed:
            spilled = True
            REGISTRY.counter("ppr.spill").inc()
        else:
            frontier = fr
    if frontier is not None:
        p = r = None
        iters = frontier.iterations
        order, conductance, support = sweep_cut(graph, frontier, sketch, plan)
    else:
        p, r, iters = ppr_push(graph, seeds, alpha, eps, max_iters)
        order, conductance, support = sweep_cut(graph, p, sketch, plan)
    best_idx = torch.argmin(conductance, dim=1)
    best_phi = conductance.gather(1, best_idx[:, None])[:, 0]
    # an all-inf profile (no valid prefix) has no cluster
    best_size = torch.where(torch.isfinite(best_phi), best_idx + 1, 0)
    return LocalClusterResult(
        order=order, conductance=conductance,
        best_idx=best_idx.to(torch.int32), best_conductance=best_phi,
        best_size=best_size.to(torch.int32), support=support, ppr=p,
        residual=r, iterations=iters, frontier=frontier, spilled=spilled)


__all__ = ["LocalClusterResult", "SparseFrontier", "frontier_cap_for",
           "local_cluster", "ppr_power_iteration", "ppr_push",
           "ppr_push_sparse", "resolve_frontier_mode", "sweep_cut",
           "sweep_operands"]
