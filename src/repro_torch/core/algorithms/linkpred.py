"""Link-prediction effectiveness testing (paper Listing 5).

Remove a random subset E_rndm of edges, score candidate pairs on the sparse
graph with a similarity measure S, predict the top-|E_rndm| pairs, and report
ef = |E_predict ∩ E_rndm| / |E_rndm|. Candidates are distance-2 pairs of the
sparse graph (wedge endpoints), as in the reference.

The reference enumerates the wedges in a Python loop over host sets. Here
the enumeration runs on the graph's device in pieces of about
``_CHUNK_WEDGES`` wedges, in the reference's order (v ascending, then
i < j within v's sorted CSR row), a hub's row cut across pieces as the
clique enumeration cuts its own; pairs that are edges are dropped by the
edge-key search, and the first ``limit`` distinct pairs are kept, after
which no further piece is read. The reference's ``break`` leaves only its
inner loop, so past the limit it keeps adding pairs; below the limit the
two sets are equal. Each call sets the gauges ``linkpred_wedges_read`` and
``linkpred_candidates`` of :data:`repro_torch.obs.metrics.REGISTRY`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import engine as eng
from ...obs.metrics import REGISTRY
from ..graph import Graph, edge_keys, from_edge_array, has_edge
from ..sketches import SketchSet, build
from .similarity import pair_similarity

#: wedges one enumeration piece holds, about; each takes a few int64
#: temporaries, so a piece stays near 1 GiB
_CHUNK_WEDGES = 1 << 24


def split_edges(graph: Graph, removed_fraction: float, seed: int = 0
                ) -> Tuple[Graph, np.ndarray]:
    """Returns (sparse graph on the graph's device, removed edge array
    int32[R, 2]): the reference's host permutation, so the split is the
    same."""
    rng = np.random.default_rng(seed)
    edges = graph.edges.cpu().numpy()
    m = edges.shape[0]
    r = max(1, int(removed_fraction * m))
    idx = rng.permutation(m)
    removed = edges[idx[:r]]
    kept = edges[idx[r:]]
    sparse = from_edge_array(graph.n, kept, device=graph.device)
    return sparse, removed


def _triu_unrank(q: torch.Tensor, d: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position q in the row-major strict upper triangle of a d × d
    matrix -> (i, j), i < j (int64, elementwise over d)."""
    df = d.to(torch.float64)
    qf = q.to(torch.float64)
    i = torch.floor((2.0 * df - 1.0 - torch.sqrt(
        torch.clamp((2.0 * df - 1.0) ** 2 - 8.0 * qf, min=0.0))) / 2.0
    ).to(torch.int64)
    for _ in range(2):             # the rare off-by-one of the float root
        start = i * (2 * d - 1 - i) // 2
        i = torch.where(start > q, i - 1, i)
        end = (i + 1) * (2 * d - 2 - i) // 2
        i = torch.where(end <= q, i + 1, i)
    j = q - i * (2 * d - 1 - i) // 2 + i + 1
    return i, j


def _distance2_candidates(sparse: Graph, limit: int = 2_000_000
                          ) -> torch.Tensor:
    """Distance-2 non-adjacent pairs (u < w) of the sparse graph: the first
    ``limit`` distinct ones in wedge order, sorted: int32[P, 2] on the
    graph's device."""
    dev, n = sparse.device, sparse.n
    deg = sparse.deg.to(torch.int64)
    wedges = deg * (deg - 1) // 2
    cum = torch.cumsum(wedges, 0)
    total = int(cum[-1]) if n else 0
    indptr = sparse.indptr.to(torch.int64)
    keys = edge_keys(sparse)
    found = torch.zeros(0, dtype=torch.int64, device=dev)   # sorted
    pos = 0
    while pos < total and found.numel() < limit:
        end = min(total, pos + _CHUNK_WEDGES)
        t = torch.arange(pos, end, device=dev)
        vtx = torch.searchsorted(cum, t, right=True)
        i, j = _triu_unrank(t - (cum[vtx] - wedges[vtx]), deg[vtx])
        a = sparse.indices[indptr[vtx] + i].to(torch.int64)
        b = sparse.indices[indptr[vtx] + j].to(torch.int64)
        key = (a * n + b)[~has_edge(keys, n, a, b)]
        # each distinct pair's first wedge in this piece
        uniq, inv = torch.unique(key, return_inverse=True)
        first = torch.full((uniq.numel(),), key.numel(), dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, inv, torch.arange(key.numel(), device=dev), "amin")
        new = ~torch.isin(uniq, found)
        uniq, first = uniq[new], first[new]
        room = limit - found.numel()
        if uniq.numel() > room:          # keep the first ones in wedge order
            uniq = uniq[torch.sort(first).indices[:room]]
        found = torch.sort(torch.cat([found, uniq])).values
        pos = end
    REGISTRY.gauge("linkpred_wedges_read").set(pos)
    REGISTRY.gauge("linkpred_candidates").set(int(found.numel()))
    return torch.stack([found // max(n, 1), found % max(n, 1)],
                       dim=1).to(torch.int32)


def link_prediction_effectiveness(graph: Graph, measure: str = "common",
                                  removed_fraction: float = 0.1,
                                  sketch_kind: Optional[str] = None,
                                  storage_budget: float = 0.25,
                                  num_hashes: int = 2, seed: int = 0,
                                  plan: Optional[eng.EnginePlan] = None
                                  ) -> float:
    """Full Listing-5 protocol; returns ef ∈ [0, 1].

    Ranking is a stable descending sort, ties in candidate order, as the
    reference's ``np.argsort(-scores, kind="stable")``; the hits are
    counted over int64 pair keys."""
    sparse, removed = split_edges(graph, removed_fraction, seed)
    candidates = _distance2_candidates(sparse)
    if candidates.shape[0] == 0:
        return 0.0
    sketch: Optional[SketchSet] = None
    if sketch_kind is not None:
        sketch = build(sparse, sketch_kind, storage_budget,
                       num_hashes=num_hashes, seed=seed)
    scores = pair_similarity(sparse, candidates, measure, sketch, plan=plan)
    r = removed.shape[0]
    top = torch.sort(-scores, stable=True).indices[:r]
    n = graph.n
    pred = candidates[top].to(torch.int64)
    pred_keys = pred[:, 0] * n + pred[:, 1]
    rem = torch.from_numpy(removed.astype(np.int64)).to(sparse.device)
    truth = torch.minimum(rem[:, 0], rem[:, 1]) * n + torch.maximum(
        rem[:, 0], rem[:, 1])
    return int(torch.isin(pred_keys, truth).sum()) / r
