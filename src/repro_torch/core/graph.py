"""Graph model: CSR on the device, generators, and host utilities.

The JAX package keeps a padded adjacency ``adj[n, d_max]`` beside the CSR.
That layout does not fit a graph of real size (a Kronecker graph of scale
21 has d_max ≈ 10^5, so ``adj`` would take ~860 GB), so here ``adj`` is
built only when something reads it. Nothing on the Bloom triangle-counting
path does: sketches are built from the CSR arrays. When it is built, it is
array-identical to the reference's (rows sorted, pad value ``n``).

The generators are the reference's numpy code with the same seeded RNG
calls, so a graph here is array-identical to the reference graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph in CSR form (tensors on one device).

    Attributes:
      indptr:  int32[n+1]   CSR row pointers.
      indices: int32[2m]    concatenated sorted neighbor lists.
      deg:     int32[n]     vertex degrees.
      edges:   int32[m, 2]  unique undirected edges with u < v, sorted.
      n_vertices / n_edges / d_max: ints (d_max is at least 1).
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    deg: torch.Tensor
    edges: torch.Tensor
    n_vertices: int
    n_edges: int
    d_max: int
    _adj: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        """Number of vertices."""
        return self.n_vertices

    @property
    def m(self) -> int:
        """Number of undirected edges."""
        return self.n_edges

    @property
    def device(self) -> torch.device:
        """The device every array of the graph lives on."""
        return self.indptr.device

    @property
    def adj(self) -> torch.Tensor:
        """int32[n, d_max] padded adjacency (pad value ``n``), built on
        first access from the CSR and kept."""
        if self._adj is None:
            n = self.n
            adj = torch.full((n, self.d_max), n, dtype=torch.int32,
                             device=self.device)
            src = torch.repeat_interleave(
                torch.arange(n, device=self.device), self.deg.to(torch.int64))
            col = (torch.arange(src.numel(), device=self.device)
                   - self.indptr[:-1].to(torch.int64)[src])
            adj[src, col] = self.indices
            object.__setattr__(self, "_adj", adj)
        return self._adj

    def to(self, device: DeviceLike) -> "Graph":
        """The same graph with its arrays on ``device``."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return Graph(indptr=self.indptr.to(dev), indices=self.indices.to(dev),
                     deg=self.deg.to(dev), edges=self.edges.to(dev),
                     n_vertices=self.n_vertices, n_edges=self.n_edges,
                     d_max=self.d_max,
                     _adj=None if self._adj is None else self._adj.to(dev))


def canonical_edge_keys(n: int, edges,
                        device: DeviceLike = DEFAULT_DEVICE) -> torch.Tensor:
    """Sorted unique canonical keys ``lo·n + hi`` (u < v) of a raw edge
    array, int64 on ``device``.

    Self loops and out-of-range endpoints are dropped; ``n == 0`` yields an
    empty key set.
    """
    dev = resolve_device(device)
    e = torch.from_numpy(np.asarray(
        edges if edges is not None else np.zeros((0, 2)),
        dtype=np.int64).reshape(-1, 2)).to(dev)
    u, v = e[:, 0], e[:, 1]
    keep = (u != v) & (u >= 0) & (v >= 0) & (u < n) & (v < n)
    u, v = u[keep], v[keep]
    return torch.unique(torch.minimum(u, v) * n + torch.maximum(u, v))


def from_edge_array(n: int, edges: np.ndarray,
                    pad_to_max_degree: Optional[int] = None,
                    device: DeviceLike = DEFAULT_DEVICE) -> Graph:
    """Build a Graph from a (possibly duplicated / both-direction) edge array.

    The edges go to ``device`` first and every step runs there: the unique
    canonical keys (:func:`canonical_edge_keys`), one sort of the directed
    keys (CSR order) and the degrees. On a GPU the set-up's sorts then take
    milliseconds where the host's take seconds at Kronecker scale 21; the
    arrays are the same integers on any device.
    """
    dev = resolve_device(device)
    key = canonical_edge_keys(n, edges, device=dev)
    span = max(n, 1)
    lo, hi = key // span, key % span
    m = int(key.numel())

    # symmetric CSR ordered by (src, dst): one sort of the directed keys,
    # which orders as the reference's lexsort((dst, src)) since keys are
    # unique
    directed = torch.sort(torch.cat([key, hi * n + lo])).values
    deg = torch.bincount(directed // span, minlength=n).to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    d_max = int(deg.max()) if m else 0
    if pad_to_max_degree is not None:
        d_max = max(d_max, pad_to_max_degree)
    d_max = max(d_max, 1)

    return Graph(
        indptr=indptr, indices=(directed % span).to(torch.int32), deg=deg,
        edges=torch.stack([lo, hi], dim=1).to(torch.int32),
        n_vertices=int(n), n_edges=m, d_max=int(d_max))


def device_csr(n: int, deg: torch.Tensor, edges: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR ``(indptr int32[n+1], indices int32[2m])`` of a canonical edge
    list, derived on its device.

    ``deg`` int32[n], ``edges`` int32[m, 2] (u < v). indptr is a cumsum of
    deg, and indices come from sorting both directions of the edge list by
    the key ``src·n + dst``, which orders them as :func:`from_edge_array`
    does.
    """
    dev = deg.device
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    e = edges.to(torch.int64)
    directed = torch.sort(torch.cat([e[:, 0] * n + e[:, 1],
                                     e[:, 1] * n + e[:, 0]])).values
    return indptr, (directed % max(n, 1)).to(torch.int32)


def graph_view(n: int, m: int, deg: torch.Tensor, edges: torch.Tensor,
               indptr: torch.Tensor, indices: torch.Tensor,
               d_max: int) -> Graph:
    """``Graph`` over live device buffers, with no copy and no adjacency.

    ``deg`` int32[n], ``edges`` int32[m, 2] in canonical key order, the CSR
    ``indptr``/``indices`` of those edges (:func:`device_csr`) and
    ``d_max`` the true maximum degree (at least 1), as
    :func:`from_edge_array` gives it.
    """
    return Graph(indptr=indptr, indices=indices, deg=deg, edges=edges,
                 n_vertices=int(n), n_edges=int(m), d_max=max(int(d_max), 1))


# ----------------------------------------------------------------------------
# Generators (paper: Kronecker power-law synthetics)
# ----------------------------------------------------------------------------

def erdos_renyi(n: int, p: float, seed: int = 0,
                device: DeviceLike = DEFAULT_DEVICE) -> Graph:
    """G(n, p) with the reference's seeded draws."""
    resolve_device(device)
    rng = np.random.default_rng(seed)
    max_pairs = n * (n - 1) // 2
    if max_pairs == 0 or p <= 0.0:
        return from_edge_array(n, np.zeros((0, 2), dtype=np.int64),
                               device=device)
    if max_pairs <= 4_000_000:
        iu = np.triu_indices(n, k=1)
        mask = rng.random(iu[0].shape[0]) < p
        edges = np.stack([iu[0][mask], iu[1][mask]], axis=1)
    else:
        # geometric skipping over the linearized upper triangle: the exact
        # Bernoulli process without n² memory
        sel = []
        pos = np.int64(-1)
        batch = int(1.2 * p * max_pairs) + 1024
        while pos < max_pairs:
            gaps = rng.geometric(p, size=batch).astype(np.int64)
            steps = np.cumsum(gaps) + pos
            sel.append(steps[steps < max_pairs])
            pos = steps[-1]
        t = np.concatenate(sel)
        edges = np.stack(_triu_unrank(t, n), axis=1)
    return from_edge_array(n, edges, device=device)


def _triu_unrank(t: np.ndarray, n: int):
    """Linear index t in the row-major strict upper triangle -> (u, v), u < v."""
    u = np.floor((2.0 * n - 1.0 - np.sqrt((2.0 * n - 1.0) ** 2 - 8.0 * t)) / 2.0
                 ).astype(np.int64)
    for _ in range(2):
        start = u * (2 * n - 1 - u) // 2
        u = np.where(start > t, u - 1, u)
        end = (u + 1) * (2 * n - 2 - u) // 2
        u = np.where(end <= t, u + 1, u)
    v = t - u * (2 * n - 1 - u) // 2 + u + 1
    return u, v


def kronecker(scale: int, edge_factor: int = 16, seed: int = 0,
              a: float = 0.57, b: float = 0.19, c: float = 0.19,
              device: DeviceLike = DEFAULT_DEVICE) -> Graph:
    """Graph500-style stochastic Kronecker (power-law degree distribution)."""
    resolve_device(device)
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab
        thresh = np.where(src_bit, c / (1.0 - ab), a / ab)
        dst_bit = r2 > thresh
        src += src_bit.astype(np.int64) << bit
        dst += dst_bit.astype(np.int64) << bit
    # permute vertex ids to destroy locality (standard practice)
    perm = rng.permutation(n)
    return from_edge_array(n, np.stack([perm[src], perm[dst]], axis=1),
                           device=device)


def barabasi_albert(n: int, m_attach: int = 4, seed: int = 0,
                    device: DeviceLike = DEFAULT_DEVICE) -> Graph:
    """Preferential-attachment power-law graph (the reference's host
    construction and seeded draws)."""
    resolve_device(device)
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = []
    edges = []
    for v in range(m_attach, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m_attach)
        idx = rng.integers(0, len(repeated), size=m_attach)
        targets = [repeated[i] for i in idx]
    return from_edge_array(n, np.asarray(edges, dtype=np.int64),
                           device=device)


def random_bipartite_community(n: int, communities: int, p_in: float,
                               p_out: float, seed: int = 0,
                               device: DeviceLike = DEFAULT_DEVICE) -> Graph:
    """Planted-partition graph: dense communities, sparse cross edges (the
    reference's seeded draws)."""
    resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, communities, size=n)
    u = rng.integers(0, n, size=int(6 * n * max(p_in, 1e-6) * n
                                    / communities) + 4 * n)
    v = rng.integers(0, n, size=u.shape[0])
    same = labels[u] == labels[v]
    keep = np.where(same, rng.random(u.shape[0]) < p_in,
                    rng.random(u.shape[0]) < p_out)
    return from_edge_array(n, np.stack([u[keep], v[keep]], axis=1),
                           device=device)


# ----------------------------------------------------------------------------
# Host helpers
# ----------------------------------------------------------------------------

def neighbors_np(g: Graph, v: int) -> np.ndarray:
    """Sorted neighbor ids of ``v`` as a host array."""
    lo, hi = (int(x) for x in g.indptr[v:v + 2].cpu())
    return g.indices[lo:hi].cpu().numpy()


def edge_keys(g: Graph) -> torch.Tensor:
    """Sorted canonical keys ``u·n + v`` (u < v) of ``g.edges``: int64[m]."""
    e = g.edges.to(torch.int64)
    return e[:, 0] * g.n + e[:, 1]


def has_edge(keys: torch.Tensor, n: int, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Whether {a, b} is an edge, by binary search of ``keys``
    (:func:`edge_keys`): bool, broadcast shape of ``a`` and ``b``. This
    replaces the reference's search of the padded ``adj`` rows."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    want = torch.minimum(a, b) * n + torch.maximum(a, b)
    if keys.numel() == 0:
        return torch.zeros_like(want, dtype=torch.bool)
    pos = torch.searchsorted(keys, want).clamp_(max=keys.numel() - 1)
    return keys[pos] == want


def four_clique_count_bruteforce(g: Graph) -> int:
    """Exact 4-clique oracle (tiny graphs only): O(m * d^2)."""
    adj_sets = [set(neighbors_np(g, v).tolist()) for v in range(g.n)]
    count = 0
    for u, v in g.edges.cpu().numpy():
        common = sorted(adj_sets[u] & adj_sets[v])
        for i, wi in enumerate(common):
            for wj in common[i + 1:]:
                if wj in adj_sets[wi]:
                    count += 1
    return count // 6  # each 4-clique counted once per each of its 6 edges


def triangle_count_dense(g: Graph) -> int:
    """Exact TC oracle via dense A^3 trace (small graphs only)."""
    n = g.n
    a = np.zeros((n, n), dtype=np.int64)
    e = g.edges.cpu().numpy()
    a[e[:, 0], e[:, 1]] = 1
    a[e[:, 1], e[:, 0]] = 1
    return int(np.trace(a @ a @ a) // 6)
