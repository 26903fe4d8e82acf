"""The undirected simple graph of a raw edge array, in CSR form: whole
(``build``), or the rows of one vertex range (``build_range``), which is
what one rank of a cell over several cards checks against."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RefGraph:
    """CSR of the simple undirected graph on ``n`` vertices.

    ``edges`` int64[m, 2] holds each edge once as (u, v) with u < v, in
    ascending (u, v) order; ``indptr`` int64[n+1], ``indices`` int64[2m]
    (each row ascending) and ``deg`` int64[n] are its symmetric CSR.

    A range graph (``build_range``) holds the rows of vertices
    [lo, lo + len(deg)) alone: the edges whose u lies there, and those
    rows' CSR with ``indptr`` counted from the range's first entry.
    """

    n: int
    edges: torch.Tensor
    indptr: torch.Tensor
    indices: torch.Tensor
    deg: torch.Tensor
    lo: int = 0

    @property
    def m(self) -> int:
        """The edges held: the whole graph's, or a range's part of them."""
        return int(self.edges.shape[0])

    @property
    def d_max(self) -> int:
        """The largest degree of the rows held, at least 1."""
        return max(int(self.deg.max()) if self.deg.numel() else 0, 1)

    def rows(self) -> torch.Tensor:
        """int64[entries]: the row (source vertex) of every CSR entry."""
        return torch.repeat_interleave(
            torch.arange(self.lo, self.lo + self.deg.numel(),
                         device=self.deg.device), self.deg)


def build(n: int, raw: torch.Tensor) -> RefGraph:
    """The graph of ``raw`` int64[E, 2]: self loops and endpoints outside
    [0, n) dropped, both directions and repeats of an edge merged."""
    u, v = raw[:, 0], raw[:, 1]
    keep = (u != v) & (u >= 0) & (v >= 0) & (u < n) & (v < n)
    lo = torch.minimum(u, v)[keep]
    hi = torch.maximum(u, v)[keep]
    key = torch.unique_consecutive(torch.sort(lo * n + hi).values)
    edges = torch.stack([key // n, key % n], dim=1)
    # symmetric CSR: order the directed entries by destination, then
    # stably by source (a two-key lexicographic sort)
    src = torch.cat([edges[:, 0], edges[:, 1]])
    dst = torch.cat([edges[:, 1], edges[:, 0]])
    order = torch.sort(dst, stable=True).indices
    order = order[torch.sort(src[order], stable=True).indices]
    deg = torch.bincount(src, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=raw.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return RefGraph(n=n, edges=edges, indptr=indptr, indices=dst[order],
                    deg=deg)


def touching(raw: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The rows of ``raw`` with an endpoint in [lo, hi): all that
    ``build_range(n, raw, lo, hi)`` reads, in their order."""
    u, v = raw[:, 0], raw[:, 1]
    return raw[((u >= lo) & (u < hi)) | ((v >= lo) & (v < hi))]


def build_range(n: int, raw: torch.Tensor, lo: int, hi: int) -> RefGraph:
    """The rows of vertices [lo, hi) of ``build(n, raw)``, made from the
    raw edges that touch the range alone: its edges (u, v), u < v, with u
    in [lo, hi) (``edges`` of ``build`` where u lies in the range), and
    those rows' CSR (``deg[lo:hi]``, ``indices[indptr[lo]:indptr[hi]]``,
    ``indptr[lo:hi + 1] - indptr[lo]``). Each temporary is freed at its
    last use, since a rank builds this beside the program's graph."""
    u, v = raw[:, 0], raw[:, 1]
    keep = (u != v) & (u >= 0) & (v >= 0) & (u < n) & (v < n)
    keep &= ((u >= lo) & (u < hi)) | ((v >= lo) & (v < hi))
    a, b = u[keep], v[keep]
    del keep
    key = torch.minimum(a, b)
    torch.maximum(a, b, out=b)
    del a
    key = key.mul_(n).add_(b)
    del b
    key = torch.unique(key)     # sorted
    a, b = key // n, key % n
    del key
    a_in = (a >= lo) & (a < hi)
    b_in = (b >= lo) & (b < hi)
    edges = torch.stack([a[a_in], b[a_in]], dim=1)
    # the directed entries whose source lies in the range, each once, in
    # (source, destination) order as in ``build``
    src = torch.cat([a[a_in], b[b_in]])
    dst = torch.cat([b[a_in], a[b_in]])
    del a, b, a_in, b_in
    src -= lo
    deg = torch.bincount(src, minlength=hi - lo)
    entry = src.mul_(n).add_(dst)
    del src, dst
    indices = torch.sort(entry).values.remainder_(n)
    del entry
    indptr = torch.zeros(hi - lo + 1, dtype=torch.int64, device=raw.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return RefGraph(n=n, edges=edges, indptr=indptr, indices=indices,
                    deg=deg, lo=lo)
