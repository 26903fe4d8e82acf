"""The undirected simple graph of a raw edge array, in CSR form."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RefGraph:
    """CSR of the simple undirected graph on ``n`` vertices.

    ``edges`` int64[m, 2] holds each edge once as (u, v) with u < v, in
    ascending (u, v) order; ``indptr`` int64[n+1], ``indices`` int64[2m]
    (each row ascending) and ``deg`` int64[n] are its symmetric CSR.
    """

    n: int
    edges: torch.Tensor
    indptr: torch.Tensor
    indices: torch.Tensor
    deg: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    @property
    def d_max(self) -> int:
        """The largest degree, at least 1."""
        return max(int(self.deg.max()) if self.n else 0, 1)

    def rows(self) -> torch.Tensor:
        """int64[2m]: the row (source vertex) of every CSR entry."""
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.deg.device), self.deg)


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
