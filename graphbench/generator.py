"""Graph500's stochastic Kronecker generator, drawn on the device.

Each of the ``edge_factor · 2^scale`` edges picks one quadrant of the
adjacency matrix per bit of its endpoints, with probabilities (A, B, C,
1 − A − B − C); vertex ids and the order of the edge list are then
permuted at random (Graph500 specification §3; the same law as
``repro_torch.core.graph.kronecker``, which draws on the host). Self loops
and repeated edges are kept: the loader under test drops them.

The quadrants and the vertex permutation are drawn from the
configuration's ``graph_seed`` and the order of the edge list from the
run's seed, so every run of a configuration mines the same graph, handed
to the loader in another order: the same sizes, degrees and clique
candidates, the same work. (Labels drawn per run would change the work:
the 4-clique pass enumerates the neighbours above each vertex, whose
count depends on the labels of the hubs.) Each stream is one
``torch.Generator`` on ``device``, so a seed gives the same edges on the
same device and PyTorch build.
"""
from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one purpose (``labels``) of a run's ``seed``."""
    text = ":".join(str(x) for x in (seed, *labels)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def kronecker_edges(config: dict, seed: int, device) -> torch.Tensor:
    """int64[edge_factor · 2^scale, 2] raw Kronecker edges on ``device``,
    of a configuration's ``scale``, ``edge_factor``, ``a``, ``b``, ``c``
    and ``graph_seed``, in an order drawn from the run's ``seed``."""
    if config["generator"] != "graph500_kronecker":
        raise ValueError(f"unknown generator {config['generator']!r}")
    scale, edge_factor = config["scale"], config["edge_factor"]
    a, b, c = config["a"], config["b"], config["c"]
    n = 1 << scale
    m = edge_factor * n
    # the order of the edge list first, from a generator of its own seeded
    # as the draw's would be for it: randperm(m) holds about six int64
    # columns at once, so it runs before src and dst exist
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "order"))
    order = torch.randperm(m, generator=gen, device=device)
    gen.manual_seed(derive_seed(config["graph_seed"], "kronecker"))
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    ab = a + b
    # P(dst bit | src bit): B / (A + B) after a 0, D / (C + D) after a 1
    threshold = torch.tensor([a / ab, c / (1.0 - ab)], dtype=torch.float64,
                             device=device)
    # each intermediate is freed at its last use: at scale 26 an int64
    # column is 8 GiB and a draw of r 16 GiB
    for bit in range(scale):
        r = torch.rand((2, m), generator=gen, device=device,
                       dtype=torch.float64)
        src_bit = r[0] > ab
        # r[1] > threshold[src_bit], without its float64 gather
        dst_bit = torch.where(src_bit, r[1] > threshold[1],
                              r[1] > threshold[0])
        del r
        # bit ``bit`` of src and dst is still 0, so the add is the OR
        src.add_(src_bit, alpha=1 << bit)
        dst.add_(dst_bit, alpha=1 << bit)
        del src_bit, dst_bit
    perm = torch.randperm(n, generator=gen, device=device)
    u = src[order]
    del src
    u = perm[u]
    v = dst[order]
    del dst, order
    v = perm[v]
    return torch.stack([u, v], dim=1)
