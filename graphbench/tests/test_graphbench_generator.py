"""The benchmark's Kronecker generator follows the law of the program's
host generator, ``repro_torch.core.graph.kronecker``, and a run seed only
reorders a configuration's graph.

The two draw from different random streams, so their graphs differ edge by
edge; what must agree is the law. Over 4 seeds each at scale 12 (edge
factor 16, A, B, C = 0.57, 0.19, 0.19), the means of the de-duplicated
edge count, the largest degree, the share of isolated vertices, the
number of vertices of degree 64 or more and the share of edge endpoints
held by the top 1% of vertices agree within tolerances of about five
standard deviations of the difference of two such means, measured over 8
seeds of each generator: m 1% (seed-to-seed 0.2%), d_max 6% (1.8%),
isolated share 0.01 (0.003), hubs 3% (0.2%), top-1% share 2% (0.3%).
"""
import statistics

import pytest
import torch

from graphbench import generator
from graphbench.reference import graph as ref_graph

SCALE = 12
CONFIG = {"generator": "graph500_kronecker", "scale": SCALE,
          "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
          "graph_seed": 1}


def _law(deg: torch.Tensor, m: int) -> dict:
    deg = deg.to(torch.float64)
    top = torch.sort(deg, descending=True).values[:deg.numel() // 100 + 1]
    return {"m": m, "d_max": float(deg.max()),
            "isolated": float((deg == 0).to(torch.float64).mean()),
            "hubs": float((deg >= 64).sum()),
            "top_share": float(top.sum() / (2 * m))}


def _mean(laws, key):
    return statistics.mean(x[key] for x in laws)


def test_law_matches_the_programs_generator():
    from repro_torch.core.graph import kronecker

    ours, theirs = [], []
    for s in range(4):
        raw = generator.kronecker_edges(dict(CONFIG, graph_seed=500 + s),
                                        7, "cpu")
        assert raw.shape == (16 << SCALE, 2)
        rg = ref_graph.build(1 << SCALE, raw)
        ours.append(_law(rg.deg, rg.m))
        g = kronecker(SCALE, 16, seed=s, device="cpu")
        theirs.append(_law(g.deg, g.m))
    for key, rel in (("m", 0.01), ("d_max", 0.06), ("hubs", 0.03),
                     ("top_share", 0.02)):
        assert _mean(ours, key) == pytest.approx(_mean(theirs, key),
                                                 rel=rel), key
    assert _mean(ours, "isolated") == pytest.approx(
        _mean(theirs, "isolated"), abs=0.01)


def test_run_seeds_reorder_one_graph():
    """Runs of one configuration mine the same graph: another run seed
    hands the loader the same edges in another order."""
    raw_a = generator.kronecker_edges(CONFIG, 3, "cpu")
    raw_b = generator.kronecker_edges(CONFIG, 4, "cpu")
    assert not torch.equal(raw_a, raw_b)
    a = ref_graph.build(1 << SCALE, raw_a)
    b = ref_graph.build(1 << SCALE, raw_b)
    assert torch.equal(a.edges, b.edges) and torch.equal(a.deg, b.deg)
    other = ref_graph.build(1 << SCALE, generator.kronecker_edges(
        dict(CONFIG, graph_seed=2), 3, "cpu"))
    assert not torch.equal(a.edges, other.edges)


def test_same_seed_same_edges_and_seeds_differ():
    a = generator.kronecker_edges(CONFIG, 2 ** 33 + 5, "cpu")
    assert torch.equal(a, generator.kronecker_edges(CONFIG, 2 ** 33 + 5,
                                                    "cpu"))
    assert not torch.equal(a, generator.kronecker_edges(CONFIG, 6, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 1 << SCALE


def _draw_before(config: dict, seed: int, device) -> torch.Tensor:
    """``kronecker_edges`` as it was before its intermediates were freed
    at their last use (a frozen copy)."""
    scale, edge_factor = config["scale"], config["edge_factor"]
    a, b, c = config["a"], config["b"], config["c"]
    n = 1 << scale
    m = edge_factor * n
    gen = torch.Generator(device=device)
    gen.manual_seed(generator.derive_seed(config["graph_seed"], "kronecker"))
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    ab = a + b
    threshold = torch.tensor([a / ab, c / (1.0 - ab)], dtype=torch.float64,
                             device=device)
    for bit in range(scale):
        r = torch.rand((2, m), generator=gen, device=device,
                       dtype=torch.float64)
        src_bit = r[0] > ab
        dst_bit = r[1] > threshold[src_bit.to(torch.int64)]
        src |= src_bit.to(torch.int64) << bit
        dst |= dst_bit.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=device)
    gen.manual_seed(generator.derive_seed(seed, "order"))
    order = torch.randperm(m, generator=gen, device=device)
    return torch.stack([perm[src[order]], perm[dst[order]]], dim=1)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_the_draw_is_the_one_before_its_frees(seed):
    cfg = dict(CONFIG, scale=10, graph_seed=seed % 1000 + 1)
    got = generator.kronecker_edges(cfg, seed, "cpu")
    want = _draw_before(cfg, seed, "cpu")
    assert got.is_contiguous() and got.dtype == want.dtype
    assert torch.equal(got, want)
