"""Port parity: the exact baseline (``core/exact.py``), the exact session
and Adamic–Adar / Resource-Allocation.

``kronecker(10, 16, seed=1)`` goes through the JAX reference and the port
(``device="cpu"``, the plain PyTorch path) on the same arrays. Tolerances:

  * identical: ``exact_pair_cardinalities`` (hub pairs included),
    ``exact_pair_intersection_elements``, ``exact_triangle_count`` (also
    equal to trace(A³)/6), the exact session's per-edge counts and TC,
    Jarvis–Patrick labels;
  * ``rtol=1e-6``: LCC and the cardinality similarities of the exact
    session (float32 arithmetic on identical counts);
  * Adamic–Adar / Resource-Allocation on exact and Bloom sessions: the
    port sums the float32 weights (each within an ulp of the reference's
    ``log``) in float64; the reference sums them in float32, in an order
    XLA picks (it varied between runs of this test), so each pair is held
    to rtol 1e-6 plus that sum's error bound, (d_u − 1)·2⁻²⁴, with d_u the
    number of terms the reference adds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import engine as RE
from repro.core import exact as RX
from repro.core import graph as RG
from repro.core.algorithms import similarity as RSIM
from repro_torch import convert
from repro_torch import engine as TE
from repro_torch.core import exact as TX
from repro_torch.core import graph as TG
from repro_torch.core.algorithms import similarity as TSIM

CPU = "cpu"
MEASURES = ("jaccard", "overlap", "common", "total")


@pytest.fixture(scope="module")
def graphs():
    rg = RG.kronecker(10, 16, seed=1)
    tg = TG.kronecker(10, 16, seed=1, device=CPU)
    return rg, tg


@pytest.fixture(scope="module")
def trace_tc(graphs):
    """trace(A³)/6 of the test graph (float64 products, exact here)."""
    rg, _ = graphs
    a = np.zeros((rg.n, rg.n))
    e = np.asarray(rg.edges)
    a[e[:, 0], e[:, 1]] = a[e[:, 1], e[:, 0]] = 1.0
    return int(round(np.trace(a @ a @ a))) // 6


@pytest.fixture(scope="module")
def pairs(graphs):
    """Canonical edges, random pairs, and pairs among and from the four
    vertices of highest degree (hubs), int32[P, 2]."""
    rg, tg = graphs
    rng = np.random.default_rng(0)
    edges = np.asarray(rg.edges)
    hubs = np.argsort(-np.asarray(rg.deg), kind="stable")[:4]
    hub_pairs = np.array([[a, b] for a in hubs for b in hubs if a != b]
                         + [[h, int(x)] for h in hubs
                            for x in rng.integers(0, rg.n, 8)])
    out = np.concatenate([edges[rng.choice(edges.shape[0], 400,
                                           replace=False)],
                          rng.integers(0, rg.n, (300, 2)), hub_pairs,
                          [[0, 0], [hubs[0], hubs[0]]]])
    return out.astype(np.int32)


@pytest.fixture(scope="module")
def sessions(graphs):
    """Exact and Bloom sessions on both sides (the Bloom sketch carried
    from the reference's words)."""
    rg, tg = graphs
    rs = RE.session(rg, None)
    rb = RE.session(rg, "bf", storage_budget=1.0)
    sk = rb.sketch
    tb_sketch = convert.sketch_from_numpy(np.asarray(sk.data), "bf",
                                          sk.num_hashes, sk.k, sk.seed, sk.n,
                                          device=CPU)
    return {"exact": (rs, TE.session(tg, None, device=CPU)),
            "bf": (rb, TE.session(tg, tb_sketch, device=CPU))}


def test_exact_pair_cardinalities_identical(graphs, pairs):
    """Counts over the CSR equal the reference's galloping over adj rows,
    hub pairs included, with small pieces too."""
    rg, tg = graphs
    want = np.asarray(RX.exact_pair_cardinalities(rg, jnp.asarray(pairs)))
    got = TX.exact_pair_cardinalities(tg, torch.from_numpy(pairs))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    small = TX.common_count(tg, torch.from_numpy(pairs),
                            TX.key_member(tg), cap=17)
    assert np.array_equal(small.numpy(), want)


def test_exact_pair_intersection_elements_identical(graphs, pairs):
    """The [P, d_max] element layout (non-members = n) is the reference's."""
    rg, tg = graphs
    want = np.asarray(RX.exact_pair_intersection_elements(
        rg, jnp.asarray(pairs)))
    got = TX.exact_pair_intersection_elements(tg, torch.from_numpy(pairs))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_pieces_split_whole_items_under_cap():
    """``pieces`` expands every slot once, in order, in runs of whole items
    of at most cap + max(counts) slots; empty items and a cap below one
    item's count are handled."""
    counts = torch.tensor([3, 0, 7, 1, 0, 12, 2, 5], dtype=torch.int64)
    for cap in (1, 4, 10, 1000):
        runs = list(TX.pieces(counts, cap))
        assert runs[0][0] == 0 and runs[-1][1] == counts.numel()
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        assert all(item.numel() <= cap + int(counts.max())
                   for _, _, item, _ in runs)
        item = torch.cat([r[2] for r in runs])
        rank = torch.cat([r[3] for r in runs])
        want = torch.repeat_interleave(torch.arange(counts.numel()), counts)
        assert torch.equal(item, want)
        assert torch.equal(rank, torch.cat([torch.arange(c) for c in counts]))
    assert list(TX.pieces(torch.zeros(3, dtype=torch.int64), 4)) == []
    assert list(TX.pieces(torch.zeros(0, dtype=torch.int64), 4)) == []


@pytest.mark.parametrize("edge_chunk", [65536, 1000])
def test_exact_triangle_count_identical(graphs, trace_tc, edge_chunk):
    """exact_triangle_count is the reference's integer and trace(A³)/6."""
    rg, tg = graphs
    got = TX.exact_triangle_count(tg, edge_chunk=edge_chunk)
    assert got.dtype == torch.int64
    assert int(got) == int(RX.exact_triangle_count(rg))
    assert int(got) == trace_tc


def test_exact_session_identical(graphs, sessions, trace_tc):
    """session(g, None): per-edge counts, TC and JP labels identical; LCC
    and the cardinality similarities at rtol 1e-6."""
    rg, tg = graphs
    rs, ts = sessions["exact"]
    assert ts.stats() == rs.stats() and ts.stats()["sketch"] == "exact"
    cards = ts.edge_cardinalities()
    assert cards.dtype == torch.float32
    assert np.array_equal(cards.numpy(), np.asarray(rs.edge_cardinalities()))
    tc = float(ts.triangle_count())
    assert tc == float(rs.triangle_count()) == trace_tc
    np.testing.assert_allclose(ts.local_clustering().numpy(),
                               np.asarray(rs.local_clustering()), rtol=1e-6)
    labels, num = ts.jarvis_patrick("common", 2.0)
    rlabels, rnum = rs.jarvis_patrick("common", 2.0)
    assert int(num) == int(rnum)
    assert np.array_equal(labels.numpy(), np.asarray(rlabels))
    for m in MEASURES:
        np.testing.assert_allclose(ts.edge_similarity(m).numpy(),
                                   np.asarray(rs.edge_similarity(m)),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["exact", "bf"])
@pytest.mark.parametrize("measure", ["adamic_adar", "resource_alloc"])
def test_adamic_adar_resource_alloc_match_reference(sessions, pairs, kind,
                                                    measure):
    """AA/RA over CSR elements (exact lookup or Bloom membership in B_v)
    match the reference within its float32 summation bound (module
    docstring), through the session and pair_similarity."""
    rs, ts = sessions[kind]
    want = np.asarray(rs.similarity(jnp.asarray(pairs), measure))
    got = ts.similarity(torch.from_numpy(pairs), measure)
    assert got.dtype == torch.float32
    terms = ts.graph.deg[torch.from_numpy(pairs[:, 0]).long()].numpy()
    rtol = 1e-6 + np.maximum(terms - 1, 0) * 2.0 ** -24
    assert (np.abs(got.numpy() - want) <= rtol * np.abs(want)).all()
    assert (got.numpy() > 0).any()
    direct = TSIM.pair_similarity(ts.graph, torch.from_numpy(pairs), measure,
                                  ts.sketch)
    assert torch.equal(direct, got)


def test_similarity_kinds_and_measures_raise(graphs):
    """AA/RA need an exact or Bloom session, as in the reference; unknown
    measures raise ValueError."""
    rg, tg = graphs
    pairs = np.array([[0, 1]], np.int32)
    rk = RE.session(rg, "kh", storage_budget=1.0)
    tk = TE.session(tg, "kh", storage_budget=1.0, device=CPU)
    for measure in ("adamic_adar", "resource_alloc"):
        with pytest.raises(ValueError):
            RSIM.pair_similarity(rg, jnp.asarray(pairs), measure, rk.sketch)
        with pytest.raises(ValueError, match="exact or BF"):
            tk.similarity(torch.from_numpy(pairs), measure)
    with pytest.raises(ValueError):
        TE.session(tg, None, device=CPU).similarity(
            torch.from_numpy(pairs), "bogus")

