"""Port parity, the clique slice: 4- and 5-clique counts through the engine.

The same Kronecker graphs (scales 8–10) and the same sketches go through
the JAX package (its plain path, ``use_kernel=False``) and the port on the
CPU (its plain PyTorch path). Tolerances:

  * identical: Bloom membership, wedge-grid popcounts, exact counts;
  * ``rtol=1e-6``: clique estimates — each tuple's value is the
    reference's, but the reference sums float32 per edge chunk in its own
    order and the port sums in float64;
  * ``rtol=1e-7`` between two piece sizes of the port (the same float64
    sums in another grouping, rounded once to float32).
"""
import itertools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import engine as RE
from repro.core import graph as RG, sketches as RS
from repro.core.algorithms import cliques as RC
from repro.launch import mine as RM
from repro_torch import engine as TE
from repro_torch.convert import sketch_from_numpy
from repro_torch.core import graph as TG, sketches as TS
from repro_torch.core.algorithms import cliques as TC
from repro_torch.launch import mine as TM
from repro_torch.obs.metrics import REGISTRY

CPU = "cpu"


def _brute_five_cliques(g) -> int:
    """Literal itertools enumeration of 5-cliques (the reference test's)."""
    nbrs = {}
    for a, b in np.asarray(g.edges):
        nbrs.setdefault(int(a), set()).add(int(b))
        nbrs.setdefault(int(b), set()).add(int(a))
    return sum(all(q in nbrs[p] for p, q in itertools.combinations(c, 2))
               for c in itertools.combinations(sorted(nbrs), 5))


_GRAPHS = {}


def _graphs(scale: int):
    """(reference graph, port graph) of kronecker(scale, 16, seed=1)."""
    if scale not in _GRAPHS:
        _GRAPHS[scale] = (RG.kronecker(scale, 16, seed=1),
                          TG.kronecker(scale, 16, seed=1, device=CPU))
    return _GRAPHS[scale]


def _sketches(scale: int, kind):
    """The reference's sketch and the same words in the port."""
    rg, _ = _graphs(scale)
    if kind is None:
        return None, None
    rs = RS.build(rg, kind, 0.5, num_hashes=2, seed=1)
    ts = sketch_from_numpy(np.asarray(rs.data), kind, rs.num_hashes, rs.k,
                           rs.seed, rs.n, device=CPU)
    return rs, ts


@pytest.mark.parametrize("scale", [8, 10])
def test_bloom_membership_identical(scale):
    """The port's bloom_membership is bit-identical, pads included."""
    rg, _ = _graphs(scale)
    rs, ts = _sketches(scale, "bf")
    rng = np.random.default_rng(scale)
    rows = rng.integers(0, rg.n, size=40)
    cand = rng.integers(0, rg.n + 5, size=(40, 300)).astype(np.int32)
    cand[:, :50] = np.asarray(rg.adj)[rows, :50]       # some true members
    want = np.asarray(jax.vmap(lambda r, c: RS.bloom_membership(
        r, c, rg.n, 2, rs.total_bits, 1))(rs.data[rows], jnp.asarray(cand)))
    got = np.stack([TS.bloom_membership(
        ts.data[int(r)], torch.from_numpy(c), rg.n, 2, ts.total_bits, 1
    ).numpy() for r, c in zip(rows, cand)])
    assert want.any() and not want.all()
    assert np.array_equal(got, want)
    # the per-vertex form the clique passes use agrees on real vertices
    real = cand[0] < rg.n
    pos = TS.bloom_positions(torch.from_numpy(cand[0][real]), 2,
                             ts.total_bits, 1)
    rows0 = torch.full((int(real.sum()),), int(rows[0]))
    assert np.array_equal(TS.bloom_test(ts.data, rows0, pos).numpy(),
                          want[0][real])


@pytest.mark.parametrize("scale", [8, 9])
def test_wedge_grids_identical(scale):
    """wedge_triple_ones / wedge_quad_ones on the reference's own grids
    (padded adjacency rows) give identical popcounts."""
    rg, tg = _graphs(scale)
    rs, ts = _sketches(scale, "bf")
    e = np.asarray(rg.edges)[:: max(1, rg.m // 64)][:64]
    u, v = e[:, 0], e[:, 1]
    adj = np.asarray(rg.adj)
    w = np.where(adj[v] < rg.n, adj[v], 0)[:, :24].astype(np.int32)
    x = np.where(adj[u] < rg.n, adj[u], 0)[:, :16].astype(np.int32)
    plan_r = RE.EnginePlan(use_kernel=False)
    plan_t = TE.EnginePlan(use_kernel=False)
    tu, tv, tw, tx = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in (u, v, w, x))
    got3 = TE.wedge_triple_ones(ts, tu, tv, tw, plan_t)
    want3 = RE.wedge_triple_ones(rs, jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(w), plan_r)
    assert got3.dtype == torch.int32 and got3.shape == (len(u), 24)
    assert np.array_equal(got3.numpy(), np.asarray(want3))
    got4 = TE.wedge_quad_ones(ts, tu, tv, tw, tx, plan_t)
    want4 = RE.wedge_quad_ones(rs, jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(w), jnp.asarray(x), plan_r)
    assert got4.shape == (len(u), 24, 16)
    assert np.array_equal(got4.numpy(), np.asarray(want4))
    # the flattened tuples give the same popcounts as the grid
    flat = torch.stack([tu[:, None].expand(-1, 24).reshape(-1),
                        tv[:, None].expand(-1, 24).reshape(-1),
                        tw.reshape(-1)], dim=1)
    assert torch.equal(TE.tuple_cardinality_ones(ts, flat, plan_t),
                       got3.reshape(-1))


_CASES4 = [(8, "bf"), (9, "bf"), (10, "bf"), (8, "kh"), (9, "kh"),
           (10, "kh"), (8, None), (9, None)]


@pytest.mark.parametrize("scale,kind", _CASES4)
def test_four_clique_count_matches_reference(scale, kind):
    """bf and kh estimates at rtol 1e-6, exact counts identical and equal
    to the brute-force oracle."""
    rg, tg = _graphs(scale)
    rs, ts = _sketches(scale, kind)
    want = float(RC.four_clique_count(rg, rs))
    got = TC.four_clique_count(tg, ts)
    assert got.dtype == torch.float32 and got.dim() == 0
    if kind is None:
        assert float(got) == want == float(
            TG.four_clique_count_bruteforce(tg))
    else:
        assert float(got) == pytest.approx(want, rel=1e-6)


def test_four_clique_exact_closing_test_and_bruteforce():
    """exact_closing_test on a bf sketch matches the reference; the port's
    brute-force oracle equals the reference's."""
    rg, tg = _graphs(8)
    rs, ts = _sketches(8, "bf")
    want = float(RC.four_clique_count(rg, rs, exact_closing_test=True))
    got = float(TC.four_clique_count(tg, ts, exact_closing_test=True))
    assert got == pytest.approx(want, rel=1e-6)
    assert TG.four_clique_count_bruteforce(tg) == \
        RG.four_clique_count_bruteforce(rg)


@pytest.mark.parametrize("scale,kind", [(8, "bf"), (9, "bf"), (8, None)])
def test_five_clique_count_matches_reference(scale, kind):
    """Bloom 5-clique estimates at rtol 1e-6; exact counts identical."""
    rg, tg = _graphs(scale)
    rs, ts = _sketches(scale, kind)
    want = float(RC.five_clique_count(rg, rs))
    got = float(TC.five_clique_count(tg, ts))
    if kind is None:
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("make", [
    lambda dev: TG.erdos_renyi(18, 0.5, seed=3, device=dev),
    lambda dev: TG.erdos_renyi(25, 0.4, seed=11, device=dev),
    lambda dev: TG.kronecker(5, 6, seed=2, device=dev),
])
def test_five_clique_exact_matches_bruteforce(make, monkeypatch):
    """The exact 5-clique count equals literal enumeration, at any piece
    size."""
    g = make(CPU)
    want = float(_brute_five_cliques(g))
    assert float(TC.five_clique_count(g)) == want
    monkeypatch.setattr(TC, "_CHUNK_CANDIDATES", 7)
    assert float(TC.five_clique_count(g)) == want


@pytest.mark.parametrize("kind", ["bf", "kh", None])
def test_piece_size_does_not_change_counts(kind, monkeypatch):
    """Small enumeration pieces (many pieces, several launches of tuples)
    give the same counts, within one float32 rounding."""
    _, tg = _graphs(9)
    _, ts = _sketches(9, kind)
    base = float(TC.four_clique_count(tg, ts))
    base5 = float(TC.five_clique_count(tg, ts)) if kind != "kh" else None
    monkeypatch.setattr(TC, "_CHUNK_CANDIDATES", 1000)
    small = float(TC.four_clique_count(tg, ts))
    assert small == pytest.approx(base, rel=1e-7)
    if kind != "kh":
        monkeypatch.setattr(TC, "_CHUNK_CANDIDATES", 500)
        assert float(TC.five_clique_count(tg, ts)) \
            == pytest.approx(base5, rel=1e-7)


def test_gauges_and_enumeration_match_numpy(monkeypatch):
    """The candidate and survivor counters, and the enumerated triangles
    and 4-cliques, equal a numpy enumeration from the CSR."""
    _, tg = _graphs(8)
    _, ts = _sketches(8, "bf")
    indptr, indices = tg.indptr.numpy(), tg.indices.numpy()
    nbrs = [set(indices[indptr[x]:indptr[x + 1]].tolist())
            for x in range(tg.n)]
    e = tg.edges.numpy()
    up = [sorted(w for w in nbrs[x] if w > x) for x in range(tg.n)]
    wedges = sum(len(up[v]) for _, v in e)
    tri = sorted((u, v, w) for u, v in e for w in up[v] if w in nbrs[u])
    quads = sorted((u, v, w, x) for u, v, w in tri for x in up[w]
                   if x in nbrs[u] and x in nbrs[v])
    TC.five_clique_count(tg)
    g = REGISTRY.gauge
    assert g("clique_wedge_candidates").value == wedges
    assert g("clique_triangles").value == len(tri)
    assert g("clique_quads").value == len(quads)
    with monkeypatch.context() as m:
        m.setattr(TC, "_CHUNK_CANDIDATES", 99)
        got_tri = torch.cat(list(TC.closed_triangles(tg)))
        assert sorted(map(tuple, got_tri.tolist())) == tri
        got_q = torch.cat(list(TC.closed_quads(tg)))
        assert sorted(map(tuple, got_q.tolist())) == quads
    # Bloom closing keeps every true triangle (no false negatives)
    bloom_tri = set(map(tuple, torch.cat(list(
        TC.closed_triangles(tg, ts))).tolist()))
    assert set(tri) <= bloom_tri
    sub = tg.edges[:50]
    assert torch.equal(torch.cat(list(TC.closed_triangles(tg, edges=sub))),
                       torch.tensor([t for t in tri if (t[0], t[1]) in
                                     set(map(tuple, sub.tolist()))]))


def test_unsupported_kinds_raise():
    _, tg = _graphs(8)
    for kind in ("1h", "kmv"):
        sk = TS.build(tg, kind, 0.5, seed=1)
        with pytest.raises(ValueError, match="sketch kind"):
            TC.four_clique_count(tg, sk)
    with pytest.raises(ValueError, match="sketch kind"):
        TC.five_clique_count(tg, TS.build(tg, "kh", 0.5, seed=1))


def test_session_clique_methods():
    """The session's clique counts reuse its sketch and match the
    reference session's; an exact session counts exactly."""
    rg, tg = _graphs(8)
    rsess = RE.session(rg, "bf", storage_budget=0.25, use_kernel=False)
    tsess = TE.session(tg, "bf", storage_budget=0.25, device=CPU)
    sketch = tsess.sketch
    assert float(tsess.four_clique_count()) == pytest.approx(
        float(rsess.four_clique_count()), rel=1e-6)
    assert float(tsess.five_clique_count()) == pytest.approx(
        float(rsess.five_clique_count()), rel=1e-6)
    assert tsess.sketch is sketch
    g = TG.erdos_renyi(18, 0.5, seed=3, device=CPU)
    assert float(TE.session(g, None, device=CPU).five_clique_count()) == \
        float(_brute_five_cliques(g))


def test_mine_cli_cliques(capsys):
    """``mine --algos 4clique,cliques5 --device cpu`` reports the
    reference session's values."""
    TM.main(["--scale", "8", "--algos", "4clique,cliques5", "--device",
             "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["algos"]) == {"4clique", "cliques5"}
    want = RM.mine_session(RG.kronecker(8, 16, seed=1),
                           ["4clique", "cliques5"])
    for name in ("4clique", "cliques5"):
        assert out["algos"][name]["value"] == pytest.approx(
            want[name][0], rel=1e-6)
