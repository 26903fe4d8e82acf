"""Port parity: local clustering (PPR push, sweep cut, ``local_cluster``).

Inputs: ``kronecker(8, 16, seed=1)`` and the reference tests' planted
community graph (``random_bipartite_community(300, 4, 0.2, 0.004,
seed=3)``), carried to the port through ``repro_torch.convert``; both
packages run on the CPU. Tolerances:

  * identical: ``frontier_cap_for`` / ``resolve_frontier_mode``, push
    iterations, the sparse push's ``idx`` and overflow flag, sweep orders
    and supports, single-vertex Bloom rows, prefix filters and popcounts,
    ``best_size`` and ``members``, exact-sweep conductance;
  * ``rtol=1e-6, atol=1e-7``: ``p`` and ``r`` of both pushes and the power
    iteration (scatter sums: XLA's and torch's float32 additions may round
    differently);
  * Bloom-sweep conductance: each step's intersection estimate is
    ``d_j + j − union`` with ``union`` from ``log1p``, which XLA and torch
    round an ulp apart (ROADMAP difference 2); the cancellation turns that
    into up to 4 ulps of ``d_j + j``, which the cut's cumulative sum
    carries on: a prefix's conductance is held to that sum (and an ulp per
    step of the cumsums, taken in another order) over its denominator,
    plus rtol 1e-6; the best conductance likewise.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import graph as RG
from repro.core import sketches as RS
from repro.core.algorithms import localcluster as RLC
from repro_torch import convert
from repro_torch import engine as TE
from repro_torch.core import bounds as TB
from repro_torch.core import exact as TX
from repro_torch.core import graph as TG
from repro_torch.core.algorithms import localcluster as TLC
from repro_torch.engine import plan as TP
from repro_torch.engine import setexpr as TSX
from repro_torch.launch import mine as TM
from repro_torch.obs import trace as TTR
from repro_torch.obs.metrics import REGISTRY

CPU = "cpu"
ALPHA, EPS = 0.15, 1e-4
SEEDS = np.array([3, 17, 101, 200], np.int32)


def _port_graph(rg):
    return convert.graph_from_numpy(
        np.asarray(rg.indptr), np.asarray(rg.indices), np.asarray(rg.deg),
        np.asarray(rg.edges), rg.n, rg.m, rg.d_max, device=CPU)


def _port_sketch(sk):
    return convert.sketch_from_numpy(np.asarray(sk.data), sk.kind,
                                     sk.num_hashes, sk.k, sk.seed, sk.n,
                                     device=CPU)


@pytest.fixture(scope="module")
def graphs():
    """name -> (reference graph, port graph, reference Bloom sketch, port
    Bloom sketch); the sketches at storage budget 1.0."""
    out = {}
    for name, rg in (("kron", RG.kronecker(8, 16, seed=1)),
                     ("community", RG.random_bipartite_community(
                         300, 4, 0.2, 0.004, seed=3))):
        sk = RS.build(rg, "bf", storage_budget=1.0)
        out[name] = (rg, _port_graph(rg), sk, _port_sketch(sk))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bloom_phi_tol(tg, order, conductance):
    """Per-prefix bound on |Δφ| of the Bloom sweep (module docstring)."""
    order = _np(order).astype(np.int64)
    deg = _np(tg.deg).astype(np.float64)
    valid = order < tg.n
    d_j = np.where(valid, deg[np.minimum(order, tg.n - 1)], 0.0)
    scale = np.where(valid, d_j + np.arange(order.shape[1])[None, :], 0.0)
    ulp = np.spacing(np.maximum(scale, 1.0).astype(np.float32))
    vol = np.cumsum(d_j, 1)
    denom = np.maximum(np.minimum(vol, 2.0 * tg.m - vol), 1.0)
    step = 2 * 4 * ulp + 2 * np.spacing(vol.astype(np.float32))
    phi = np.where(np.isfinite(_np(conductance)), _np(conductance), 0.0)
    return np.cumsum(step, 1) / denom + 1e-6 * np.abs(phi)


def _assert_phi(got, want, tol=None):
    """Equal infinities; finite values equal (``tol`` None) or within
    ``tol`` elementwise."""
    got, want = _np(got), _np(want)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    if tol is None:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    else:
        assert (np.abs(got[fin] - want[fin]) <= np.broadcast_to(
            tol, want.shape)[fin]).all()


# ---------------------------------------------------------------------------
# small functions and the pushes
# ---------------------------------------------------------------------------

def test_frontier_cap_and_mode_identical():
    """The capacity rule and the auto-mode choice are the reference's."""
    from repro import engine as RE
    for alpha, eps in ((0.15, 1e-4), (0.3, 1e-3), (0.05, 1e-6), (0.999, 0.5)):
        for n in (1, 2, 300, 4096, 2 ** 21):
            for cap in (None, 1, 16, 1000):
                assert TLC.frontier_cap_for(alpha, eps, n, cap) == \
                    RLC.frontier_cap_for(alpha, eps, n, cap)
                for mode in ("auto", "dense", "sparse"):
                    rp = RE.EnginePlan(frontier_mode=mode, frontier_cap=cap)
                    tp = TP.EnginePlan(frontier_mode=mode, frontier_cap=cap)
                    assert TLC.resolve_frontier_mode(tp, n, alpha, eps) == \
                        RLC.resolve_frontier_mode(rp, n, alpha, eps)
    with pytest.raises(ValueError):
        TLC.resolve_frontier_mode(TP.EnginePlan(frontier_mode="x"), 9, 0.1,
                                  0.1)


def test_dense_push_and_power_iteration_match_reference(graphs):
    """p and r of the dense push, its rounds, and the power iteration."""
    rg, tg, _, _ = graphs["kron"]
    p, r, it = RLC.ppr_push(rg, SEEDS, ALPHA, EPS)
    tp, tr, tit = TLC.ppr_push(tg, SEEDS, ALPHA, EPS)
    assert tit == int(it) and 0 < tit < 200
    np.testing.assert_allclose(tp.numpy(), np.asarray(p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), rtol=1e-6,
                               atol=1e-7)
    ref = RLC.ppr_power_iteration(rg, SEEDS, ALPHA, iters=60)
    got = TLC.ppr_power_iteration(tg, SEEDS, ALPHA, iters=60)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("cap", [None, 16])
def test_sparse_push_matches_reference(graphs, cap):
    """idx, overflow and rounds identical, p and r close; without a spill
    the table densifies to the dense push's vectors."""
    rg, tg, _, _ = graphs["kron"]
    fr = RLC.ppr_push_sparse(rg, SEEDS, ALPHA, EPS, frontier_cap=cap)
    tfr = TLC.ppr_push_sparse(tg, SEEDS, ALPHA, EPS, frontier_cap=cap)
    assert tfr.idx.dtype == torch.int32 and tfr.cap == fr.cap
    assert np.array_equal(tfr.idx.numpy(), np.asarray(fr.idx))
    assert tfr.overflowed == bool(fr.overflowed) == (cap == 16)
    assert tfr.iterations == int(fr.iterations)
    np.testing.assert_allclose(tfr.p.numpy(), np.asarray(fr.p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tfr.r.numpy(), np.asarray(fr.r), rtol=1e-6,
                               atol=1e-7)
    assert np.array_equal(tfr.sizes(), fr.sizes())
    if cap is None:
        p, r, _ = TLC.ppr_push(tg, SEEDS, ALPHA, EPS)
        dp, dr = tfr.densify()
        np.testing.assert_allclose(dp.numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(dr.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# sweeps and local_cluster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("kind", ["exact", "bf"])
def test_sweeps_match_reference(graphs, kind, form):
    """From the same PPR input: orders and supports identical; exact
    conductance at rtol 1e-6, Bloom conductance within its bound; the
    Bloom prefix filters and popcounts bit-identical."""
    rg, tg, sk, tsk = graphs["kron"]
    rsk, tsk = (sk, tsk) if kind == "bf" else (None, None)
    if form == "dense":
        rin, _, _ = RLC.ppr_push(rg, SEEDS, ALPHA, EPS)
        tin = torch.tensor(np.asarray(rin))
    else:
        rin = RLC.ppr_push_sparse(rg, SEEDS, ALPHA, EPS)
        tin = TLC.SparseFrontier(
            idx=torch.tensor(np.asarray(rin.idx)),
            p=torch.tensor(np.asarray(rin.p)),
            r=torch.tensor(np.asarray(rin.r)),
            iterations=int(rin.iterations), overflowed=False, n=rin.n)
    order, phi, support = RLC.sweep_cut(rg, rin, rsk)
    t_order, t_phi, t_support = TLC.sweep_cut(tg, tin, tsk)
    assert t_order.dtype == torch.int32
    assert np.array_equal(t_order.numpy(), np.asarray(order))
    assert np.array_equal(t_support.numpy(), np.asarray(support))
    if kind == "exact":
        _assert_phi(t_phi, phi)
        return
    _assert_phi(t_phi, phi, _bloom_phi_tol(tg, t_order, phi))
    # the integers behind the estimate
    words = tsk.data.shape[1]
    elem = RLC._vertex_bloom_rows(order, rg.n, words, sk.num_hashes, sk.seed)
    t_elem = TLC._vertex_bloom_rows(t_order, tg.n, words, tsk.num_hashes,
                                    tsk.seed)
    assert np.array_equal(t_elem.numpy().view(np.uint32), np.asarray(elem))
    import jax
    prefix = np.asarray(jax.lax.associative_scan(jnp.bitwise_or, elem,
                                                 axis=1))
    t_prefix = TLC._prefix_or(t_elem)
    assert np.array_equal(t_prefix.numpy().view(np.uint32), prefix)
    nbr = np.asarray(sk.data)[np.minimum(np.asarray(order), rg.n - 1)]
    want = np.unpackbits((nbr[:, 1:] & prefix[:, :-1]).view(np.uint8),
                         axis=-1).sum(-1)
    got = TSX.compile_expr(TSX.and_all(*TSX.rows(2)),
                           use_kernel=False).ones_rows(
        torch.from_numpy(nbr[:, 1:].reshape(-1, words).view(np.int32)),
        t_prefix[:, :-1].reshape(-1, words))
    assert np.array_equal(got.numpy(), want.reshape(-1))


@pytest.mark.parametrize("mode", ["auto", "sparse"])
@pytest.mark.parametrize("kind", ["exact", "bf"])
@pytest.mark.parametrize("graph", ["community", "kron"])
def test_local_cluster_matches_reference(graphs, graph, kind, mode):
    """End to end: best sizes, supports, members and orders identical; the
    best conductance at rtol 1e-5 (exact) or within the Bloom bound."""
    rg, tg, sk, tsk = graphs[graph]
    rsk, tsk = (sk, tsk) if kind == "bf" else (None, None)
    seeds = SEEDS % rg.n
    res = RLC.local_cluster(rg, seeds, ALPHA, EPS, sketch=rsk,
                            frontier_mode=mode)
    got = TLC.local_cluster(tg, seeds, ALPHA, EPS, sketch=tsk,
                            frontier_mode=mode)
    assert (got.frontier is not None) == (res.frontier is not None)
    assert got.iterations == int(res.iterations)
    for field in ("order", "best_size", "support", "best_idx"):
        assert np.array_equal(_np(getattr(got, field)),
                              np.asarray(getattr(res, field))), field
    for s in range(seeds.size):
        assert np.array_equal(got.members(s), res.members(s))
        assert np.array_equal(got.footprint(s), res.footprint(s))
    if kind == "exact":
        np.testing.assert_allclose(got.best_conductance.numpy(),
                                   np.asarray(res.best_conductance),
                                   rtol=1e-5)
        _assert_phi(got.conductance, res.conductance)
    else:
        tol = _bloom_phi_tol(tg, got.order, res.conductance)
        _assert_phi(got.conductance, res.conductance, tol)
        at = got.best_idx.numpy()[:, None]
        _assert_phi(got.best_conductance, res.best_conductance,
                    np.take_along_axis(tol, at, 1)[:, 0])
    if graph == "community" and kind == "exact":
        # the reference test's planted-community recovery
        assert float(got.best_conductance[1]) < 0.15


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["exact", "bf"])
def test_sparse_and_dense_sweeps_bit_identical(graphs, kind):
    """Invariant 10: the two frontier layouts give the same orders and
    supports, and bit-identical conductance profiles where orders agree."""
    _, tg, _, tsk = graphs["kron"]
    tsk = tsk if kind == "bf" else None
    dense = TLC.local_cluster(tg, SEEDS, ALPHA, EPS, sketch=tsk,
                              frontier_mode="dense")
    sparse = TLC.local_cluster(tg, SEEDS, ALPHA, EPS, sketch=tsk,
                               frontier_mode="sparse")
    assert sparse.frontier is not None and dense.frontier is None
    assert torch.equal(dense.support, sparse.support)
    k = min(dense.order.shape[1], sparse.order.shape[1])
    agree = torch.cumprod((dense.order[:, :k] == sparse.order[:, :k]).to(
        torch.int64), 1).bool()
    assert bool(agree[:, :8].all())
    assert torch.equal(dense.conductance[:, :k][agree],
                       sparse.conductance[:, :k][agree])


def test_small_cap_spills_to_dense(graphs):
    """A cap too small for the support spills: the dense push answers,
    ``spilled`` is set and ``ppr.spill`` counts it."""
    _, tg, _, tsk = graphs["kron"]
    before = REGISTRY.counter("ppr.spill").value
    spilled = TLC.local_cluster(tg, SEEDS, ALPHA, EPS, sketch=tsk,
                                frontier_mode="sparse", frontier_cap=4)
    dense = TLC.local_cluster(tg, SEEDS, ALPHA, EPS, sketch=tsk,
                              frontier_mode="dense")
    assert spilled.spilled and spilled.frontier is None
    assert REGISTRY.counter("ppr.spill").value == before + 1
    assert torch.equal(spilled.order, dense.order)
    assert torch.equal(spilled.conductance, dense.conductance)


def test_split_expansion_runs_identical(graphs, monkeypatch):
    """The sparse push and the exact sweep walk CSR rows in runs of whole
    rows (``exact.row_elements``); splitting them into runs of a few slots
    leaves the table, values, rounds and profile bit-identical."""
    _, tg, _, _ = graphs["kron"]
    whole = TLC.local_cluster(tg, SEEDS, ALPHA, EPS, frontier_mode="sparse")
    monkeypatch.setattr(TLC, "row_elements",
                        lambda graph, rows: TX.row_elements(graph, rows, 37))
    split = TLC.local_cluster(tg, SEEDS, ALPHA, EPS, frontier_mode="sparse")
    for a, b in ((whole.frontier.idx, split.frontier.idx),
                 (whole.frontier.p, split.frontier.p),
                 (whole.frontier.r, split.frontier.r),
                 (whole.order, split.order),
                 (whole.conductance, split.conductance)):
        assert torch.equal(a, b)
    assert whole.iterations == split.iterations


def test_sketch_sweep_within_bounds():
    """The Bloom sweep's conductance stays within core.bounds'
    ``sweep_conductance_interval`` (built on ``sweep_cut_rmse``) of the
    exact sweep, as the reference's test holds its own."""
    g = TG.kronecker(8, 8, seed=1, device=CPU)
    sk = TE.session(g, "bf", storage_budget=2.0, device=CPU).sketch
    res_e = TLC.local_cluster(g, SEEDS, ALPHA, EPS)
    res_b = TLC.local_cluster(g, SEEDS, ALPHA, EPS, sketch=sk)
    deg = g.deg.numpy()
    checked = 0
    for s in range(SEEDS.size):
        sup = int(res_e.support[s])
        order = res_e.order[s, :sup].numpy()
        vol = np.cumsum(deg[order])
        denom = np.minimum(vol, 2 * g.m - vol)
        half = TB.sweep_conductance_interval(deg[order], denom,
                                             sk.total_bits, sk.num_hashes,
                                             delta=0.05)
        phi_e = res_e.conductance[s, :sup].numpy()
        phi_b = res_b.conductance[s, :sup].numpy()
        ok = np.isfinite(phi_e) & np.isfinite(phi_b)
        assert (np.abs(phi_e[ok] - phi_b[ok]) <= half[ok]).all()
        checked += int(ok.sum())
    assert checked > 100
    assert (np.diff(TB.sweep_cut_rmse(np.full(64, 8.0), 4096, 2)) >= 0).all()
    assert TB.bloom_words_for_conductance(0.05, 8, 64, 2000) >= \
        TB.bloom_words_for_conductance(0.5, 8, 64, 2000) >= 2


def test_adj_never_read(graphs, monkeypatch):
    """None of these paths builds the padded adjacency: the exact
    functions and session, AA/RA and local_cluster (both layouts, exact
    and Bloom) run with ``Graph.adj`` raising."""
    tg = TG.kronecker(7, 16, seed=1, device=CPU)
    tsk = TE.session(tg, "bf", device=CPU).sketch

    def forbidden(self):
        raise AssertionError("Graph.adj was read")
    monkeypatch.setattr(TG.Graph, "adj", property(forbidden))
    pairs = tg.edges[:50]
    for sess in (TE.session(tg, None, device=CPU),
                 TE.session(tg, tsk, device=CPU)):
        float(sess.triangle_count())
        sess.local_clustering()
        sess.jarvis_patrick("jaccard", 0.1)
        for measure in ("adamic_adar", "resource_alloc"):
            sess.similarity(pairs, measure)
        for mode in ("dense", "sparse"):
            sess.local_cluster(SEEDS % tg.n, ALPHA, EPS, frontier_mode=mode)
    TX.exact_triangle_count(tg)
    TX.exact_pair_cardinalities(tg, pairs)
    TX.exact_pair_intersection_elements(tg, pairs)


def test_session_local_cluster_spans_and_metrics(graphs):
    """engine.local_cluster carries sparse=/spilled=, the sparse push
    records ppr.push and observes ppr.frontier_size."""
    _, tg, _, tsk = graphs["kron"]
    sess = TE.session(tg, tsk, device=CPU)
    hist = REGISTRY.histogram("ppr.frontier_size")
    seen = hist.values().size
    TTR.enable()
    TTR.clear()
    try:
        res = sess.local_cluster(SEEDS, ALPHA, EPS, frontier_mode="sparse")
        events = {e["name"]: e for e in TTR.events()}
    finally:
        TTR.disable()
        TTR.clear()
    assert res.frontier is not None and not res.spilled
    span = events["engine.local_cluster"]
    assert span["args"]["sparse"] is True and span["args"]["spilled"] is False
    assert events["ppr.push"]["args"]["mode"] == "sparse"
    assert hist.values().size == seen + 1
    assert hist.values()[-1] == int(res.frontier.sizes().max())


def test_mine_localcluster_exact_cpu(capsys):
    """``--algos tc,localcluster --exact --device cpu`` runs the plain
    path and reports the exact TC and the relative error."""
    TM.main(["--scale", "8", "--algos", "tc,localcluster", "--exact",
             "--device", CPU])
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("TC_exact=") for line in lines)
    rec = json.loads(lines[-1])
    assert rec["event"] == "mine_session"
    assert set(rec["algos"]) == {"tc", "localcluster"}
    phi = rec["algos"]["localcluster"]["value"]
    assert 0.0 <= phi <= 1.0
    g = TG.kronecker(8, 16, seed=1, device=CPU)
    assert rec["exact"]["value"] == int(TX.exact_triangle_count(g))
    assert rec["exact"]["rel_err"] == pytest.approx(
        abs(rec["algos"]["tc"]["value"] - rec["exact"]["value"])
        / rec["exact"]["value"])
