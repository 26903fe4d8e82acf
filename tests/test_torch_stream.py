"""Port parity: the streaming graph store and sketch maintenance.

The same seeded deltas go through ``repro.stream`` (the JAX reference, on
the CPU) and ``repro_torch.stream`` (``device="cpu"``, the plain PyTorch
path), on ``kronecker(8, 6, seed=4)`` and small Erdős–Rényi graphs. All
comparisons are exact:

  * host views: canonical edge keys, degrees and every vertex's neighbors;
  * the port's device view (deg, edges, CSR, d_max) equals its host view
    and ``from_edge_array`` on the same edge set;
  * sketch rows are bit-identical to the reference's (Bloom words compared
    as uint32) and to a fresh build, for bf, kh, 1h and kmv, under the
    strict policy and under a lax one whose deferred deletions a flush
    repairs;
  * ``apply_delta``'s counters and the maintainer's stats equal the
    reference's; only ``bytes_uploaded`` differs, because the layouts do
    (the port uploads no adjacency rows).

Traffic: a no-op delta uploads 0 bytes; one delta's bytes do not grow with
the graph and stay below ``bytes_init / 8`` (after
``tests/test_stream_equivalence.py``). A replay with ``Graph.adj`` raising
shows that nothing on the streaming path builds the padded adjacency.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.stream import ErrorBudgetPolicy as RPolicy
from repro.stream import stream_session as r_stream_session
from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.stream import (DynamicGraph, ErrorBudgetPolicy,
                                SketchMaintainer, StreamSession,
                                stream_session)

CPU = "cpu"
KINDS = ("bf", "kh", "1h", "kmv")
KW = dict(words=4, k=6, num_hashes=2, seed=3)


def _same_rows(ref, port) -> bool:
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    return ref.dtype == got.dtype and np.array_equal(ref, got)


def _random_delta(rng, n, edges, n_ins, n_del):
    ins = rng.integers(0, n, size=(n_ins, 2))
    dels = (edges[rng.choice(edges.shape[0], size=min(n_del, edges.shape[0]),
                             replace=False)] if edges.shape[0] else None)
    return ins, dels


def assert_device_view(dyn: DynamicGraph):
    """The device mirror equals the host source of truth and a static
    graph built from scratch on the same edge set."""
    view = dyn.view()
    ref = TG.from_edge_array(dyn.n, dyn.edge_array(), device=CPU)
    for name in ("indptr", "indices", "deg", "edges"):
        assert torch.equal(getattr(view, name), getattr(ref, name)), name
    assert (view.n, view.m, view.d_max) == (ref.n, ref.m, ref.d_max)
    assert np.array_equal(view.deg.numpy(), dyn.deg)
    tail = dyn.device.edges[dyn.m:]
    assert bool((tail == dyn.n).all()), "edge buffer tail lost its sentinel"
    snap = dyn.snapshot()
    for name in ("indptr", "indices", "deg", "edges"):
        assert torch.equal(getattr(snap, name), getattr(ref, name)), name


def assert_host_views_equal(r_dyn, t_dyn):
    assert np.array_equal(r_dyn.edge_keys, t_dyn.edge_keys)
    assert np.array_equal(r_dyn.deg, t_dyn.deg)
    for v in range(t_dyn.n):
        assert np.array_equal(np.asarray(r_dyn.neighbors(v)),
                              t_dyn.neighbors(v)), v


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tolerance", [0.0, 50.0])
def test_deltas_match_reference(kind, tolerance):
    """Inserts, deletions (strict: rebuilt at once; lax: deferred, then
    flushed), a hub blast and a no-op: host views, device view, sketch rows
    and counters equal the reference's after every step."""
    rg = RG.kronecker(8, 6, seed=4)
    tg = TG.kronecker(8, 6, seed=4, device=CPU)
    r = r_stream_session(rg, kind, policy=RPolicy(tolerance), **KW)
    t = stream_session(tg, kind, policy=ErrorBudgetPolicy(tolerance), **KW)
    assert _same_rows(r.sketch.data, t.sketch.data)
    _ = r.session.edge_cardinalities()
    _ = t.session.edge_cardinalities()
    rng = np.random.default_rng(1)
    steps = [_random_delta(rng, rg.n, r.dyn.edge_array(), 30, 10)
             for _ in range(2)]
    steps.append((np.stack([np.full(40, 5), np.arange(100, 140)], axis=1),
                  None))                              # hub blast
    steps.append((np.zeros((0, 2)), None))            # no-op
    for i, (ins, dels) in enumerate(steps):
        if i == 1:
            dels = _random_delta(rng, rg.n, r.dyn.edge_array(), 0, 12)[1]
        ri = r.apply_delta(ins, dels)
        ti = t.apply_delta(ins, dels)
        assert {k: v for k, v in ri.items() if k != "bytes_uploaded"} == \
            {k: v for k, v in ti.items() if k != "bytes_uploaded"}, i
        assert_host_views_equal(r.dyn, t.dyn)
        assert_device_view(t.dyn)
        assert _same_rows(r.sketch.data, t.sketch.data), (kind, i)
        assert r.maintainer.stats() == t.maintainer.stats()
    if tolerance:
        assert t.maintainer.stats()["rows_dirty"] > 0
    assert r.flush() == t.flush()
    assert _same_rows(r.sketch.data, t.sketch.data)
    assert t.maintainer.stats()["rows_dirty"] == 0
    fresh = TS.build(TG.from_edge_array(t.dyn.n, t.dyn.edge_array(),
                                        device=CPU), kind, **KW)
    assert torch.equal(t.sketch.data, fresh.data)
    rs, ts = r.stats(), t.stats()
    assert rs.keys() == ts.keys() and rs["traffic"].keys() == \
        ts["traffic"].keys()
    for key in ("version", "n", "m", "cards_recomputed", "cards_carried",
                "maintenance"):
        assert rs[key] == ts[key], key
    assert rs["traffic"]["steps"] == ts["traffic"]["steps"]


def test_delta_canonicalization_and_insert_rows():
    """Duplicates, reversed pairs, self loops and present edges collapse as
    in the reference; the inserts come back as a CSR of the delta."""
    dyn = DynamicGraph.from_edges(10, [[0, 1], [1, 2]], device=CPU)
    d = dyn.apply_delta([[2, 1], [3, 3], [4, 5], [5, 4], [4, 5], [0, 9],
                         [9, 4]], [[9, 8]])
    np.testing.assert_array_equal(d.inserted, [[0, 9], [4, 5], [4, 9]])
    assert d.deleted.shape[0] == 0 and dyn.m == 5
    verts, indptr, nbrs = d.insert_rows(dyn.n)
    np.testing.assert_array_equal(verts, [0, 4, 5, 9])
    np.testing.assert_array_equal(indptr, [0, 1, 3, 4, 6])
    np.testing.assert_array_equal(nbrs, [9, 5, 9, 4, 0, 4])
    d = dyn.apply_delta(None, [[1, 0], [0, 1]])
    np.testing.assert_array_equal(d.deleted, [[0, 1]])
    assert dyn.m == 4 and np.array_equal(d.dirty, [0, 1])
    np.testing.assert_array_equal(dyn.neighbors(9), [0, 4])
    assert_device_view(dyn)


def test_empty_graph_n0():
    dyn = DynamicGraph.from_edges(0, None, device=CPU)
    d = dyn.apply_delta([[0, 1]], None)
    assert d.is_noop and dyn.m == 0
    assert dyn.snapshot().n == 0


def test_published_host_arrays_are_never_written():
    """A snapshot holds one host generation by reference: later deltas
    rebind new arrays (the published ones are read-only), so its reads stay
    at its version without copies."""
    dyn = DynamicGraph.from_edges(20, [[0, 1], [0, 2], [3, 4]], device=CPU)
    snap = dyn.host_snapshot()
    before = snap.neighbors(0).copy()
    keys = dyn.edge_keys
    dyn.apply_delta([[0, 5], [0, 6]], [[0, 1]])
    assert not keys.flags.writeable and not dyn.deg.flags.writeable
    np.testing.assert_array_equal(snap.neighbors(0), before)
    np.testing.assert_array_equal(dyn.neighbors(0), [2, 5, 6])
    assert snap.m == 3 and dyn.m == 4 and snap.edge_keys is keys


@pytest.mark.parametrize("kind", KINDS)
def test_maintainer_without_session_builds_from_the_csr(kind):
    """A bare maintainer creates the device mirror (its one init upload)
    and builds rows equal to the static builder's."""
    g = TG.erdos_renyi(70, 0.1, seed=5, device=CPU)
    dyn = DynamicGraph.from_graph(g)
    mt = SketchMaintainer(dyn, kind, **KW)
    assert dyn.traffic.bytes_init > 0
    assert torch.equal(mt.sketch.data, TS.build(g, kind, **KW).data)
    mt.rebuild_rows(np.array([3, 9, 40]))
    assert torch.equal(mt.sketch.data, TS.build(g, kind, **KW).data)


def test_noop_delta_uploads_zero_bytes():
    s = stream_session(TG.erdos_renyi(60, 0.08, seed=1, device=CPU), "bf",
                       **KW)
    _ = s.session.edge_cardinalities()
    info = s.apply_delta(np.zeros((0, 2)), None)
    assert info["bytes_uploaded"] == 0
    assert s.stats()["traffic"]["bytes_last_delta"] == 0


def test_bytes_per_delta_scale_with_delta_not_graph():
    """The same small delta uploads about the same bytes whatever the
    graph's size, far below the one-time residency upload."""
    per_graph = {}
    for n in (500, 2000):
        g = TG.erdos_renyi(n, 8.0 / n, seed=4, device=CPU)
        s = stream_session(g, "bf", **KW)
        _ = s.session.edge_cardinalities()
        rng = np.random.default_rng(7)
        total = 0
        for _ in range(3):
            ins = rng.integers(0, n, size=(8, 2))
            cur = s.dyn.edge_array()
            dels = cur[rng.choice(cur.shape[0], size=4, replace=False)]
            info = s.apply_delta(ins, dels)
            assert info["bytes_uploaded"] > 0
            assert info["bytes_uploaded"] < s.dyn.traffic.bytes_init / 8
            total += info["bytes_uploaded"]
        per_graph[n] = total / 3
    assert per_graph[2000] < 3 * per_graph[500], per_graph


def test_stats_report_traffic_fields():
    s = stream_session(TG.erdos_renyi(40, 0.1, seed=0, device=CPU), "kmv",
                       **KW)
    s.apply_delta([[0, 1], [2, 3]])
    tr = s.stats()["traffic"]
    for key in ("bytes_init", "bytes_total", "bytes_last_delta",
                "bytes_per_delta_mean", "steps"):
        assert key in tr
    assert tr["bytes_init"] > 0 and tr["bytes_total"] > 0


def test_adj_never_built_during_a_replay(monkeypatch):
    """A whole replay (every kind, the exact session, flushes, the server's
    query kinds) runs with ``Graph.adj`` raising."""
    from repro_torch.stream import BatchedQueryServer

    def forbidden(self):
        raise AssertionError("Graph.adj was read")
    monkeypatch.setattr(TG.Graph, "adj", property(forbidden))
    g = TG.kronecker(8, 6, seed=2, device=CPU)
    edges = g.edges.numpy().astype(np.int64)
    for kind in KINDS + (None,):
        s = StreamSession(DynamicGraph.from_edges(g.n, edges[:800],
                                                  device=CPU),
                          kind, policy=ErrorBudgetPolicy(1.0),
                          **(KW if kind else {}))
        srv = BatchedQueryServer(s, min_batch=8)
        rng = np.random.default_rng(0)
        for b, chunk in enumerate(np.array_split(edges[800:], 3)):
            cur = s.dyn.edge_array()
            s.apply_delta(chunk, cur[rng.choice(cur.shape[0], 6,
                                                replace=False)])
            srv.submit_similarity(rng.integers(0, g.n, (8, 2)))
            srv.submit_membership(3, np.arange(8))
            srv.submit_link_prediction(5, top_k=3)
            srv.submit_local_cluster(7, eps=1e-2)
            srv.submit_triangle_count()
            assert len(srv.flush()) == 5
        s.flush()
        s.local_clustering()
        srv.close()


def test_entry_points_default_to_cuda(monkeypatch):
    """DynamicGraph and the launcher use the CUDA device unless told
    otherwise, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DynamicGraph.from_edges(4, [[0, 1]])
    g = TG.erdos_renyi(30, 0.2, seed=1, device=CPU)
    assert stream_session(g, "bf", **KW).dyn.torch_device.type == "cpu"


def test_refresh_recomputes_only_the_invalidated_edges():
    """Strict stream: the session's cached per-edge cardinalities equal a
    full pass after every delta while only a fraction is recomputed."""
    g = TG.erdos_renyi(120, 0.06, seed=5, device=CPU)
    s = stream_session(g, "bf", **KW)
    _ = s.session.edge_cardinalities()
    rng = np.random.default_rng(7)
    for _ in range(3):
        info = s.apply_delta(*_random_delta(rng, g.n, s.dyn.edge_array(),
                                            10, 3))
        assert 0 < info["cards_recomputed"] < s.dyn.m
        gs = TG.from_edge_array(g.n, s.dyn.edge_array(), device=CPU)
        full = TE.edge_cardinalities(gs, TS.build(gs, "bf", **KW),
                                     s.session.plan)
        assert torch.equal(s.session.edge_cardinalities(), full)


def test_accuracy_telemetry_matches_reference():
    """obs/accuracy: the fill ratio of every kind (the Bloom one counted on
    the sketch's device from int32 bit patterns), the pair-error gauges and
    the maintenance mirror equal the reference's."""
    from repro.core import sketches as RS
    from repro.obs import accuracy as RA
    from repro.obs.metrics import MetricsRegistry as RRegistry
    from repro_torch import convert
    from repro_torch.obs import accuracy as TA
    from repro_torch.obs.metrics import MetricsRegistry

    rg = RG.kronecker(8, 6, seed=4)
    rng = np.random.default_rng(2)
    cards = rng.uniform(0, 20, 32)
    du, dv = rng.integers(1, 40, 32), rng.integers(1, 40, 32)
    for kind in KINDS:
        rs = RS.build(rg, kind, **KW)
        ts = convert.sketch_from_numpy(np.asarray(rs.data), kind,
                                       rs.num_hashes, rs.k, rs.seed, rs.n,
                                       device=CPU)
        assert TA.fill_ratio(ts) == RA.fill_ratio(rs), kind
        r_reg, t_reg = RRegistry(), MetricsRegistry()
        assert TA.record_pair_error(ts, cards, du, dv, t_reg) == \
            RA.record_pair_error(rs, cards, du, dv, r_reg)
        stats = {"kind": kind, "rows_dirty": 3, "stale_total": 5,
                 "rows_rebuilt": 7, "rows_incremental": 11,
                 "deltas_applied": 2}
        RA.record_maintenance(stats, r_reg)
        TA.record_maintenance(stats, t_reg)
        TA.record_fill(ts, t_reg)
        RA.record_fill(rs, r_reg)
        assert t_reg.snapshot() == r_reg.snapshot()
