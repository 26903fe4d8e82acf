"""Port parity: the serving tier (``StreamSession`` + ``BatchedQueryServer``
+ ``ResultCache``) and the replay launcher ``repro_torch.launch.stream``.

Everything runs on the CPU (``device="cpu"``, the plain PyTorch path) at
small sizes (Erdős–Rényi n ≤ 72, Kronecker scale ≤ 8), under the strict
policy, so every comparison is exact:

  * every query kind a streamed server answers equals the answer of a
    from-scratch port session on the equivalent static graph;
  * cache on equals cache off under interleaved deltas (after
    ``tests/test_server_cache.py``);
  * answers served by the async worker while deltas land equal a
    synchronous cache-off replay at their ``answered_version``, and the
    quota, backlog, deadline and ``close`` contracts hold (after
    ``tests/test_server_async.py``, with short timeouts);
  * ``stats()`` has the reference server's keys and, on the same traffic,
    its counters (everything but the latency figures, which time);
  * the launcher at scale 8 verifies exactly.

The lock, publish and footprint disciplines are checked with
``tools.pgcheck`` (PG001, PG002, PG005) on ``src/repro_torch/stream`` and
``src/repro_torch/engine``. PG003 (pow2 bucketing before a jit boundary)
and PG004 (host syncs on unfenced ``jnp`` values inside spans) key on
JAX's ``jnp``/``jit`` and do not apply to the port.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import contextlib
import io
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.stream import BatchedQueryServer as RServer
from repro.stream import stream_session as r_stream_session
from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.launch import stream as TL
from repro_torch.stream import (BatchedQueryServer, DynamicGraph,
                                ErrorBudgetPolicy, OverloadError,
                                StreamSession, stream_session)
from repro_torch.stream.server import _edf_key, _freeze, _Pending

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
SKETCH_KW = dict(words=4, k=6, num_hashes=2, seed=3)


def _kw(kind):
    return dict(SKETCH_KW, policy=ErrorBudgetPolicy(0.0)) if kind else {}


def _values_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_values_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return bool(np.array_equal(a, np.asarray(b)))
    return a == b


def _session(seed=2, n=60, p=0.1, kind="bf", **kw):
    g = TG.erdos_renyi(n, p, seed=seed, device=CPU)
    return stream_session(g, kind, **_kw(kind), **kw)


def _wait_results(server, want, timeout=30.0):
    out = {}
    t0 = time.perf_counter()
    while len(out) < want:
        out.update(server.drain())
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"only {len(out)}/{want} answers arrived")
        time.sleep(0.001)
    return out


# ---------------------------------------------------------------------------
# streamed answers ≡ a static port session, every query kind
# ---------------------------------------------------------------------------

def _static_answers(st, static, pairs, mem, lp_u, lc_seed):
    """What a from-scratch session answers for the server's five kinds."""
    gs = static.graph
    out = {"similarity": static.similarity(torch.from_numpy(pairs),
                                           "jaccard").numpy()}
    u, cand = mem
    if static.sketch is not None and static.sketch.kind == "bf":
        sk = static.sketch
        out["membership"] = TS.bloom_membership(
            sk.data[u], torch.from_numpy(cand), gs.n, sk.num_hashes,
            sk.total_bits, sk.seed).numpy()
    else:
        out["membership"] = np.isin(cand, TG.neighbors_np(gs, u))
    nbrs = TG.neighbors_np(gs, lp_u)
    two = np.unique(np.concatenate([TG.neighbors_np(gs, int(x))
                                    for x in nbrs] or [np.zeros(0, np.int32)]))
    two = two[(two != lp_u) & ~np.isin(two, nbrs)]
    scores = static.similarity(torch.from_numpy(np.stack(
        [np.full(two.size, lp_u), two], 1).astype(np.int32)),
        "common").numpy()
    top = np.argsort(-scores, kind="stable")[:4]
    out["linkpred"] = {"candidates": two[top], "scores": scores[top]}
    res = static.local_cluster(np.array([lc_seed] * 8, np.int32),
                               alpha=0.15, eps=1e-2)
    size = int(res.best_size[0])
    out["localcluster"] = {
        "members": res.order[0, :size].numpy(),
        "conductance": float(res.best_conductance[0]), "size": size,
        "support": int(res.support[0])}
    out["tc"] = float(static.triangle_count())
    return out


@pytest.mark.parametrize("kind", ["bf", "kh", "1h", "kmv", None])
def test_streamed_answers_equal_static_session(kind):
    rng = np.random.default_rng(5)
    st = _session(seed=4, n=72, p=0.08, kind=kind)
    srv = BatchedQueryServer(st, min_batch=8, cache=True)
    for step in range(3):
        cur = st.dyn.edge_array()
        st.apply_delta(rng.integers(0, st.dyn.n, size=(10, 2)),
                       cur[rng.choice(cur.shape[0], 4, replace=False)])
        pairs = rng.integers(0, st.dyn.n, size=(12, 2)).astype(np.int32)
        mem = (int(rng.integers(0, st.dyn.n)),
               rng.integers(0, st.dyn.n, size=8).astype(np.int32))
        lp_u, lc_seed = int(rng.integers(0, st.dyn.n)), int(
            rng.integers(0, st.dyn.n))
        rids = {"similarity": srv.submit_similarity(pairs, "jaccard"),
                "membership": srv.submit_membership(*mem),
                "linkpred": srv.submit_link_prediction(lp_u, top_k=4),
                "localcluster": srv.submit_local_cluster(lc_seed, 0.15,
                                                         1e-2),
                "tc": srv.submit_triangle_count()}
        got = srv.flush()
        gs = TG.from_edge_array(st.dyn.n, st.dyn.edge_array(), device=CPU)
        sk = TS.build(gs, kind, **SKETCH_KW) if kind else None
        static = TE.session(gs, sk, plan=st.session.plan, device=CPU)
        want = _static_answers(st, static, pairs, mem, lp_u, lc_seed)
        for name, rid in rids.items():
            assert _values_equal(got[rid].value, want[name]), (kind, name,
                                                              step)
            assert got[rid].staleness == 0
    if kind in ("bf", None):
        rid = srv.submit_clique_count(4)
        assert srv.flush()[rid].value == float(static.four_clique_count())
    srv.close()


def test_cache_on_equals_cache_off_under_interleaved_deltas():
    """Second submissions are guaranteed hits; earlier rounds exercise
    footprint eviction; every cached answer equals the cache-off one."""
    for kind in ("bf", "kh", None):
        rng = np.random.default_rng(11)
        st = _session(seed=5, n=72, p=0.08, kind=kind)
        cached = BatchedQueryServer(st, min_batch=8)
        plain = BatchedQueryServer(st, min_batch=8, cache=False)
        n = st.dyn.n
        population = (
            [("sim", rng.integers(0, n, size=(4, 2)).astype(np.int32), m)
             for m in ("jaccard", "common", "overlap")]
            + [("mem", int(rng.integers(0, n)),
                rng.integers(0, n, size=8).astype(np.int32))
               for _ in range(2)]
            + [("lp", int(rng.integers(0, n))) for _ in range(2)]
            + [("lc", int(rng.integers(0, n))) for _ in range(2)]
            + [("tc",)])

        def submit(server, item):
            if item[0] == "sim":
                return server.submit_similarity(item[1], item[2])
            if item[0] == "mem":
                return server.submit_membership(item[1], item[2])
            if item[0] == "lp":
                return server.submit_link_prediction(item[1], top_k=5)
            if item[0] == "lc":
                return server.submit_local_cluster(item[1], 0.15, 1e-2)
            return server.submit_triangle_count()

        for _ in range(3):
            ins = rng.integers(0, n, size=(int(rng.integers(2, 10)), 2))
            cur = st.dyn.edge_array()
            st.apply_delta(ins, cur[rng.choice(cur.shape[0], size=3,
                                               replace=False)])
            for _ in range(2):
                sample = [population[i]
                          for i in rng.choice(len(population), size=6)]
                rids = [(submit(cached, it), submit(plain, it))
                        for it in sample]
                out_c, out_p = cached.flush(), plain.flush()
                for (rc, rp), it in zip(rids, sample):
                    assert _values_equal(out_c[rc].value, out_p[rp].value), \
                        (kind, it[0])
        assert cached.cache.hits > 0 and plain.cache is None
        cached.close()
        plain.close()


# ---------------------------------------------------------------------------
# snapshot isolation, async serving and admission contracts
# ---------------------------------------------------------------------------

def test_serving_view_is_isolated_and_leases_are_reported():
    st = _session()
    v0 = st.serving_view()
    tc0 = float(v0.session.triangle_count())
    nbrs0 = v0.host.neighbors(0).copy()
    st.apply_delta([[0, 1], [0, 2], [0, 3], [2, 5]])
    v1 = st.serving_view()
    assert v1.version == v0.version + 1 and v1.epoch == v0.epoch + 1
    assert float(v0.session.triangle_count()) == tc0
    np.testing.assert_array_equal(v0.host.neighbors(0), nbrs0)
    assert v1.host.m == st.dyn.m and v0.host.m != v1.host.m
    # the donation report: a stale view alive or a lease out vetoes
    assert not st.dyn.donate_ok()
    del v0
    assert st.dyn.donate_ok()
    view = st.acquire_serving_view()
    assert not st.dyn.donate_ok()
    st.release_serving_view(view)
    assert st.dyn.donate_ok()
    e = st.serving_view().epoch
    st.apply_delta(None, None)                  # a no-op still publishes
    assert st.serving_view().epoch == e + 1


def test_async_answers_equal_sync_replay_at_answered_version():
    """Deltas land from one thread while the async worker flushes from
    another; every answer equals a synchronous cache-off replay of the same
    request at its ``answered_version``."""
    n = 60
    g = TG.erdos_renyi(n, 0.1, seed=7, device=CPU)
    rng = np.random.default_rng(11)
    chunks = [c[c[:, 0] != c[:, 1]] for c in
              (rng.integers(0, n, size=(6, 2)).astype(np.int64)
               for _ in range(5))]
    st = stream_session(g, "bf", **_kw("bf"))
    srv = BatchedQueryServer(st, min_batch=8, async_flush=True,
                             max_batch=3, max_wait_s=0.005)

    def mutate():
        for chunk in chunks:
            st.apply_delta(chunk)
            time.sleep(0.004)

    kinds = ("similarity", "membership", "linkpred", "localcluster", "tc")
    qrng = np.random.default_rng(13)

    def submit(server, kind, spec=None):
        if spec is None:
            spec = {"similarity": (qrng.integers(0, n, (6, 2)).astype(
                        np.int32),),
                    "membership": (int(qrng.integers(0, n)),
                                   qrng.integers(0, n, 8).astype(np.int32)),
                    "linkpred": (int(qrng.integers(0, n)),),
                    "localcluster": (int(qrng.integers(0, n)),),
                    "tc": ()}[kind]
        rid = {"similarity": lambda: server.submit_similarity(*spec),
               "membership": lambda: server.submit_membership(*spec),
               "linkpred": lambda: server.submit_link_prediction(
                   *spec, top_k=4),
               "localcluster": lambda: server.submit_local_cluster(
                   *spec, eps=1e-2),
               "tc": server.submit_triangle_count}[kind]()
        return rid, (kind, spec)

    specs, results = {}, {}
    mutator = threading.Thread(target=mutate)
    try:
        mutator.start()
        i = 0
        while mutator.is_alive() and i < 120:
            rid, spec = submit(srv, kinds[i % len(kinds)])
            specs[rid] = spec
            i += 1
            results.update(srv.drain())
            time.sleep(0.001)
        mutator.join(30.0)
        assert not mutator.is_alive()
        for kind in kinds:
            rid, spec = submit(srv, kind)
            specs[rid] = spec
        results.update(srv.flush())
        results.update(_wait_results(srv, len(specs) - len(results)))
    finally:
        srv.close()
    assert len(results) == len(specs)
    versions = sorted({r.answered_version for r in results.values()})
    assert versions[-1] == len(chunks)
    for v in versions:
        truth_st = stream_session(g, "bf", **_kw("bf"))
        for chunk in chunks[:v]:
            truth_st.apply_delta(chunk)
        truth = BatchedQueryServer(truth_st, min_batch=8, cache=False)
        mapping = {submit(truth, *specs[rid])[0]: rid
                   for rid, r in results.items() if r.answered_version == v}
        answers = truth.flush()
        for t_rid, rid in mapping.items():
            assert _values_equal(results[rid].value, answers[t_rid].value), \
                (specs[rid][0], v)
        truth.close()


def test_async_backlog_alone_triggers_flush():
    st = _session()
    srv = BatchedQueryServer(st, min_batch=8, async_flush=True,
                             max_backlog=4)
    rids, done = [], threading.Event()

    def submit_all():
        for i in range(12):
            rids.append(srv.submit_membership(i % st.dyn.n,
                                              np.arange(4, dtype=np.int32)))
        done.set()

    t = threading.Thread(target=submit_all, daemon=True)
    try:
        t.start()
        t.join(30.0)
        assert done.is_set(), "submits blocked forever at max_backlog"
        out = srv.flush()
        out.update(_wait_results(srv, len(rids) - len(out)))
        assert set(out) == set(rids)
    finally:
        srv.close()
        t.join(5.0)


@pytest.mark.parametrize("async_flush", [False, True])
def test_close_answers_pending_then_rejects(async_flush):
    srv = BatchedQueryServer(_session(), min_batch=8, async_flush=async_flush)
    rid = srv.submit_triangle_count()
    srv.close()
    assert srv.closed and srv.cache is None
    assert rid in srv.drain()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit_triangle_count()
    srv.close()


def test_quota_deadline_and_edf():
    st = _session()
    srv = BatchedQueryServer(st, min_batch=8, tenant_quota=2)
    try:
        srv.submit_triangle_count(tenant="gold")
        srv.submit_clique_count(4, tenant="gold")
        with pytest.raises(OverloadError):
            srv.submit_triangle_count(tenant="gold")
        srv.submit_triangle_count(tenant="silver")
        srv.flush()
        tenants = srv.stats()["tenants"]
        assert tenants["gold"]["shed"] == 1 and tenants["gold"]["served"] == 2
        assert srv.stats()["shed"] == 1
        r_miss = srv.submit_triangle_count(tenant="gold", deadline_s=0.0)
        r_ok = srv.submit_triangle_count(tenant="gold", deadline_s=120.0)
        out = srv.flush()
        assert out[r_miss].deadline_missed and not out[r_ok].deadline_missed
        assert srv.stats()["tenants"]["gold"]["deadline_missed"] == 1
    finally:
        srv.close()
    ps = [_Pending(1, "x", (), "", None, {}, 0, 0.0, "t", 60.0),
          _Pending(2, "x", (), "", None, {}, 0, 0.0, "t", None),
          _Pending(3, "x", (), "", None, {}, 0, 0.0, "t", 0.5)]
    assert [p.request_id for p in sorted(ps, key=_edf_key)] == [3, 1, 2]
    nested = {"a": np.zeros(2), "b": [np.ones(2), {"c": np.arange(2)}]}
    _freeze(nested)
    with pytest.raises(ValueError):
        nested["b"][1]["c"][0] = 5


# ---------------------------------------------------------------------------
# stats() against the reference server on the same traffic
# ---------------------------------------------------------------------------

_TIMED = {"latency_mean_s", "latency_p95_s", "latency_p50_s",
          "latency_p99_s"}


def _strip_timed(d):
    return {k: _strip_timed(v) if isinstance(v, dict) else v
            for k, v in d.items() if k not in _TIMED}


def test_stats_equal_reference_server():
    rg = RG.kronecker(7, 8, seed=5)
    tg = TG.kronecker(7, 8, seed=5, device=CPU)
    r = r_stream_session(rg, "bf", storage_budget=0.5)
    t = stream_session(tg, "bf", storage_budget=0.5)
    rs, ts = RServer(r, min_batch=8), BatchedQueryServer(t, min_batch=8)
    rng = np.random.default_rng(3)
    n = rg.n
    for b in range(2):
        ins = rng.integers(0, n, size=(12, 2))
        cur = r.dyn.edge_array()
        dels = cur[rng.choice(cur.shape[0], 4, replace=False)]
        r.apply_delta(ins, dels)
        t.apply_delta(ins, dels)
        pairs = rng.integers(0, n, size=(5, 2)).astype(np.int32)
        seed = int(rng.integers(0, n))
        for srv in (rs, ts):
            srv.submit_similarity(pairs, "jaccard")
            srv.submit_similarity(pairs, "jaccard", tenant="gold")
            srv.submit_membership(3, np.arange(6, dtype=np.int32))
            srv.submit_link_prediction(seed, top_k=3)
            srv.submit_local_cluster(seed, 0.15, 1e-2)
            srv.submit_triangle_count(deadline_s=60.0)
            srv.flush()
            srv.submit_membership(3, np.arange(6, dtype=np.int32))
            srv.flush()
    want, got = rs.stats(), ts.stats()
    assert _strip_timed(want) == _strip_timed(got)
    assert set(want) == set(got)
    assert set(want["tenants"]["gold"]) == set(got["tenants"]["gold"])
    rs.close()
    ts.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_launcher_cpu_verify():
    """Scale 8 on the CPU: every batch verifies exactly (answers, sketch
    rows, CSR) and the summary carries the reference's sections."""
    out = _run(TL.main, ["--scale", "8", "--batches", "2", "--verify",
                         "--device", "cpu"])
    assert out["verify_all_exact"] is True and out["device"] == "cpu"
    assert out["batches"] == 2 and out["stream"]["version"] == 2
    assert out["server"]["by_kind"] == {"similarity": 2, "membership": 2,
                                        "linkpred": 2, "localcluster": 2,
                                        "tc": 2}


def test_launcher_needs_a_gpu_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TL.main(["--scale", "6", "--batches", "1"])
    with pytest.raises(SystemExit, match="--restore requires "
                       "--checkpoint-dir"):
        TL.main(["--scale", "6", "--device", "cpu", "--restore"])
    with pytest.raises(RuntimeError, match="cuda"):
        TL.main(["--scale", "6", "--restore", "--checkpoint-dir",
                 str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        DynamicGraph.from_edges(4, [[0, 1]])
    st = StreamSession(DynamicGraph.from_edges(4, [[0, 1]], device=CPU))
    path = st.save(str(tmp_path / "ck"))
    assert path.endswith("step_00000000")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamSession.restore(str(tmp_path / "ck"))
    back = StreamSession.restore(str(tmp_path / "ck"), device=CPU)
    assert np.array_equal(back.dyn.edge_keys, st.dyn.edge_keys)


# ---------------------------------------------------------------------------
# lock, publish and footprint disciplines
# ---------------------------------------------------------------------------

def test_pgcheck_disciplines_hold_in_the_port():
    """PG001 (locks), PG002 (invalidate before publish) and PG005
    (footprint per query kind) find nothing in the port's stream and
    engine; PG003/PG004 key on jnp and do not apply (module docstring)."""
    import sys
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tools.pgcheck.driver import run_paths
    findings = run_paths([str(REPO / "src" / "repro_torch" / "stream"),
                          str(REPO / "src" / "repro_torch" / "engine")],
                         select=["PG001", "PG002", "PG005"], root=str(REPO))
    assert findings == [], [f.render() for f in findings]
    from repro_torch.stream import server as TSV
    from repro.stream import server as RSV
    assert TSV.BatchedQueryServer._KIND_FOOTPRINTS == \
        RSV.BatchedQueryServer._KIND_FOOTPRINTS
