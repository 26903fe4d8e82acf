"""Port parity, the slice as a whole: Bloom TC and LCC through the engine;
also ``MiningSession.refresh`` (host and device carries) against the
reference's and a full pass, and ``Footprint``.

``session(kronecker(12, 16, seed=1), "bf", storage_budget=0.25)`` runs on
both sides, the reference with ``use_kernel=False`` and the port on the
CPU (its plain PyTorch path). Tolerances:

  * identical: sketch words, per-edge popcounts, hub permutation, plans;
  * ``rtol=1e-6``: per-edge estimates (XLA's and torch's ``log1p`` may
    differ by an ulp);
  * ``rtol=1e-5, atol=1e-6``: TC and LCC (float32 sums taken in another
    order).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import engine as RE
from repro.core import graph as RG
from repro.core import sketches as RS
from repro.core.algorithms import tc as RT
from repro.launch import mine as RM
from repro_torch import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.core.algorithms import tc as TT
from repro_torch.launch import mine as TM
from repro_torch.obs import trace as TTR

CPU = "cpu"


@pytest.fixture(scope="module")
def sessions():
    rg = RG.kronecker(12, 16, seed=1)
    tg = TG.kronecker(12, 16, seed=1, device=CPU)
    rs = RE.session(rg, "bf", storage_budget=0.25, use_kernel=False)
    ts = TE.session(tg, "bf", storage_budget=0.25, device=CPU)
    return rg, tg, rs, ts


def test_plans_equal(sessions):
    """Default plans (and a kernel-path override) compare equal."""
    rg, tg, rs, ts = sessions
    assert dataclasses.asdict(rs.plan) == dataclasses.asdict(ts.plan)
    assert not ts.plan.use_kernel and not ts.plan.degree_order
    assert dataclasses.asdict(RE.plan_for(rg, rs.sketch, use_kernel=True)) \
        == dataclasses.asdict(TE.plan_for(tg, ts.sketch, use_kernel=True))
    assert rs.stats() == ts.stats()


def test_sketch_and_per_edge_popcounts_identical(sessions):
    """Sketch words and per-edge popcounts over g.edges are identical."""
    rg, tg, rs, ts = sessions
    assert np.array_equal(ts.sketch.data.numpy().view(np.uint32),
                          np.asarray(rs.sketch.data))
    ref = np.asarray(RE.tuple_cardinality_ones(rs.sketch, rg.edges, rs.plan))
    got = TE.tuple_cardinality_ones(ts.sketch, tg.edges, ts.plan)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    rng = np.random.default_rng(0)
    triples = rng.integers(0, rg.n, size=(999, 3)).astype(np.int32)
    assert np.array_equal(
        TE.triple_cardinality_ones(ts.sketch, torch.from_numpy(triples),
                                   ts.plan).numpy(),
        np.asarray(RE.triple_cardinality_ones(rs.sketch,
                                              jnp.asarray(triples), rs.plan)))


def test_hub_permutation_identical(sessions):
    """order_edges_by_hub gives the reference's permutation and inverse."""
    rg, tg, _, _ = sessions
    r_sorted, r_inv = RE.order_edges_by_hub(rg, rg.edges)
    t_sorted, t_inv = TE.order_edges_by_hub(tg, tg.edges)
    assert np.array_equal(t_sorted.numpy(), np.asarray(r_sorted))
    assert np.array_equal(t_inv.numpy(), np.asarray(r_inv))
    assert torch.equal(t_sorted[t_inv], tg.edges)


def test_edge_cardinalities_tc_lcc(sessions):
    """Per-edge estimates rtol=1e-6; TC and LCC rtol=1e-5, atol=1e-6."""
    _, _, rs, ts = sessions
    np.testing.assert_allclose(ts.edge_cardinalities().numpy(),
                               np.asarray(rs.edge_cardinalities()), rtol=1e-6)
    np.testing.assert_allclose(float(ts.triangle_count()),
                               float(rs.triangle_count()), rtol=1e-5)
    np.testing.assert_allclose(ts.local_clustering().numpy(),
                               np.asarray(rs.local_clustering()),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("degree_order", [False, True])
@pytest.mark.parametrize("estimator", [None, "bf_l", "bf_or"])
def test_estimators_and_layouts(sessions, estimator, degree_order):
    """bf, bf_l and bf_or, with and without the hub layout, through the
    chunked map (edge_chunk=1000) and the chunked fold of triangle_count."""
    rg, tg, rs, ts = sessions
    kw = dict(estimator=estimator, degree_order=degree_order,
              edge_chunk=1000)
    r_plan = rs.plan.with_(**kw)
    t_plan = ts.plan.with_(**kw)
    ref = np.asarray(RE.edge_cardinalities(rg, rs.sketch, r_plan))
    got = TE.edge_cardinalities(tg, ts.sketch, t_plan).numpy()
    # bf_or is |X|+|Y|-|X∪Y|: an ulp of the union shows as absolute error
    atol = 1e-6 * float(np.abs(np.asarray(rg.deg)).max()) * 2 \
        if estimator == "bf_or" else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(
        float(TT.triangle_count(tg, ts.sketch, plan=t_plan)),
        float(RT.triangle_count(rg, rs.sketch, plan=r_plan)), rtol=1e-5)
    # c_v sums d_v per-edge estimates over d_v (d_v - 1): its absolute
    # error stays within one per-edge atol
    np.testing.assert_allclose(
        TT.local_clustering_coefficient(tg, ts.sketch, **kw).numpy(),
        np.asarray(RT.local_clustering_coefficient(rg, rs.sketch, **kw)),
        rtol=1e-5, atol=max(1e-6, atol))


def test_mine_session_reproduces_reference(sessions):
    """launch/mine.py mine_session(["tc", "lcc", "localcluster"]) gives the
    same numbers (the launcher's mean best conductance of its 8 seeds
    included); an unknown algo exits."""
    rg, tg, _, _ = sessions
    algos = ["tc", "lcc", "localcluster"]
    ref = RM.mine_session(rg, algos, storage_budget=0.25)
    got = TM.mine_session(tg, algos, storage_budget=0.25, device=CPU)
    assert got["build"][0] == ref["build"][0]
    for algo in algos:
        np.testing.assert_allclose(got[algo][0], ref[algo][0], rtol=1e-5)
    with pytest.raises(SystemExit):
        TM.mine_session(tg, ["bogus"], device=CPU)


def test_mine_cli_prints_session_json(capsys):
    """The CLI prints the human lines and the mine_session JSON line."""
    import json

    TM.main(["--scale", "8", "--device", "cpu", "--algos", "tc,lcc",
             "--metrics"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("graph: n=256")
    rec = json.loads(lines[-2])
    assert rec["event"] == "mine_session" and rec["use_kernel"] is False
    assert set(rec["algos"]) == {"tc", "lcc"}
    assert json.loads(lines[-1])["event"] == "metrics"


def test_spans_and_unported_paths(sessions):
    """engine.edge_cards is traced like the reference's; a sharded plan
    without an active mesh is the local fold, bit for bit (the reference's
    own check); the exact session (``sketch=None``) gives the reference's
    per-edge counts and TC."""
    _, tg, _, ts = sessions
    TTR.enable()
    TTR.clear()
    try:
        TE.MiningSession(tg, ts.sketch, ts.plan).edge_cardinalities()
        names = [e["name"] for e in TTR.events()]
    finally:
        TTR.disable()
        TTR.clear()
    assert "engine.edge_cards" in names
    plan = TE.session(tg, "bf", device=CPU, shard_edges=True).plan
    assert plan.shard_edges and plan == ts.plan.with_(shard_edges=True)
    sharded = TT.triangle_count(tg, ts.sketch, plan=plan)
    local = TT.triangle_count(tg, ts.sketch, plan=ts.plan)
    assert sharded.view(torch.int32) == local.view(torch.int32)
    rg = sessions[0]
    exact = TE.session(tg, None, device=CPU)
    ref = RE.session(rg, None)
    assert np.array_equal(exact.edge_cardinalities().numpy(),
                          np.asarray(ref.edge_cardinalities()))
    assert float(exact.triangle_count()) == float(ref.triangle_count())
    with pytest.raises(TypeError):
        TE.session(tg, "bf", device=CPU, bogus=1)
    forked = ts.fork()
    assert forked.sketch is ts.sketch and forked.plan == ts.plan


@pytest.mark.parametrize("kind, width", [("bf", "words"), ("kh", "k")])
def test_session_records_build_and_edge_pass_spans(kind, width):
    """A traced CPU session records ``sketch.build`` (kind, n, width) and
    ``engine.edge_cards`` with its chunk count and ``fused`` (False on the
    CPU), both fenced, and no span around the plan."""
    tg = TG.kronecker(8, 8, seed=1, device=CPU)
    TTR.enable()
    TTR.clear()
    try:
        sess = TE.session(tg, kind, storage_budget=1.0, device=CPU,
                          edge_chunk=100)
        sess.triangle_count()
        sess.local_clustering()
        events = TTR.events()
    finally:
        TTR.disable()
        TTR.clear()
    names = [e["name"] for e in events]
    assert "engine.plan_for" not in names
    assert names.count("sketch.build") == 1
    assert names.count("engine.edge_cards") == 1
    build = next(e for e in events if e["name"] == "sketch.build")
    want = (sess.sketch.data.shape[1] if width == "words"
            else sess.sketch.k)
    assert build["args"] == {"kind": kind, "n": tg.n, "width": want}
    edges = next(e for e in events if e["name"] == "engine.edge_cards")
    assert sess.plan.edge_chunk == 100
    assert edges["args"] == {"edges": tg.m, "chunks": -(-tg.m // 100),
                             "fused": False}
    for ev in (build, edges):
        assert 0 <= ev["enqueue_us"] <= ev["dur"]
    assert build["t1_ns"] <= edges["t0_ns"]


_FUSED_CASES = [
    # (sketch kind, plan.estimator, use_kernel, device) -> fused pass
    ("bf", None, True, "cuda", True),
    ("bf", "bf", True, "cuda", True),
    ("bf", None, True, "cuda:1", True),
    ("bf", "bf_l", True, "cuda", False),
    ("bf", "bf_or", True, "cuda", False),
    ("bf", None, False, "cuda", False),
    ("bf", None, True, "cpu", False),
    ("bf", None, False, "cpu", False),
    ("kh", None, True, "cuda", False),
    ("1h", None, True, "cuda", False),
    ("kmv", None, True, "cuda", False),
    (None, None, True, "cuda", False),
]


@pytest.mark.parametrize("kind, estimator, use_kernel, device, fused",
                         _FUSED_CASES)
def test_fused_edge_pass_dispatch(kind, estimator, use_kernel, device,
                                  fused):
    """Only a Bloom sketch under the AND estimator, with ``use_kernel``,
    on a CUDA device takes the one-launch per-edge pass; every other
    combination keeps the chunked ``map_edges`` (decided from the sketch,
    the plan and the device alone: no GPU needed)."""
    sketch = None if kind is None else TS.SketchSet(
        data=torch.zeros((4, 2), dtype=torch.int32), kind=kind,
        num_hashes=2, k=2, seed=0, n=4)
    plan = TE.EnginePlan(use_kernel=use_kernel, estimator=estimator)
    assert TE.fuses_edge_pass(sketch, plan, torch.device(device)) is fused


@pytest.mark.parametrize("degree_order", [False, True])
@pytest.mark.parametrize("estimator", [None, "bf_l"])
def test_cpu_edge_pass_keeps_chunked_map(sessions, estimator, degree_order,
                                         monkeypatch):
    """On the CPU the per-edge pass runs the chunked ``map_edges`` (one
    call, ⌈m / edge_chunk⌉ chunks) and gives, bit for bit, the plain chunk
    function over the hub-ordered edges, unsorted; the kernel wrapper's
    plain version gives the AND estimates of the same pairs bit for bit."""
    from repro_torch.engine import engine as TEE
    from repro_torch.kernels import fused_expr

    _, tg, _, ts = sessions
    plan = ts.plan.with_(estimator=estimator, degree_order=degree_order,
                         edge_chunk=4096)
    calls = []
    real = TEE.map_edges

    def spy(edges, fn, p):
        calls.append(edges.shape[0])
        return real(edges, fn, p)

    monkeypatch.setattr(TEE, "map_edges", spy)
    got = TE.edge_cardinalities(tg, ts.sketch, plan)
    assert calls == [tg.m]
    fn = TE.pair_cardinality_fn(tg, ts.sketch, plan)
    if degree_order:
        edges_s, inv = TE.order_edges_by_hub(tg, tg.edges)
        want = torch.cat([fn(edges_s[s:s + 4096])
                          for s in range(0, tg.m, 4096)])[inv]
    else:
        want = torch.cat([fn(tg.edges[s:s + 4096])
                          for s in range(0, tg.m, 4096)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if estimator is None:
        plain = fused_expr.fused_gather_cardinality(
            ts.sketch.data, tg.edges, ts.sketch.num_hashes,
            order=TE.hub_order(tg, tg.edges))
        assert torch.equal(plain.view(torch.int32), got.view(torch.int32))


@pytest.fixture(scope="module")
def refresh_graphs():
    """kronecker(9, 8, seed=1) before and after a delta (50 edges gone,
    200 new), both packages, with the host carry of the reference's
    ``DynamicGraph.carry_index`` contract: new edge j's position in the old
    edge order, or -1 when it is new or an endpoint was touched."""
    full = np.asarray(RG.kronecker(9, 8, seed=1).edges).astype(np.int64)
    n = 1 << 9
    old = full[:-200]
    new = np.concatenate([old[50:], full[-200:]])
    touched = np.unique(np.concatenate([old[:50], full[-200:]]).ravel())
    rg1, rg2 = RG.from_edge_array(n, old), RG.from_edge_array(n, new)
    tg1 = TG.from_edge_array(n, old, device=CPU)
    tg2 = TG.from_edge_array(n, new, device=CPU)
    k1 = tg1.edges.numpy().astype(np.int64) @ np.array([n, 1])
    k2 = tg2.edges.numpy().astype(np.int64) @ np.array([n, 1])
    pos = np.minimum(np.searchsorted(k1, k2), k1.size - 1)
    bad = np.isin(tg2.edges.numpy(), touched).any(1)
    carry = np.where((k1[pos] == k2) & ~bad, pos, -1)
    return rg1, rg2, tg1, tg2, carry


def test_refresh_host_and_device_carries(refresh_graphs):
    """``refresh`` with a host carry and with a ``DeviceCarry`` (positions
    padded past m_new, the edge buffer padded with sentinel rows): the
    same recompute count as the reference's ``refresh``, per-edge
    estimates within rtol 1e-6 of it, and bit-identical to a full pass."""
    rg1, rg2, tg1, tg2, carry = refresh_graphs
    rsk2 = RS.build(rg2, "bf", storage_budget=0.25)
    tsk2 = TS.build(tg2, "bf", storage_budget=0.25)
    full = TE.session(tg2, tsk2, device=CPU).edge_cardinalities()
    recompute = np.nonzero(carry < 0)[0]
    m_new, pad = tg2.m, 13
    for form in ("host", "device"):
        rs = RE.session(rg1, "bf", storage_budget=0.25, use_kernel=False)
        ts = TE.session(tg1, "bf", storage_budget=0.25, device=CPU)
        rs.edge_cardinalities()
        ts.edge_cardinalities()
        if form == "host":
            r_carry, t_carry = carry, carry
        else:
            pos = np.concatenate([recompute, m_new + np.arange(pad)])
            buf = np.concatenate([tg2.edges.numpy(),
                                  np.full((pad + 3, 2), tg2.n, np.int32)])
            r_carry = RE.DeviceCarry(jnp.asarray(carry), jnp.asarray(pos),
                                     recompute.size, jnp.asarray(buf))
            t_carry = TE.DeviceCarry(torch.from_numpy(carry),
                                     torch.from_numpy(pos), recompute.size,
                                     torch.from_numpy(buf))
        assert ts.refresh(tg2, tsk2, t_carry) == \
            rs.refresh(rg2, rsk2, r_carry) == recompute.size > 0
        got = ts.edge_cardinalities()
        assert torch.equal(got, full), form
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(rs.edge_cardinalities()),
                                   rtol=1e-6)
    ts = TE.session(tg1, "bf", storage_budget=0.25, device=CPU)
    ts.edge_cardinalities()
    assert ts.refresh(tg2) is None and ts._edge_cards is None
    assert ts.graph is tg2


def test_footprints_match_reference():
    fp = TE.Footprint.of(np.array([[3, 1], [7, 3]]), 9, None)
    ref = RE.Footprint.of(np.array([[3, 1], [7, 3]]), 9, None)
    np.testing.assert_array_equal(fp.vertices, ref.vertices)
    assert fp.intersects([7]) and not fp.intersects([2, 8])
    whole = TE.Footprint.whole_graph()
    assert whole.is_whole_graph and whole.intersects([0])
    assert not TE.Footprint.of().intersects([0])
