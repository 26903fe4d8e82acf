"""Port parity, the slice as a whole: Bloom TC and LCC through the engine.

``session(kronecker(12, 16, seed=1), "bf", storage_budget=0.25)`` runs on
both sides, the reference with ``use_kernel=False`` and the port on the
CPU (its plain PyTorch path). Tolerances:

  * identical: sketch words, per-edge popcounts, hub permutation, plans;
  * ``rtol=1e-6``: per-edge estimates (XLA's and torch's ``log1p`` may
    differ by an ulp);
  * ``rtol=1e-5, atol=1e-6``: TC and LCC (float32 sums taken in another
    order).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import engine as RE
from repro.core import graph as RG
from repro.core.algorithms import tc as RT
from repro.launch import mine as RM
from repro_torch import engine as TE
from repro_torch.core import graph as TG
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
    """launch/mine.py mine_session(["tc", "lcc"]) gives the same numbers."""
    rg, tg, _, _ = sessions
    ref = RM.mine_session(rg, ["tc", "lcc"], storage_budget=0.25)
    got = TM.mine_session(tg, ["tc", "lcc"], storage_budget=0.25, device=CPU)
    assert got["build"][0] == ref["build"][0]
    for algo in ("tc", "lcc"):
        np.testing.assert_allclose(got[algo][0], ref[algo][0], rtol=1e-5)
    with pytest.raises(SystemExit):
        TM.mine_session(tg, ["localcluster"], device=CPU)


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
    """engine.edge_cards is traced like the reference's; unported options
    raise instead of running a different computation."""
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
    with pytest.raises(NotImplementedError):
        TE.session(tg, "bf", device=CPU, shard_edges=True)
    with pytest.raises(NotImplementedError):
        TE.session(tg, None, device=CPU).edge_cardinalities()
    with pytest.raises(TypeError):
        TE.session(tg, "bf", device=CPU, bogus=1)
    forked = ts.fork()
    assert forked.sketch is ts.sketch and forked.plan == ts.plan
