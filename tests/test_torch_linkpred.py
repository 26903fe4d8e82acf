"""Port parity: link-prediction effectiveness (paper Listing 5).

The same seeded graphs go through ``repro.core.algorithms.linkpred`` and
``repro_torch.core.algorithms.linkpred`` on the CPU:

* ``split_edges``: the same removed edges and the same sparse graph;
* the distance-2 candidates below the limit: the reference's set, also
  when the enumeration's pieces cut hub rows (piece size patched small);
* reference fault 7 (ROADMAP difference 12): at ``limit=100`` on
  ``kronecker(8, 8, seed=1)`` the reference returns 1,288 pairs, the port
  100, the first distinct ones in wedge order, all among the reference's;
* the scoring step on the same candidates.

ef against the reference and the twins of ``test_algorithms.py``'s
link-prediction tests are in ``tests/test_torch_linkpred_ef.py``. Size:
Kronecker scale 8.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.core import sketches as RS
from repro.core.algorithms import linkpred as RL
from repro.core.algorithms.similarity import pair_similarity as r_similarity
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.core.algorithms import linkpred as TL
from repro_torch.core.algorithms.similarity import pair_similarity
from repro_torch.obs.metrics import REGISTRY

CPU = "cpu"


@pytest.fixture(scope="module")
def graphs8():
    return RG.kronecker(8, 8, seed=1), TG.kronecker(8, 8, seed=1, device=CPU)


def _wedge_order(g, limit):
    """The first ``limit`` distinct non-edge wedge pairs, by a plain loop
    in the reference's order (v ascending, then i < j in v's row)."""
    indptr, indices = g.indptr.numpy(), g.indices.numpy()
    edges = {tuple(e) for e in g.edges.numpy().tolist()}
    seen = []
    found = set()
    for v in range(g.n):
        nb = indices[indptr[v]:indptr[v + 1]].tolist()
        for i in range(len(nb)):
            for j in range(i + 1, len(nb)):
                pair = (nb[i], nb[j])
                if pair not in edges and pair not in found:
                    found.add(pair)
                    seen.append(pair)
                    if len(seen) == limit:
                        return seen
    return seen


def test_split_edges_identical(graphs8):
    rg, tg = graphs8
    for frac, seed in ((0.1, 0), (0.3, 5)):
        rs, rr = RL.split_edges(rg, frac, seed)
        ts, tr = TL.split_edges(tg, frac, seed)
        assert np.array_equal(rr, tr) and tr.dtype == np.int32
        for f in ("indptr", "indices", "deg", "edges"):
            assert np.array_equal(np.asarray(getattr(rs, f)),
                                  getattr(ts, f).numpy()), f


@pytest.mark.parametrize("chunk", [None, 37])
def test_candidates_identical_below_the_limit(graphs8, monkeypatch, chunk):
    """Every distance-2 non-adjacent pair of the sparse graph, sorted, as
    the reference returns them; with pieces of 37 wedges the hub rows are
    cut across pieces and the result does not change."""
    rg, tg = graphs8
    if chunk is not None:
        monkeypatch.setattr(TL, "_CHUNK_WEDGES", chunk)
    rs, _ = RL.split_edges(rg, 0.1, 0)
    ts, _ = TL.split_edges(tg, 0.1, 0)
    want = RL._distance2_candidates(rs)
    got = TL._distance2_candidates(ts)
    assert got.dtype == torch.int32 and got.device == torch.device(CPU)
    assert np.array_equal(got.numpy(), want)
    assert REGISTRY.gauge("linkpred_candidates").value == want.shape[0]
    deg = ts.deg.numpy().astype(np.int64)
    assert REGISTRY.gauge("linkpred_wedges_read").value == \
        int((deg * (deg - 1) // 2).sum())


def test_reference_fault_7_limit_overshoots(graphs8):
    """The reference's ``break`` leaves only its inner loop: at limit=100
    it returns 1,288 of the 12,439 pairs. The port stops at 100: the first
    distinct pairs in wedge order, each among the reference's."""
    rg, tg = graphs8
    assert RL._distance2_candidates(rg).shape[0] == 12_439
    ref = RL._distance2_candidates(rg, limit=100)
    got = TL._distance2_candidates(tg, limit=100).numpy()
    assert ref.shape[0] == 1_288 and got.shape[0] == 100
    want = sorted(_wedge_order(tg, 100))
    assert [tuple(p) for p in got.tolist()] == want
    assert {tuple(p) for p in got.tolist()} <= {tuple(p)
                                               for p in ref.tolist()}
    assert REGISTRY.gauge("linkpred_wedges_read").value < 12_439 * 10


def test_candidate_scores_match_reference(graphs8):
    """The scoring step on the same candidates: k-Hash common counts
    identical, Bloom within difference 2's rtol (the exact scorer's ef is
    compared below)."""
    rg, tg = graphs8
    rs, _ = RL.split_edges(rg, 0.1, 0)
    ts, _ = TL.split_edges(tg, 0.1, 0)
    cand = TL._distance2_candidates(ts)
    for kind in ("kh", "bf"):
        rk = RS.build(rs, kind, 0.5, num_hashes=2, seed=0) if kind else None
        tk = TS.build(ts, kind, 0.5, num_hashes=2, seed=0) if kind else None
        want = np.asarray(r_similarity(rs, cand.numpy(), "common", rk))
        got = pair_similarity(ts, cand, "common", tk).numpy()
        if kind == "bf":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            assert np.array_equal(got, want), kind


def test_empty_and_tiny_graphs():
    g = TG.from_edge_array(5, np.array([[0, 1]]), device=CPU)
    assert TL._distance2_candidates(g).shape == (0, 2)
    assert TL.link_prediction_effectiveness(g) == 0.0
    path = TG.from_edge_array(4, np.array([[0, 1], [1, 2], [2, 3]]),
                              device=CPU)
    assert TL._distance2_candidates(path).tolist() == [[0, 2], [1, 3]]
