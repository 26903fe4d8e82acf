"""Port parity: link-prediction effectiveness ef (paper Listing 5).

ef of ``repro_torch.core.algorithms.linkpred`` against
``repro.core.algorithms.linkpred`` on the same seeded graph: identical for
the exact and k-Hash scorers, and for the Bloom scorer within the bound in
``test_effectiveness_matches_reference``'s docstring; plus the twins of
``test_algorithms.py``'s link-prediction tests. Sizes: Kronecker scales 8
and 9.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np
import pytest

from repro.core import graph as RG
from repro.core.algorithms import linkpred as RL
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.core.algorithms import linkpred as TL
from repro_torch.core.algorithms.similarity import pair_similarity

CPU = "cpu"


@pytest.fixture(scope="module")
def graphs8():
    return RG.kronecker(8, 8, seed=1), TG.kronecker(8, 8, seed=1, device=CPU)


@pytest.fixture(scope="module")
def gk():
    return TG.kronecker(9, 12, seed=4, device=CPU)


@pytest.mark.parametrize("kind", [None, "kh", "bf"])
def test_effectiveness_matches_reference(graphs8, kind):
    """ef identical for the exact and k-Hash scorers. The Bloom scores
    differ from the reference's by at most an ulp of ``log1p`` (difference
    2), which can only reorder candidates whose scores are that close: ef
    differs by at most the number of such candidates straddling the
    cut-off, over r (here none, so ef is equal)."""
    rg, tg = graphs8
    for frac, seed in ((0.2, 3),):
        want = RL.link_prediction_effectiveness(
            rg, removed_fraction=frac, sketch_kind=kind, seed=seed)
        got = TL.link_prediction_effectiveness(
            tg, removed_fraction=frac, sketch_kind=kind, seed=seed)
        if kind != "bf":
            assert got == want
            continue
        ts, removed = TL.split_edges(tg, frac, seed)
        cand = TL._distance2_candidates(ts)
        scores = pair_similarity(ts, cand, "common", TS.build(
            ts, "bf", 0.25, num_hashes=2, seed=seed)).numpy()
        r = removed.shape[0]
        cut = np.sort(scores)[::-1][min(r, scores.size) - 1]
        close = int((np.abs(scores - cut) <= 1e-6 * abs(cut)).sum()) \
            if r < scores.size else 0
        assert abs(got - want) <= close / r


def test_link_prediction_beats_random(gk):
    ef = TL.link_prediction_effectiveness(gk, "common", removed_fraction=0.05,
                                          seed=3)
    # wedge-candidate common-neighbors must beat uniform-random guessing
    assert ef > 0.01


def test_link_prediction_with_sketch(gk):
    ef = TL.link_prediction_effectiveness(gk, "common", removed_fraction=0.05,
                                          sketch_kind="bf",
                                          storage_budget=0.5, seed=3)
    assert ef > 0.005
