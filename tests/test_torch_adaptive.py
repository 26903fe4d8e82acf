"""Port parity: the degree-adaptive Bloom filter's twins of
``tests/test_adaptive.py`` on the port, and the two generators it uses
(``barabasi_albert``, ``random_bipartite_community``) against the
reference's. Word counts, rows and estimates against ``repro.core.adaptive``
are in ``tests/test_torch_adaptive_parity.py``. Sizes: Kronecker scale 10,
Barabási–Albert n = 800.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np
import torch

import jax.numpy as jnp
from repro.core import adaptive as RA
from repro.core import graph as RG
from repro.core.hashing import np_hash_u32
from repro_torch.core import adaptive as TA
from repro_torch.core import exact as TX
from repro_torch.core import graph as TG
from repro_torch.core import sketches as TS
from repro_torch.core.intersect import make_pair_cardinality_fn

CPU = "cpu"


# ---------------------------------------------------------------------------
# twins of tests/test_adaptive.py
# ---------------------------------------------------------------------------

def test_folding_identity():
    """OR-folding h mod 2^a down to 2^b equals building with h mod 2^b."""
    rng = np.random.default_rng(0)
    elems = rng.integers(0, 10_000, size=60, dtype=np.uint32)
    for a_words, b_words in [(16, 4), (8, 8), (32, 2)]:
        big = np.zeros(a_words, np.uint32)
        small = np.zeros(b_words, np.uint32)
        for arr, w in [(big, a_words), (small, b_words)]:
            pos = np_hash_u32(elems, 3) % (w * 32)
            np.bitwise_or.at(arr, pos >> 5, np.uint32(1) << (pos & 31))
        folded = TA.fold_rows(torch.from_numpy(big.view(np.int32))[None],
                              b_words)
        assert np.array_equal(folded[0].numpy().view(np.uint32), small)
        want = np.asarray(RA._fold_to(jnp.asarray(np.pad(big, (0, 32 -
                                                              a_words))),
                                      jnp.int32(a_words), jnp.int32(b_words),
                                      32))
        assert np.array_equal(want[:b_words], small)


def test_budget_respected():
    g = TG.kronecker(10, 16, seed=1, device=CPU)
    for s in (0.2, 0.4):
        words = TA.size_for_budget(g, s)
        total_bits = int(words.sum()) * 32
        budget_bits = s * (2 * g.m + g.n + 1) * 32
        assert total_bits <= 1.6 * budget_bits
        assert np.all((words & (words - 1)) == 0), "power-of-two sizes"


def test_hub_filters_bigger():
    g = TG.barabasi_albert(800, 6, seed=2, device=CPU)
    sk = TA.build_adaptive_bloom(g, 0.33, num_hashes=1, seed=7)
    deg = g.deg.numpy()
    words = sk.words.numpy()
    hub, leaf = deg.argmax(), deg.argmin()
    assert words[hub] >= words[leaf]


def test_adaptive_beats_fixed_on_saturated_graph():
    g = TG.kronecker(10, 16, seed=2, device=CPU)
    fixed = TS.build(g, "bf", 0.33, num_hashes=1, seed=7)
    adap = TA.build_adaptive_bloom(g, 0.33, num_hashes=1, seed=7)
    pairs = g.edges
    exact = TX.exact_pair_cardinalities(g, pairs).numpy().astype(float)
    nz = exact > 0
    ef = make_pair_cardinality_fn(g, fixed)(pairs).numpy()
    ea = TA.adaptive_pair_cardinalities(adap, pairs).numpy()
    rf = np.median(np.abs(ef[nz] - exact[nz]) / exact[nz])
    ra = np.median(np.abs(ea[nz] - exact[nz]) / exact[nz])
    assert ra < rf, (ra, rf)


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------

def test_generators_identical_to_reference():
    """barabasi_albert and random_bipartite_community: the reference's
    edge keys, CSR and degrees."""
    pairs = [(RG.barabasi_albert(300, 4, seed=5),
              TG.barabasi_albert(300, 4, seed=5, device=CPU)),
             (RG.random_bipartite_community(200, 4, 0.2, 0.01, seed=3),
              TG.random_bipartite_community(200, 4, 0.2, 0.01, seed=3,
                                            device=CPU))]
    for r, t in pairs:
        for f in ("indptr", "indices", "deg", "edges"):
            assert np.array_equal(np.asarray(getattr(r, f)),
                                  getattr(t, f).numpy()), f
        assert (r.n, r.m, r.d_max) == (t.n, t.m, t.d_max)
