"""Port parity: the degree-adaptive Bloom filter (``core/adaptive.py``).

The same graphs (from the same seeded generators) go through
``repro.core.adaptive`` and ``repro_torch.core.adaptive`` on the CPU:

* word counts identical; rows bit-identical (the port's ragged rows
  against the reference's ``data[v, :words[v]]``, also through
  ``convert.adaptive_from_numpy`` and the host twin
  ``build_adaptive_bloom_np``);
* per-pair estimates within ROADMAP difference 2's rtol 1e-6 (an ulp of
  ``log1p``), for pairs across every combination of size classes; the
  triangle count within 1e-6 (the port sums in float64);
* nothing reads ``Graph.adj``, and no tensor of n × ``words_max``
  elements is made (every operator output watched; ROADMAP difference 11).

The twins of ``tests/test_adaptive.py`` are in
``tests/test_torch_adaptive.py``. Sizes: Kronecker scales 9 and 10.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
from repro.core import adaptive as RA
from repro.core import graph as RG
from repro_torch import convert
from repro_torch.core import adaptive as TA
from repro_torch.core import graph as TG
from repro_torch.core.graph import Graph

CPU = "cpu"


@pytest.fixture(scope="module")
def graphs():
    return RG.kronecker(10, 16, seed=2), TG.kronecker(10, 16, seed=2,
                                                      device=CPU)


def _ragged(ref_sketch):
    return convert.adaptive_from_numpy(np.asarray(ref_sketch.data),
                                       np.asarray(ref_sketch.words),
                                       ref_sketch.num_hashes,
                                       ref_sketch.seed, device=CPU)


# ---------------------------------------------------------------------------
# parity with repro.core.adaptive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,k,seed", [(1.0, 2, 0), (0.25, 3, 5)])
def test_words_rows_and_estimates_match_reference(graphs, s, k, seed):
    rg, tg = graphs
    ra = RA.build_adaptive_bloom(rg, s, num_hashes=k, seed=seed)
    ta = TA.build_adaptive_bloom(tg, s, num_hashes=k, seed=seed)
    assert np.array_equal(np.asarray(ra.words), ta.words.numpy())
    assert np.array_equal(RA.size_for_budget(rg, s),
                          TA.size_for_budget(tg, s))
    assert ta.words_max == ra.words_max
    ref = _ragged(ra)
    assert torch.equal(ref.data, ta.data) and torch.equal(ref.offsets,
                                                          ta.offsets)
    dense = np.asarray(ra.data)
    for v in (0, 1, int(np.argmax(np.asarray(rg.deg))), tg.n - 1):
        w = int(ta.words[v])
        assert np.array_equal(ta.row(v).numpy().view(np.uint32),
                              dense[v, :w])
        assert not dense[v, w:].any()
    host, offsets, words = TA.build_adaptive_bloom_np(tg, s, k, seed)
    assert np.array_equal(host.view(np.int32), ta.data.numpy())
    assert np.array_equal(offsets, ta.offsets.numpy())
    part, _, _ = TA.build_adaptive_bloom_np(tg, s, k, seed,
                                            vertices=np.array([5, 3]))
    assert np.array_equal(part.view(np.int32), torch.cat(
        [ta.row(5), ta.row(3)]).numpy())
    want = np.asarray(RA.adaptive_pair_cardinalities(ra, rg.edges))
    got = TA.adaptive_pair_cardinalities(ta, tg.edges).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    tc_ref = float(RA.adaptive_triangle_count(rg, ra))
    tc = TA.adaptive_triangle_count(tg, ta)
    assert tc.dtype == torch.float32
    assert float(tc) == pytest.approx(tc_ref, rel=1e-6)


def test_pairs_across_every_class_combination(graphs):
    """Two vertices of every size class, paired with each other in both
    orders (so every (w_u, w_v) combination and both fold sides): the
    popcounts after folding equal a numpy fold, the estimates the
    reference's."""
    rg, tg = graphs
    ra = RA.build_adaptive_bloom(rg, 1.0, num_hashes=2, seed=1)
    ta = TA.build_adaptive_bloom(tg, 1.0, num_hashes=2, seed=1)
    words = ta.words.numpy()
    reps = np.concatenate([np.nonzero(words == w)[0][:2]
                           for w in np.unique(words)])
    assert len(np.unique(words)) >= 8
    u, v = np.meshgrid(reps, reps, indexing="ij")
    pairs = np.stack([u.ravel(), v.ravel()], 1).astype(np.int32)
    ones, wt = TA.adaptive_pair_ones(ta, torch.from_numpy(pairs))
    dense = np.asarray(ra.data)

    def fold(row, w, target):
        return np.bitwise_or.reduce(row[:w].reshape(-1, target), axis=0)

    for (a, b), got, t in zip(pairs, ones.numpy(), wt.numpy()):
        assert t == min(words[a], words[b])
        fa, fb = fold(dense[a], words[a], t), fold(dense[b], words[b], t)
        assert got == int(np.unpackbits((fa & fb).view(np.uint8)).sum())
    want = np.asarray(RA.adaptive_pair_cardinalities(ra, jnp.asarray(pairs)))
    got = TA.adaptive_pair_cardinalities(ta, torch.from_numpy(pairs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


class _Outputs(TorchDispatchMode):
    """Records the largest storage (in elements) behind any operator
    output; a view counts its base's storage, not its own shape."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest,
                                   t.untyped_storage().nbytes()
                                   // t.element_size())
        return out


def test_no_adjacency_and_no_dense_matrix(monkeypatch):
    """Build, pair pass and TC never read ``Graph.adj`` and make no tensor
    of n × words_max elements (pieces cut small so that only such a matrix
    could reach that size)."""
    g = TG.kronecker(9, 16, seed=2, device=CPU)
    monkeypatch.setattr(Graph, "adj", property(
        lambda self: (_ for _ in ()).throw(AssertionError("adj read"))))
    monkeypatch.setattr(TA, "_BUILD_PIECE", 1 << 14)
    monkeypatch.setattr(TA, "_PAIR_PIECE_WORDS", 1 << 12)
    watch = _Outputs()
    with watch:
        sk = TA.build_adaptive_bloom(g, 1.0, num_hashes=2, seed=0)
        tc = TA.adaptive_triangle_count(g, sk)
    assert float(tc) > 0
    dense = g.n * sk.words_max
    assert sk.data.numel() < dense // 10
    assert watch.largest < dense, (watch.largest, dense)
