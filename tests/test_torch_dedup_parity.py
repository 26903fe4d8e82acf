"""Port parity: MinHash near-duplicate dedup (``data/dedup.py``).

The same corpora go through ``repro.data.dedup`` and
``repro_torch.data.dedup`` (``device="cpu"``). The integers are the
reference's: sketches identical (uint32), keep mask identical, and every
stats field equal (``checked_pairs``, ``dropped``, ``dropped_pairs`` with
Ĵ bit-identical, ``k``, ``bands``). Cases: a corpus with planted
near-duplicates, empty and short docs (shorter than ``w``: their tokens are
hashed), more bands than columns, and sketches built so that the buckets'
visiting order decides which pair drops a doc, which pins the reference's
order (by first member, then band). The twins of ``tests/test_data.py``'s
dedup tests are in ``tests/test_torch_dedup.py``. Sizes: ≤ 60 docs.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from repro.data import dedup as RD
from repro_torch.data import dedup as TD
from repro_torch.data import document_sketches, minhash_dedup

CPU = "cpu"


def _corpus(seed=0, n_docs=40, n_dups=15, vocab=5000):
    """As examples/dedup_corpus.py plants them: 3% token noise."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=rng.integers(200, 800))
            .astype(np.int64) for _ in range(n_docs)]
    for i in rng.choice(n_docs, size=n_dups, replace=False):
        d = docs[i].copy()
        idx = rng.choice(len(d), size=max(1, len(d) // 33), replace=False)
        d[idx] = rng.integers(0, vocab, size=len(idx))
        docs.append(d)
    return docs


def _same(ref, port):
    (rk, rs), (tk, ts) = ref, port
    assert tk.dtype == bool and np.array_equal(rk, tk)
    assert rs == ts
    for (a, b, j), (c, d, i) in zip(rs["dropped_pairs"], ts["dropped_pairs"]):
        assert (a, b) == (c, d) and type(c) is int
        assert np.float64(j).tobytes() == np.float64(i).tobytes()


@pytest.mark.parametrize("k,bands,threshold", [(265, 0, 0.7), (64, 0, 0.6),
                                               (16, 40, 0.5)])
def test_sketches_keep_and_stats_identical(k, bands, threshold):
    docs = _corpus()
    want = RD.document_sketches(docs, k)
    got = document_sketches(docs, k, device=CPU)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    _same(RD.minhash_dedup(docs, threshold, k, bands=bands),
          minhash_dedup(docs, threshold, k, bands=bands, device=CPU))


def test_empty_and_short_docs():
    """Docs shorter than w hash their tokens; empty docs keep 0xFFFFFFFF
    in every column, and two empty docs are candidates of each other."""
    rng = np.random.default_rng(4)
    docs = [np.zeros(0, np.int64), np.array([3, 4], np.int64),
            np.array([3, 4], np.int64), np.array([1, 2, 3, 4, 5], np.int64),
            np.array([1, 2, 3, 4, 5, 6], np.int64), np.zeros(0, np.int64),
            rng.integers(0, 50, 30).astype(np.int64), np.array([7]),
            np.array([2**32 + 3, -1], np.int64)]
    for w in (1, 5, 8):
        want = RD.document_sketches(docs, 12, w=w, seed=2)
        got = document_sketches(docs, 12, w=w, seed=2, device=CPU)
        assert np.array_equal(got, want)
        assert (got[0] == 0xFFFFFFFF).all() and (got[5] == 0xFFFFFFFF).all()
        _same(RD.minhash_dedup(docs, 0.5, 12, w=w, seed=2),
              minhash_dedup(docs, 0.5, 12, w=w, seed=2, device=CPU))
    assert np.array_equal(TD._shingles(docs[3], 5), RD._shingles(docs[3], 5))
    assert document_sketches([], 4, device=CPU).shape == (0, 4)


def test_bucket_order_decides_the_result(monkeypatch):
    """Doc 2 is Ĵ = 0.75 from both doc 0 and doc 1 (k = 8, 4 bands of 2).
    It shares bands 1-3 with doc 0 and band 0 with doc 1, doc 0 and doc 1
    share bands 1-2 (Ĵ = 0.5). Visiting buckets by first member drops doc
    2 through (0, 2) and checks (0, 1) twice; visiting band 0 first would
    drop it through (1, 2)."""
    sk = np.array([[10, 11, 20, 21, 30, 31, 40, 41],
                   [50, 51, 20, 21, 30, 31, 99, 98],
                   [50, 51, 20, 21, 30, 31, 40, 41]], dtype=np.uint32)
    docs = [np.arange(i, i + 9) for i in range(3)]
    monkeypatch.setattr(RD, "document_sketches",
                        lambda docs, k, w=5, seed=0: sk)
    monkeypatch.setattr(TD, "_sketch_tensor", lambda docs, k, w, seed, dev:
                        torch.from_numpy(sk.astype(np.int64)).to(dev))
    ref = RD.minhash_dedup(docs, 0.7, 8, bands=4)
    got = minhash_dedup(docs, 0.7, 8, bands=4, device=CPU)
    _same(ref, got)
    assert got[1]["dropped_pairs"] == [(0, 2, 0.75)]
    assert got[1]["checked_pairs"] == 3
    assert got[0].tolist() == [True, True, False]
