"""Port parity: MinHash dedup, the twins of ``tests/test_data.py``'s
dedup tests on the port (``device="cpu"``), and ``k_for`` /
``jaccard_estimate`` against ``repro.data.dedup``. Sketches, keep masks
and stats against the reference are in ``tests/test_torch_dedup_parity.py``.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import numpy as np

from repro.data import dedup as RD
from repro_torch.data import dedup as TD
from repro_torch.data import document_sketches, jaccard_estimate, \
    minhash_dedup

CPU = "cpu"


def test_k_for_and_jaccard_estimate():
    for gap, delta in ((0.1, 0.01), (0.05, 0.05), (0.2, 0.1)):
        assert TD.k_for(gap, delta) == RD.k_for(gap, delta)
    assert TD.k_for(0.1, 0.01) == 265
    a = np.array([1, 2, 3, 4], np.uint32)
    assert jaccard_estimate(a, np.array([1, 2, 0, 4], np.uint32)) == 0.75


# ---------------------------------------------------------------------------
# twins of tests/test_data.py
# ---------------------------------------------------------------------------

def _doc(rng, n=400):
    return rng.integers(0, 1000, size=n, dtype=np.int64)


def test_dedup_drops_planted_duplicates():
    rng = np.random.default_rng(0)
    base = [_doc(rng) for _ in range(20)]
    # plant near-duplicates: copy with 2% token noise
    dups = []
    for d in base[:8]:
        d2 = d.copy()
        idx = rng.choice(len(d2), size=len(d2) // 50, replace=False)
        d2[idx] = rng.integers(0, 1000, size=len(idx))
        dups.append(d2)
    docs = base + dups
    keep, stats = minhash_dedup(docs, threshold=0.6, k=64, device=CPU)
    assert keep[:20].all(), "originals kept"
    assert (~keep[20:]).sum() >= 6, f"planted dups should drop: {stats}"


def test_dedup_keeps_distinct_docs():
    rng = np.random.default_rng(1)
    docs = [_doc(rng) for _ in range(30)]
    keep, _ = minhash_dedup(docs, threshold=0.6, k=64, device=CPU)
    assert keep.all()


def test_sketch_jaccard_estimates_true_jaccard():
    rng = np.random.default_rng(2)
    a = _doc(rng, 2000)
    b = a.copy()
    b[:1000] = rng.integers(0, 1000, size=1000)  # ~50% shingle overlap
    sk = document_sketches([a, b], k=256, device=CPU)
    j = jaccard_estimate(sk[0], sk[1])
    assert 0.05 < j < 0.8
