"""Degree-adaptive Bloom filters (the reference's accuracy optimization).

The paper's fixed-size Bloom filters saturate on the hub vertices of skewed
graphs: with B bits and b·d_v ≫ B a filter fills up and |X∩Y|_AND
explodes. The fix gives each vertex a filter of 2^κ(v) words in proportion
to its degree, under the same global storage budget. Cross-size
intersections stay exact through *folding*: with bit positions
``h mod 2^a``, OR-folding a filter in half yields exactly the filter that
``h mod 2^(a−1)`` would have built, so |X∩Y| between filters of different
sizes is an AND + popcount after folding the larger one down.

Layout (the port's own): the reference keeps ``uint32[n, words_max]``,
which at Kronecker scale 21 (hubs at ``max_words`` = 4096) would take
34 GB for 262 MB of content. Here the rows are ragged: ``data`` is one
flat int32 tensor of Σ words (the uint32 words' bit patterns), row v is
``data[offsets[v] : offsets[v] + words[v]]`` and equals the reference's
``data[v, :words[v]]`` bit for bit. No tensor of n × ``words_max``
elements exists on any path here.

The build sets the reference's bit positions on the device, in CSR
pieces. The pair pass groups pairs by their (larger, smaller) size class,
gathers each side's rows (a strided view of the flat words gives a class's
rows without a per-word index), OR-folds the larger side down, and counts
``popcount(fu & fv)`` with the dense AND2 form of ``fused_rows_popcount``
on the card (its plain version on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .graph import Graph
from .hashing import _GOLDEN, _MASK, hash_family, np_hash_u32
from .sketches import _entry_rows, _row_chunks, _u32_to_i32

#: (entry, hash function) bits plus words one build piece holds, about
_BUILD_PIECE = 1 << 25
#: words of the larger side's rows one pair piece gathers (64 MiB)
_PAIR_PIECE_WORDS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdaptiveBloom:
    """Ragged adaptive Bloom sketch (tensors on one device).

    Attributes:
      data:    int32[Σ words]  every row's words, row after row.
      offsets: int64[n+1]      row v starts at ``offsets[v]``.
      words:   int32[n]        power-of-two word count of each row.
      num_hashes / seed / n / words_max: ints.
    """

    data: torch.Tensor
    offsets: torch.Tensor
    words: torch.Tensor
    num_hashes: int
    seed: int
    n: int
    words_max: int

    @property
    def device(self) -> torch.device:
        """The device the sketch lives on."""
        return self.data.device

    def row(self, v: int) -> torch.Tensor:
        """Row ``v``'s words, int32[words[v]] (a view)."""
        lo = int(self.offsets[v])
        return self.data[lo:lo + int(self.words[v])]

    def class_rows(self, vertices: torch.Tensor, width: int) -> torch.Tensor:
        """Rows of ``vertices``, all of ``width`` words: int32[V, width].

        Gathered from a strided view of ``data`` whose row i is
        ``data[i : i + width]``, so a row is read as one contiguous run."""
        view = self.data.as_strided(
            (self.data.numel() - width + 1, width), (1, 1))
        return view[self.offsets[vertices.to(torch.int64)]]


def _pow2_words(deg: np.ndarray, bits_per_elem: float, min_words: int,
                max_words: int) -> np.ndarray:
    want_bits = np.maximum(deg, 1) * bits_per_elem
    words = np.maximum(np.ceil(want_bits / 32.0), min_words)
    pow2 = 2 ** np.ceil(np.log2(words)).astype(np.int64)
    return np.clip(pow2, min_words, max_words).astype(np.int64)


def size_for_budget(graph: Graph, storage_budget: float, min_words: int = 2,
                    max_words: int = 4096) -> np.ndarray:
    """Per-vertex pow2 word counts with Σ words·32 ≈ budget × CSR bits (the
    reference's host bisection on bits per element): int64[n]."""
    deg = graph.deg.cpu().numpy()
    target_words = storage_budget * (2 * graph.m + graph.n + 1)
    lo, hi = 1e-3, 1e4
    for _ in range(48):  # bisection on bits-per-element
        mid = (lo + hi) / 2
        total = _pow2_words(deg, mid, min_words, max_words).sum()
        if total > target_words:
            hi = mid
        else:
            lo = mid
    return _pow2_words(deg, lo, min_words, max_words)


def _hash_seed(i: int, seed: int) -> int:
    """Seed of hash function ``i``, as the reference's build forms it."""
    return (i + seed * _GOLDEN) & _MASK


def build_adaptive_bloom(graph: Graph, storage_budget: float = 0.25,
                         num_hashes: int = 1, seed: int = 0,
                         min_words: int = 2, max_words: int = 4096
                         ) -> AdaptiveBloom:
    """Build on the graph's device: bit ``hash_i(x) mod (words[v]·32)`` of
    row v for each neighbour x and hash function i (the reference's
    positions), in pieces of about ``_BUILD_PIECE`` bits and words.

    torch has no scatter-OR: the distinct bits of a piece are summed per
    word, which equals their OR."""
    n, dev = graph.n, graph.device
    words_np = size_for_budget(graph, storage_budget, min_words, max_words)
    offsets_np = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(words_np, out=offsets_np[1:])
    offsets = torch.from_numpy(offsets_np).to(dev)
    words = torch.from_numpy(words_np.astype(np.int32)).to(dev)
    data = torch.empty(int(offsets_np[-1]), dtype=torch.int32, device=dev)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    # one cumulative measure bounds both a piece's bits and its words
    work = indptr * max(num_hashes, 1) + offsets_np
    for start, stop in _row_chunks(work, n, _BUILD_PIECE):
        o0, o1 = int(offsets_np[start]), int(offsets_np[stop])
        idx = graph.indices[int(indptr[start]):int(indptr[stop])]
        row, _ = _entry_rows(graph.indptr[start:stop + 1])
        row_bits = words[start:stop].to(torch.int64)[row] * 32
        h = hash_family(idx, num_hashes, seed)                  # [E, b]
        base = (offsets[start:stop][row] - o0) * 32
        bit = torch.unique((base[:, None] + h % row_bits[:, None])
                           .reshape(-1))
        acc = torch.zeros(o1 - o0, dtype=torch.int64, device=dev)
        acc.index_add_(0, bit >> 5, torch.ones_like(bit) << (bit & 31))
        data[o0:o1] = _u32_to_i32(acc)
    return AdaptiveBloom(data=data, offsets=offsets, words=words,
                         num_hashes=num_hashes, seed=seed, n=n,
                         words_max=int(words_np.max()) if n else min_words)


def build_adaptive_bloom_np(graph: Graph, storage_budget: float = 0.25,
                            num_hashes: int = 1, seed: int = 0,
                            min_words: int = 2, max_words: int = 4096,
                            vertices: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host twin with ``np.bitwise_or.at``, as the reference builds, for
    the rows of ``vertices`` (every vertex when None): ``(data
    uint32[Σ words], offsets int64[V+1], words int64[V])`` in the ragged
    layout of :class:`AdaptiveBloom`."""
    words_all = size_for_budget(graph, storage_budget, min_words, max_words)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy()
    verts = (np.arange(graph.n) if vertices is None
             else np.asarray(vertices, dtype=np.int64))
    words = words_all[verts]
    offsets = np.zeros(verts.size + 1, dtype=np.int64)
    np.cumsum(words, out=offsets[1:])
    deg = indptr[verts + 1] - indptr[verts]
    rows = np.repeat(np.arange(verts.size), deg)
    starts = np.zeros(verts.size + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    entries = indptr[verts][rows] + np.arange(rows.size) - starts[rows]
    elems = indices[entries]
    row_bits = words[rows] * 32
    out = np.zeros(int(offsets[-1]), dtype=np.uint32)
    for i in range(num_hashes):
        pos = np_hash_u32(elems, _hash_seed(i, seed)) % row_bits
        np.bitwise_or.at(out, offsets[rows] + (pos >> 5),
                         (np.uint32(1) << (pos & 31)).astype(np.uint32))
    return out, offsets, words


def fold_rows(rows: torch.Tensor, target_words: int) -> torch.Tensor:
    """OR-fold int32[P, w] rows (w a power of two) down to
    ``target_words``: the reference's ``_fold_to``, halving until the
    width is reached (equal to OR over the ``w / target_words`` blocks)."""
    w = rows.shape[1]
    while w > target_words:
        w //= 2
        rows = rows[:, :w] | rows[:, w:]
    return rows.contiguous()


def _log2(words: torch.Tensor) -> torch.Tensor:
    """log2 of power-of-two word counts, int64."""
    return (torch.frexp(words.to(torch.float32))[1] - 1).to(torch.int64)


def adaptive_pair_ones(sk: AdaptiveBloom, pairs: torch.Tensor, plan=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(popcount(fu & fv) int32[P], wt int32[P])`` per pair, in the
    pairs' order, with ``wt = min(words[u], words[v])`` the width both rows
    are folded to.

    Pairs are grouped by (larger, smaller) size class; per class and
    piece of about ``_PAIR_PIECE_WORDS`` gathered words the larger side's
    rows are folded to ``wt`` and counted by the dense AND2 form (the
    CUDA kernel when the plan's ``use_kernel``, else its plain version;
    no plan follows the sketch's device)."""
    from ..engine import setexpr

    dev = sk.device
    use_kernel = dev.type == "cuda" if plan is None else plan.use_kernel
    ce = setexpr.compile_expr(setexpr.and_all(*setexpr.rows(2)),
                              use_kernel=use_kernel)
    pairs = torch.as_tensor(pairs, device=dev)
    u, v = pairs[:, 0].to(torch.int64), pairs[:, 1].to(torch.int64)
    wu, wv = sk.words[u], sk.words[v]
    big = torch.where(wu >= wv, u, v)
    small = torch.where(wu >= wv, v, u)
    wt = torch.minimum(wu, wv)
    code = _log2(torch.maximum(wu, wv)) * 16 + _log2(wt)
    order = torch.sort(code, stable=True).indices
    classes, counts = torch.unique_consecutive(code[order],
                                               return_counts=True)
    ones = torch.empty(pairs.shape[0], dtype=torch.int32, device=dev)
    start = 0
    for c, cnt in zip(classes.tolist(), counts.tolist()):
        wb, ws = 1 << (c // 16), 1 << (c % 16)
        step = max(1, _PAIR_PIECE_WORDS // wb)
        for s in range(start, start + cnt, step):
            idx = order[s:min(s + step, start + cnt)]
            ones[idx] = ce.ones_rows(
                fold_rows(sk.class_rows(big[idx], wb), ws),
                sk.class_rows(small[idx], ws))
        start += cnt
    return ones, wt


def adaptive_pair_cardinalities(sk: AdaptiveBloom, pairs: torch.Tensor,
                                plan=None) -> torch.Tensor:
    """|N_u ∩ N_v|_AND across (possibly different-size) adaptive filters:
    float32[P] in the pairs' order. The estimator is the reference's:
    ones clamped to B − 1, then −(B/k)·log1p(−ones/B) in float32, with
    B = wt · 32 (:func:`adaptive_pair_ones`)."""
    ones, wt = adaptive_pair_ones(sk, pairs, plan)
    total_bits = (wt * 32).to(torch.float32)
    ones = torch.minimum(ones.to(torch.float32), total_bits - 1.0)
    return -(total_bits / sk.num_hashes) * torch.log1p(-ones / total_bits)


def adaptive_triangle_count(graph: Graph, sk: AdaptiveBloom,
                            plan=None) -> torch.Tensor:
    """(1/3) Σ over edges of the adaptive estimate: a float32 scalar. The
    per-edge values are the reference's; they are summed in float64, as
    the port sums clique values (the reference sums in float32)."""
    vals = adaptive_pair_cardinalities(sk, graph.edges, plan)
    return (torch.sum(vals, dtype=torch.float64) / 3.0).to(torch.float32)
