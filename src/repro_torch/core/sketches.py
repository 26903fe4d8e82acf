"""Probabilistic set representations of vertex neighborhoods (ProbGraph §II-D).

Representations, as in ``repro.core.sketches``:

  * Bloom filter  : int32[n, words]  (B = 32*words bits, b hash functions),
                    int32 bit patterns of the reference's uint32 words
  * k-Hash MinHash: int32[n, k]      (argmin element per hash function)
  * 1-Hash MinHash: int32[n, k]      (elements with the k smallest hashes,
                                      sorted by hash; sentinel-padded)
  * KMV           : float32[n, k]    (k smallest hash values in (0, 1];
                                      pad = 2.0)

The sentinel for a missing element is ``n``. Every builder reads the CSR
arrays in bounded row chunks, never the padded adjacency, so it runs at
sizes where ``adj`` cannot exist; its output is array-identical to the
reference builder's. The CSR keeps each row's neighbours ascending, which
is what breaks hash ties by element id here as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import trace
from .graph import Graph
from .hashing import (_GOLDEN, _MASK, hash_family, hash_u32,
                      hash_unit_interval, np_hash_u32)

#: hash of a missing element (uint32 all-ones; hashes are int64 here)
PAD_HASH = 0xFFFFFFFF
#: KMV value of a missing element
KMV_PAD = 2.0

_SHIFTS = tuple(range(32))

#: bool bits a Bloom build chunk may hold at once (256 MiB)
_CHUNK_BITS = 1 << 28

#: (entry, hash function) candidates a MinHash/KMV build chunk may hold at
#: once; each takes a few int64 temporaries, so a chunk stays near 1 GiB
_CHUNK_CANDIDATES = 1 << 25

#: k-Hash packs (hash, element) into one int64 key; element ids are < 2**31
_ELEM_SPAN = 1 << 31
_NO_KEY = (1 << 63) - 1


# ----------------------------------------------------------------------------
# Storage-budget parameterization (paper §V-A)
# ----------------------------------------------------------------------------

def bloom_words_for_budget(n: int, m: int, s: float, min_words: int = 2) -> int:
    """Bloom words/vertex so total sketch bits ≈ s × CSR bits (CSR ≈ (2m+n)·32)."""
    csr_bits = (2 * m + n + 1) * 32
    bits_per_vertex = max(1.0, s * csr_bits / max(n, 1))
    words = int(np.ceil(bits_per_vertex / 32.0))
    # round UP to a multiple of 2 words (64-bit lanes); clamping to
    # min_words happens first so an odd min_words cannot leak an odd count
    words = max(words, min_words)
    words += words % 2
    return words


def minhash_k_for_budget(n: int, m: int, s: float, min_k: int = 4) -> int:
    """k so total MinHash storage ≈ s × CSR storage (Wk bits per vertex)."""
    csr_words = 2 * m + n + 1
    k = int(np.floor(s * csr_words / max(n, 1)))
    return max(min_k, k)


# ----------------------------------------------------------------------------
# CSR row chunks
# ----------------------------------------------------------------------------

def _row_chunks(indptr: np.ndarray, row_cap: int, entry_cap: int):
    """(start, stop) row ranges covering the CSR in order: at most
    ``row_cap`` rows and ``entry_cap`` entries each, except that a row
    with more entries gets a chunk of its own."""
    n = indptr.shape[0] - 1
    start = 0
    while start < n:
        stop = min(n, start + row_cap)
        fit = int(np.searchsorted(indptr, indptr[start] + entry_cap,
                                  side="right")) - 1
        stop = max(start + 1, min(stop, fit))
        yield start, stop
        start = stop


def _entry_rows(indptr: torch.Tensor) -> tuple:
    """For a CSR slice: (row id of every entry, entry count of every row)."""
    rows = indptr.numel() - 1
    counts = (indptr[1:] - indptr[:-1]).to(torch.int64)
    row = torch.repeat_interleave(
        torch.arange(rows, device=indptr.device), counts)
    return row, counts


# ----------------------------------------------------------------------------
# bit packing
# ----------------------------------------------------------------------------

def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit pattern."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., 32*w] -> int32[..., w] (bit i of a word is element i)."""
    *lead, total = bits.shape
    w = total // 32
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=bits.device)
    b64 = bits.reshape(*lead, w, 32).to(torch.int64)
    return _u32_to_i32(torch.sum(b64 << shifts, dim=-1))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[..., w] -> bool[..., 32*w]."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64)[..., None] & _MASK) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(torch.bool)


# ----------------------------------------------------------------------------
# Bloom filters
# ----------------------------------------------------------------------------

def bloom_rows(indptr: torch.Tensor, indices: torch.Tensor, words: int,
               num_hashes: int = 2, seed: int = 0) -> torch.Tensor:
    """Bloom rows for the vertices of a CSR slice: int32[rows, words].

    ``indptr`` is the slice's row-pointer array (``rows + 1`` entries, its
    first entry the offset of ``indices[0]``). For every CSR entry and hash
    function the bit ``hash % total_bits`` is set in a bool bit-matrix,
    then packed 32 → 1. Duplicate positions are benign for OR.
    """
    total_bits = words * 32
    rows = indptr.numel() - 1
    bits = torch.zeros(rows * total_bits, dtype=torch.bool,
                       device=indices.device)
    row, _ = _entry_rows(indptr)
    h = hash_family(indices, num_hashes, seed)
    flat = row[:, None] * total_bits + h % total_bits        # [entries, b]
    bits[flat.reshape(-1)] = True
    return pack_bits(bits.reshape(rows, total_bits))


def build_bloom(graph: Graph, words: int, num_hashes: int = 2, seed: int = 0,
                chunk_bits: int = _CHUNK_BITS) -> torch.Tensor:
    """Bloom construction from the CSR: int32[n, words] on the graph's device.

    Vertices are taken in chunks whose bit-matrix holds at most
    ``chunk_bits`` bools and whose CSR entries times hash functions stay
    under ``chunk_bits / 4`` (each takes int64 temporaries), so memory
    stays bounded at any graph size; a row of higher degree gets a chunk
    of its own.
    """
    return build_bloom_range(graph, words, 0, graph.n, num_hashes, seed,
                             chunk_bits)


def build_bloom_range(graph: Graph, words: int, start: int, stop: int,
                      num_hashes: int = 2, seed: int = 0,
                      chunk_bits: int = _CHUNK_BITS) -> torch.Tensor:
    """The Bloom rows of vertices [start, stop): int32[stop - start, words],
    equal to ``build_bloom(...)[start:stop]``, built in the same bounded
    chunks over that range of the CSR."""
    total_bits = words * 32
    out = torch.empty((stop - start, words), dtype=torch.int32,
                      device=graph.device)
    if stop <= start:
        return out
    indptr = graph.indptr[start:stop + 1].cpu().numpy().astype(np.int64)
    entry_cap = max(1, chunk_bits // (4 * max(num_hashes, 1)))
    row_cap = max(1, chunk_bits // total_bits)
    for lo, hi in _row_chunks(indptr, row_cap, entry_cap):
        out[lo:hi] = bloom_rows(
            graph.indptr[start + lo:start + hi + 1],
            graph.indices[int(indptr[lo]):int(indptr[hi])],
            words, num_hashes, seed)
    return out


def build_bloom_np(graph: Graph, words: int, num_hashes: int = 2,
                   seed: int = 0) -> np.ndarray:
    """Host-side construction with np.bitwise_or.at: uint32[n, words]."""
    n = graph.n
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n), deg)
    total_bits = words * 32
    out = np.zeros((n, words), dtype=np.uint32)
    for i in range(num_hashes):
        s = np.uint32((i + seed * _GOLDEN) & _MASK)
        pos = np_hash_u32(indices, int(s)) % total_bits
        np.bitwise_or.at(out, (rows, pos >> 5), np.uint32(1) << (pos & 31))
    return out


def bloom_positions(x, num_hashes: int, total_bits: int,
                    seed: int = 0) -> torch.Tensor:
    """Bit positions of keys ``x`` under a Bloom sketch's ``num_hashes``
    hash functions: int64[..., num_hashes] in ``[0, total_bits)``."""
    return hash_family(x, num_hashes, seed) % total_bits


def bloom_test(data: torch.Tensor, rows: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Whether all bits ``positions[..., :]`` are set in the Bloom rows
    ``data[rows]``: bool[...] (``rows`` [...], ``positions`` [..., b]).

    Words are gathered from the flat sketch, one element per index: on
    CUDA a row gather of ``data`` would copy whole rows per index."""
    flat = rows.to(torch.int64)[..., None] * data.shape[1] + (positions >> 5)
    words = data.reshape(-1)[flat]
    return ((words >> (positions & 31)) & 1 == 1).all(-1)


def bloom_membership(bloom_row: torch.Tensor, candidates: torch.Tensor,
                     n: int, num_hashes: int, total_bits: int,
                     seed: int = 0) -> torch.Tensor:
    """Query x ∈ X for a batch of candidates against one Bloom row.

    bloom_row: int32[words]; candidates: int[...]; returns bool[...].
    Candidates ``>= n`` (pads) are never members.
    """
    valid = candidates < n
    safe = torch.where(valid, candidates, 0)
    pos = bloom_positions(safe, num_hashes, total_bits, seed)
    return bloom_test(bloom_row[None], torch.zeros_like(safe), pos) & valid


# ----------------------------------------------------------------------------
# MinHash (k-Hash): one argmin per hash function (multiset semantics)
# ----------------------------------------------------------------------------

def khash_rows(indptr: torch.Tensor, indices: torch.Tensor, n: int, k: int,
               seed: int = 0) -> torch.Tensor:
    """k-Hash rows for the vertices of a CSR slice: int32[rows, k].

    ``indptr`` is the slice's row-pointer array, as for :func:`bloom_rows`.
    Per hash function the row keeps the element of smallest hash, the
    smallest element among equal hashes (the reference's ``argmin`` over an
    ascending row): one segmented min over keys ``hash·2³¹ + element``,
    which stay below 2⁶³. An empty row gives the sentinel ``n``.
    """
    row, counts = _entry_rows(indptr)
    key = hash_family(indices, k, seed) * _ELEM_SPAN
    key += indices.to(torch.int64)[:, None]
    best = torch.full((counts.numel(), k), _NO_KEY, dtype=torch.int64,
                      device=indices.device)
    best.scatter_reduce_(0, row[:, None].expand(-1, k), key, "amin")
    elems = torch.remainder(best, _ELEM_SPAN)
    return torch.where(counts[:, None] > 0, elems, n).to(torch.int32)


def _sorted_in_rows(indptr: torch.Tensor, key: torch.Tensor, k: int):
    """Order a CSR slice's entries by (row, ``key``), ties in CSR order.

    ``key`` is int64 in [0, 2³²). Returns (row, rank, order): entry ``i``
    of the sorted slice is ``order[i]``; it lies in row ``row[i]`` at
    position ``rank[i]`` of that row, and only ranks below ``k`` are kept.
    """
    row, _ = _entry_rows(indptr)
    order = torch.sort(row * (1 << 32) + key, stable=True).indices
    # rows keep their places, so row r's sorted entries still start at
    # indptr[r] (relative to the slice)
    starts = (indptr[:-1] - indptr[0]).to(torch.int64)
    rank = torch.arange(order.numel(), device=key.device) - starts[row]
    keep = rank < k
    return row[keep], rank[keep], order[keep]


def build_khash(graph: Graph, k: int, seed: int = 0,
                chunk_candidates: int = _CHUNK_CANDIDATES) -> torch.Tensor:
    """int32[n, k]: element with the smallest h_i among N_v, per hash fn i.

    Empty neighborhoods yield the sentinel ``n``. A chunk holds at most
    ``chunk_candidates`` (entry, hash function) pairs.
    """
    return _build_rows(graph, k, torch.int32, chunk_candidates, k,
                       lambda ptr, idx: khash_rows(ptr, idx, graph.n, k,
                                                   seed))


# ----------------------------------------------------------------------------
# MinHash (1-Hash): k smallest under a single hash function, sorted by hash
# ----------------------------------------------------------------------------

def onehash_rows(indptr: torch.Tensor, indices: torch.Tensor, n: int, k: int,
                 seed: int = 0) -> torch.Tensor:
    """1-Hash rows for the vertices of a CSR slice: int32[rows, k].

    Elements ordered by hash, ties by element id; rows with fewer than k
    elements are padded with ``n``. As in the reference, an element whose
    hash is ``PAD_HASH`` is indistinguishable from a pad and becomes ``n``.
    """
    h = hash_u32(indices, seed)
    row, rank, order = _sorted_in_rows(indptr, h, k)
    out = torch.full((indptr.numel() - 1, k), n, dtype=torch.int32,
                     device=indices.device)
    out[row, rank] = torch.where(h[order] == PAD_HASH, n, indices[order])
    return out


def build_1hash(graph: Graph, k: int, seed: int = 0,
                chunk_candidates: int = _CHUNK_CANDIDATES) -> torch.Tensor:
    """int32[n, min(k, d_max)]: elements with the k smallest h(x), ascending
    by hash; rows with d_v < k are sentinel-padded.

    The reference keeps ``[:, :k]`` of its ``d_max``-wide padded rows, so
    a graph with ``d_max < k`` gets ``d_max`` columns; this keeps that
    width.
    """
    width = min(k, graph.d_max)
    return _build_rows(graph, width, torch.int32, chunk_candidates, 1,
                       lambda ptr, idx: onehash_rows(ptr, idx, graph.n,
                                                     width, seed))


def onehash_values(sketch: torch.Tensor, n: int, seed: int = 0
                   ) -> torch.Tensor:
    """Hash values of a 1-Hash sketch (int64 holding uint32; pads ->
    ``PAD_HASH``)."""
    valid = sketch < n
    h = hash_u32(torch.where(valid, sketch, 0), seed)
    return torch.where(valid, h, PAD_HASH)


# ----------------------------------------------------------------------------
# KMV: k smallest hash values mapped to (0, 1]  (paper §IX)
# ----------------------------------------------------------------------------

def kmv_rows(indptr: torch.Tensor, indices: torch.Tensor, k: int,
             seed: int = 0) -> torch.Tensor:
    """KMV rows for the vertices of a CSR slice: float32[rows, k],
    ascending, padded with ``KMV_PAD``."""
    h = hash_unit_interval(indices, seed)
    # positive float32 values order as their bit patterns
    row, rank, order = _sorted_in_rows(
        indptr, h.view(torch.int32).to(torch.int64), k)
    out = torch.full((indptr.numel() - 1, k), KMV_PAD, dtype=torch.float32,
                     device=indices.device)
    out[row, rank] = h[order]
    return out


def build_kmv(graph: Graph, k: int, seed: int = 0,
              chunk_candidates: int = _CHUNK_CANDIDATES) -> torch.Tensor:
    """float32[n, min(k, d_max)]: k smallest unit-interval hashes,
    ascending; pad = 2.0 (width as :func:`build_1hash`)."""
    width = min(k, graph.d_max)
    return _build_rows(graph, width, torch.float32, chunk_candidates, 1,
                       lambda ptr, idx: kmv_rows(ptr, idx, width, seed))


def _build_rows(graph: Graph, width: int, dtype: torch.dtype,
                chunk_candidates: int, per_entry: int, rows_fn
                ) -> torch.Tensor:
    """Run ``rows_fn(indptr_slice, indices_slice)`` over CSR row chunks of
    at most ``chunk_candidates`` output slots and entries × ``per_entry``
    candidates, into a [n, width] matrix on the graph's device."""
    n = graph.n
    out = torch.empty((n, width), dtype=dtype, device=graph.device)
    if n == 0:
        return out
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    for start, stop in _row_chunks(
            indptr, max(1, chunk_candidates // max(width, 1)),
            max(1, chunk_candidates // per_entry)):
        out[start:stop] = rows_fn(
            graph.indptr[start:stop + 1],
            graph.indices[int(indptr[start]):int(indptr[stop])])
    return out


@dataclasses.dataclass(frozen=True)
class SketchSet:
    """A named bundle of sketches for one graph (the paper's Listing 6
    ``ProbGraph(g, KIND, s)``). ``data`` is int32[n, words] for Bloom,
    int32[n, k] for k-Hash and 1-Hash, float32[n, k] for KMV."""

    data: torch.Tensor
    kind: str
    num_hashes: int
    k: int
    seed: int
    n: int

    @property
    def total_bits(self) -> int:
        """Bits per Bloom row (0 for other kinds)."""
        if self.kind == "bf":
            return self.data.shape[1] * 32
        return 0


def build(graph: Graph, kind: str, storage_budget: float = 0.25,
          num_hashes: int = 2, seed: int = 0, words: int | None = None,
          k: int | None = None) -> SketchSet:
    """Paper Listing 6 entry point: ProbGraph(g, KIND, s), on the graph's device.

    Traced as the span ``sketch.build`` (``kind``, ``n``, ``width``: words
    or k), fenced on the sketch data."""
    if kind == "bf":
        w = words if words is not None else bloom_words_for_budget(
            graph.n, graph.m, storage_budget)
        with trace.span("sketch.build", kind="bf", n=graph.n,
                        width=w) as sp:
            data = sp.fence(build_bloom(graph, w, num_hashes, seed))
        return SketchSet(data=data, kind="bf", num_hashes=num_hashes, k=0,
                         seed=seed, n=graph.n)
    if kind in ("kh", "1h", "kmv"):
        kk = k if k is not None else minhash_k_for_budget(
            graph.n, graph.m, storage_budget)
        builder = {"kh": build_khash, "1h": build_1hash,
                   "kmv": build_kmv}[kind]
        with trace.span("sketch.build", kind=kind, n=graph.n,
                        width=kk) as sp:
            data = sp.fence(builder(graph, kk, seed))
        return SketchSet(data=data, kind=kind, num_hashes=0, k=kk,
                         seed=seed, n=graph.n)
    raise ValueError(f"unknown sketch kind: {kind}")
