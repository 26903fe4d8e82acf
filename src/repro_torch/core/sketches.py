"""Probabilistic set representations of vertex neighborhoods (ProbGraph §II-D).

This slice ports the Bloom filter: ``int32[n, words]`` per-vertex rows
(``B = 32*words`` bits, ``b`` hash functions), stored as int32 bit patterns
of the reference's uint32 words. The builder reads the CSR arrays, never
the padded adjacency, so it runs at sizes where ``adj`` cannot exist. Its
words are bit-identical to ``repro.core.sketches.build_bloom``.

The k-Hash, 1-Hash and KMV sketches come with a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import Graph
from .hashing import _GOLDEN, _MASK, hash_family, np_hash_u32

_SHIFTS = tuple(range(32))

#: bool bits a Bloom build chunk may hold at once (256 MiB)
_CHUNK_BITS = 1 << 28


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
    dev = indices.device
    bits = torch.zeros(rows * total_bits, dtype=torch.bool, device=dev)
    counts = (indptr[1:] - indptr[:-1]).to(torch.int64)
    row = torch.repeat_interleave(torch.arange(rows, device=dev), counts)
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
    n = graph.n
    total_bits = words * 32
    out = torch.empty((n, words), dtype=torch.int32, device=graph.device)
    if n == 0:
        return out
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    entry_cap = max(1, chunk_bits // (4 * max(num_hashes, 1)))
    row_cap = max(1, chunk_bits // total_bits)
    start = 0
    while start < n:
        stop = min(n, start + row_cap)
        limit = indptr[start] + entry_cap
        fit = int(np.searchsorted(indptr, limit, side="right")) - 1
        stop = max(start + 1, min(stop, fit))
        ptr = graph.indptr[start:stop + 1]
        out[start:stop] = bloom_rows(
            ptr, graph.indices[int(indptr[start]):int(indptr[stop])],
            words, num_hashes, seed)
        start = stop
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


@dataclasses.dataclass(frozen=True)
class SketchSet:
    """A named bundle of sketches for one graph (the paper's Listing 6
    ``ProbGraph(g, KIND, s)``). ``data`` is int32[n, words] for Bloom."""

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
    """Paper Listing 6 entry point: ProbGraph(g, KIND, s), on the graph's device."""
    if kind == "bf":
        w = words if words is not None else bloom_words_for_budget(
            graph.n, graph.m, storage_budget)
        return SketchSet(data=build_bloom(graph, w, num_hashes, seed),
                         kind="bf", num_hashes=num_hashes, k=0, seed=seed,
                         n=graph.n)
    if kind in ("kh", "1h", "kmv"):
        raise NotImplementedError(
            f"sketch kind {kind!r} is not ported yet; only 'bf' is")
    raise ValueError(f"unknown sketch kind: {kind}")
