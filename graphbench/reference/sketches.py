"""Bloom filter and k-Hash MinHash rows of every vertex's neighbourhood
(ProbGraph §II-D), and their sizes under a storage budget (§V-A)."""
from __future__ import annotations

import math

import torch

from .graph import RefGraph
from .hashing import function_seeds, hash_u32

#: CSR entries hashed at once by the k-Hash build
_ENTRY_BLOCK = 1 << 26


def bloom_words(n: int, m: int, budget: float) -> int:
    """32-bit words a Bloom row takes so that all rows hold about
    ``budget`` times the bits of the CSR ((2m + n + 1) 32-bit words);
    at least 2, rounded up to an even count."""
    bits = max(1.0, budget * (2 * m + n + 1) * 32 / max(n, 1))
    words = max(int(math.ceil(bits / 32.0)), 2)
    return words + words % 2


def khash_k(n: int, m: int, budget: float) -> int:
    """Hash functions of a k-Hash row under the same budget, at least 4."""
    return max(4, int(math.floor(budget * (2 * m + n + 1) / max(n, 1))))


def to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 of the same bit pattern."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def bloom_positions(keys: torch.Tensor, num_hashes: int, total_bits: int,
                    seed: int) -> torch.Tensor:
    """int64[..., num_hashes]: the bit each hash function sets for a key."""
    return torch.stack([hash_u32(keys, s) % total_bits
                        for s in function_seeds(num_hashes, seed)], dim=-1)


def bloom(g: RefGraph, words: int, num_hashes: int, seed: int
          ) -> torch.Tensor:
    """int32[rows, words]: bit ``h_i(w) mod 32·words`` set in row v for
    every neighbour w of v and hash function i (bit j of word q is element
    32q + j), as int32 bit patterns of uint32 words; the rows ``g`` holds
    (every vertex's, or a range graph's)."""
    total_bits = 32 * words
    rows = g.deg.numel()
    pos = bloom_positions(g.indices, num_hashes, total_bits, seed)
    bit = torch.unique((g.rows() - g.lo)[:, None] * total_bits + pos)
    acc = torch.zeros(rows * words, dtype=torch.int64, device=bit.device)
    acc.index_add_(0, bit >> 5, torch.ones_like(bit) << (bit & 31))
    return to_int32_bits(acc).view(rows, words)


def khash(g: RefGraph, k: int, seed: int) -> torch.Tensor:
    """int32[n, k]: per hash function, the neighbour of least hash (the
    least id among equal hashes); ``n`` for a vertex without neighbours."""
    rows = g.rows()
    out = torch.full((g.n, k), g.n, dtype=torch.int32, device=rows.device)
    for i, s in enumerate(function_seeds(k, seed)):
        best = torch.full((g.n,), (1 << 63) - 1, dtype=torch.int64,
                          device=rows.device)
        for lo in range(0, g.indices.numel(), _ENTRY_BLOCK):
            elem = g.indices[lo:lo + _ENTRY_BLOCK]
            key = (hash_u32(elem, s) << 31) | elem
            best.scatter_reduce_(0, rows[lo:lo + _ENTRY_BLOCK], key, "amin")
        has = g.deg > 0
        out[has, i] = (best[has] & ((1 << 31) - 1)).to(torch.int32)
    return out


__all__ = ["bloom", "bloom_positions", "bloom_words", "khash",
           "khash_k", "to_int32_bits"]
