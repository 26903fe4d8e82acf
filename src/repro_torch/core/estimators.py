"""ProbGraph Bloom estimators of |X| and |X∩Y| (paper §IV).

Batched functions over rows of int32 Bloom matrices (``[..., words]``,
bit patterns of uint32 words). torch has no popcount, so
:func:`_popcount_words` is a SWAR popcount done in int64 on the uint32
value, which keeps every shift logical and every product in range.

Notation maps to the paper: B = total bits, b = #hash functions,
ones = B_{X∩Y,1}. The MinHash and KMV estimators come with a later slice.
"""
from __future__ import annotations

import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount32(w: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (as uint32): int64, same shape."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def _popcount_words(w: torch.Tensor) -> torch.Tensor:
    """Popcount summed over the last (word) axis: int32[...]."""
    return popcount32(w).sum(dim=-1).to(torch.int32)


def bf_size_swamidass(row: torch.Tensor, num_hashes: int) -> torch.Tensor:
    """|X|_S (Eq. 1), with the divergence fix of App. C-3 (ones==B -> ones-1)."""
    total_bits = row.shape[-1] * 32
    ones = _popcount_words(row).to(torch.float32)
    ones = torch.clamp(ones, max=total_bits - 1)
    return -(total_bits / num_hashes) * torch.log1p(-ones / total_bits)


def bf_intersection_and(row_x: torch.Tensor, row_y: torch.Tensor,
                        num_hashes: int) -> torch.Tensor:
    """|X∩Y|_AND (Eq. 2): Swamidass estimator on Bx AND By."""
    return bf_size_swamidass(row_x & row_y, num_hashes)


def bf_intersection_and_from_ones(ones: torch.Tensor, total_bits: int,
                                  num_hashes: int) -> torch.Tensor:
    """Eq. 2 given a precomputed popcount (e.g. from the CUDA kernel)."""
    ones = torch.clamp(ones.to(torch.float32), max=total_bits - 1)
    return -(total_bits / num_hashes) * torch.log1p(-ones / total_bits)


def bf_intersection_limit(row_x: torch.Tensor, row_y: torch.Tensor,
                          num_hashes: int) -> torch.Tensor:
    """|X∩Y|_L (Eq. 4): ones(AND)/b — the B→∞ limit of the AND estimator."""
    return _popcount_words(row_x & row_y).to(torch.float32) / num_hashes


def bf_intersection_or(row_x: torch.Tensor, row_y: torch.Tensor,
                       num_hashes: int, size_x: torch.Tensor,
                       size_y: torch.Tensor) -> torch.Tensor:
    """|X∩Y|_OR (Eq. 29): |X|+|Y| - |X∪Y|_S via OR."""
    union_est = bf_size_swamidass(row_x | row_y, num_hashes)
    return size_x.to(torch.float32) + size_y.to(torch.float32) - union_est
