"""Set-intersection counts of sketch rows: the popcount of ANDed Bloom
words and the aligned matches of k-Hash rows."""
from __future__ import annotations

import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of int32[..., W] (as uint32): int64[...].

    A SWAR count in int32 (its first subtraction wraps as uint32
    arithmetic does), reduced to per-byte counts; the byte counts of 8
    words at a time (at most 64 a byte) are summed before the bytes are
    folded.
    """
    x = words - ((words >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    pad = (-x.shape[-1]) % 8
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], -1, 8).sum(-1, dtype=torch.int32)
    x = (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + (x >> 24)
    return x.sum(-1, dtype=torch.int64)


def and_popcount(data: torch.Tensor, *ids: torch.Tensor) -> torch.Tensor:
    """popcount(AND of the rows ``data[ids[0]], data[ids[1]], ...``):
    int64, one per position of the id tensors."""
    acc = data[ids[0]]
    for i in ids[1:]:
        acc = acc & data[i]
    return popcount_rows(acc)


def khash_matches(data: torch.Tensor, n: int, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Hash functions whose minimum is the same element (not the empty
    row's sentinel ``n``) in the k-Hash rows of a and of b: int64."""
    ra, rb = data[a], data[b]
    return ((ra == rb) & (ra < n)).sum(-1, dtype=torch.int64)
