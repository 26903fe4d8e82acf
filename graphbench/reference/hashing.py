"""Seeded murmur3 ``fmix32`` hashing of uint32 keys, as ProbGraph sketches use.

Values are int64 tensors holding a uint32 in their low 32 bits; products
are split into 16-bit halves so that none leaves the int64 range.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = mul32(x, C1)
    x = x ^ (x >> 13)
    x = mul32(x, C2)
    return x ^ (x >> 16)


def function_seeds(count: int, seed: int) -> list:
    """The per-function seeds ``(i + seed·GOLDEN) mod 2**32`` of a family."""
    base = ((seed & MASK) * GOLDEN) & MASK
    return [(i + base) & MASK for i in range(count)]


def hash_u32(x: torch.Tensor, fn_seed: int) -> torch.Tensor:
    """Hash of int64 keys ``x`` (uint32 range) under one function seed."""
    inner = fmix32(torch.tensor(((fn_seed * GOLDEN) + 1) & MASK,
                                dtype=torch.int64, device=x.device))
    return fmix32((x & MASK) ^ inner)
