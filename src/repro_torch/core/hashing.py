"""Hash functions for probabilistic set representations.

The murmur3 ``fmix32`` finalizer on uint32 keys, parameterized by a
per-function seed, bit-identical to ``repro.core.hashing``. torch has no
usable uint32 arithmetic (on the CPU its ``uint32`` lacks shifts and
``index_select``), so every value here is an int64 tensor holding a uint32
in its low 32 bits. Multiplications split the key into 16-bit halves so no
product leaves the int64 range: the low 32 bits come out as uint32
wraparound gives them.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9  # seed spacing (Weyl constant)


def _as_u32(x) -> torch.Tensor:
    """Any integer tensor or scalar -> int64 tensor of its uint32 value."""
    x = torch.as_tensor(x)
    if x.is_floating_point() or x.dtype == torch.bool:
        raise TypeError(f"hash keys must be integers, got {x.dtype}")
    return x.to(torch.int64) & _MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(x) -> torch.Tensor:
    """Murmur3 32-bit finalizer; returns int64 holding the uint32 result."""
    x = _as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def hash_u32(x, seed) -> torch.Tensor:
    """Seeded 32-bit hash of integer keys (``seed`` broadcasts against x)."""
    x = _as_u32(x)
    seed = _as_u32(seed).to(x.device)
    return fmix32(x ^ fmix32((_mul32(seed, _GOLDEN) + 1) & _MASK))


def hash_family(x, num_fns: int, seed) -> torch.Tensor:
    """``num_fns`` hash functions on x: shape ``x.shape + (num_fns,)``."""
    x = _as_u32(x)
    seeds = (torch.arange(num_fns, dtype=torch.int64, device=x.device)
             + _mul32(_as_u32(seed).to(x.device), _GOLDEN)) & _MASK
    return hash_u32(x[..., None], seeds)


def hash_unit_interval(x, seed) -> torch.Tensor:
    """Hash keys to (0, 1] as float32 (for KMV sketches)."""
    h = hash_u32(x, seed)
    return (h.to(torch.float32) + 1.0) * (2.0 ** -32)


# numpy twin (bit-identical) for host-side construction ----------------------

def np_fmix32(x: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`fmix32` on uint32."""
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(_C1)).astype(np.uint32)
        x = x ^ (x >> np.uint32(13))
        x = (x * np.uint32(_C2)).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
    return x


def np_hash_u32(x: np.ndarray, seed: int) -> np.ndarray:
    """numpy twin of :func:`hash_u32` (uint32 result)."""
    x = np.asarray(x, dtype=np.uint32)
    seed = np.uint32(seed)
    with np.errstate(over="ignore"):
        inner = np_fmix32(np.asarray(seed * np.uint32(_GOLDEN) + np.uint32(1),
                                     dtype=np.uint32))
    return np_fmix32(x ^ inner)
