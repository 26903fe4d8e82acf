"""Public sketch-kernel entry points.

Each Bloom entry point builds the equivalent set expression and asks
``repro_torch.engine.setexpr`` for the cached compiled form, which runs
the fused CUDA pass for CUDA tensors and the plain PyTorch version for
CPU tensors. The MinHash counts, in their rows and gather forms, run the
kernels of :mod:`repro_torch.kernels.mh_intersect` the same way. The
kernels take any row count and width, so nothing is padded. The Bloom
entry points accept ``block_e``/``block_w`` for signature parity with the
reference and ignore them.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import mh_intersect as _mh
from . import ref


def _compiled_and(k: int, x: torch.Tensor, *, block_e: int, block_w: int):
    """The cached compiled k-way AND for the device of ``x`` (lazy engine
    import: ``repro_torch.engine`` imports the kernels package)."""
    from ..engine import setexpr

    return setexpr.compile_expr(setexpr.and_all(*setexpr.rows(k)),
                                block_e=block_e, block_w=block_w,
                                use_kernel=x.is_cuda)


def bf_intersect_pairs(a: torch.Tensor, b: torch.Tensor, *,
                       block_e: int = 256, block_w: int = 512) -> torch.Tensor:
    """Dense AND+popcount: int32[E, W] x int32[E, W] -> int32[E]."""
    return _compiled_and(2, a, block_e=block_e,
                         block_w=block_w).ones_rows(a, b)


def bf_intersect3_pairs(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                        block_e: int = 256, block_w: int = 512
                        ) -> torch.Tensor:
    """Dense 3-way AND+popcount over row-aligned operands -> int32[E]."""
    return _compiled_and(3, a, block_e=block_e,
                         block_w=block_w).ones_rows(a, b, c)


def bf_edge_intersect(bloom: torch.Tensor, edges: torch.Tensor, *,
                      block_e: int = 8, block_w: int = 512) -> torch.Tensor:
    """Gather AND+popcount over an edge list int32[E, 2] -> int32[E]."""
    return _compiled_and(2, bloom, block_e=block_e,
                         block_w=block_w).ones(bloom, edges)


def bf_edge_intersect3(bloom: torch.Tensor, triples: torch.Tensor, *,
                       block_e: int = 8, block_w: int = 512) -> torch.Tensor:
    """3-way gather popcount over (u, v, w) triples (4-clique path)."""
    return _compiled_and(3, bloom, block_e=block_e,
                         block_w=block_w).ones(bloom, triples)


def _minhash_count(name: str, check, args, sentinel: int,
                   use_kernel: Optional[bool]) -> torch.Tensor:
    """Route a MinHash count: ``use_kernel`` None follows the tensors'
    device, True needs CUDA tensors, False runs the plain version."""
    if use_kernel is None:
        use_kernel = args[0].is_cuda
    if not use_kernel:
        check(*args, sentinel)
        return getattr(ref, name)(*args, int(sentinel))
    if not args[0].is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the plain "
                         "PyTorch path is use_kernel=False")
    return getattr(_mh, name)(*args, sentinel)


def mh_intersect_pairs(a: torch.Tensor, b: torch.Tensor, sentinel: int, *,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """MinHash signature match count per row pair -> int32[E]: the (i, j)
    with ``a[i] == b[j]``, both below ``sentinel``."""
    return _minhash_count("mh_intersect_pairs", _mh._check_rows, (a, b),
                          sentinel, use_kernel)


def khash_match_pairs(a: torch.Tensor, b: torch.Tensor, sentinel: int, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Aligned k-Hash match count per row pair -> int32[E]."""
    return _minhash_count("khash_match_pairs", _mh._check_rows, (a, b),
                          sentinel, use_kernel)


def mh_intersect_gather(data: torch.Tensor, pairs: torch.Tensor,
                        sentinel: int, *, use_kernel: Optional[bool] = None
                        ) -> torch.Tensor:
    """:func:`mh_intersect_pairs` of sketch rows ``data[u]``, ``data[v]``
    per pair of int32[E, 2] ``pairs``, read by id -> int32[E]."""
    return _minhash_count("mh_intersect_gather", _mh._check_gather,
                          (data, pairs), sentinel, use_kernel)


def khash_match_gather(data: torch.Tensor, pairs: torch.Tensor,
                       sentinel: int, *, use_kernel: Optional[bool] = None
                       ) -> torch.Tensor:
    """:func:`khash_match_pairs` of sketch rows ``data[u]``, ``data[v]``
    per pair of int32[E, 2] ``pairs``, read by id -> int32[E]."""
    return _minhash_count("khash_match_gather", _mh._check_gather,
                          (data, pairs), sentinel, use_kernel)


__all__ = ["bf_edge_intersect", "bf_edge_intersect3", "bf_intersect_pairs",
           "bf_intersect3_pairs", "khash_match_gather", "khash_match_pairs",
           "mh_intersect_gather", "mh_intersect_pairs"]
