"""Public Bloom popcount entry points, compiled through ``setexpr``.

Each entry point builds the equivalent set expression and asks
``repro_torch.engine.setexpr`` for the cached compiled form, which runs
the fused CUDA pass for CUDA tensors and the plain PyTorch version for
CPU tensors. The kernels take any row count and width, so nothing is
padded. ``block_e``/``block_w`` are accepted for signature parity with
the reference and ignored. The MinHash entry points come with their
kernels in a later slice.
"""
from __future__ import annotations

import torch


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


__all__ = ["bf_edge_intersect", "bf_edge_intersect3", "bf_intersect_pairs",
           "bf_intersect3_pairs"]
