"""Plain PyTorch versions of the popcount kernels (their oracles).

The CPU path of every wrapper in :mod:`repro_torch.kernels.fused_expr`
runs these, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against them on the card. Sketch rows are int32 bit patterns; integer
results are exact.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.estimators import _popcount_words
from .program import Program, eval_program


def gather_rows(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``data[ids]``, with ids clamped to ``[0, n)`` as the kernels do."""
    return data.index_select(0, ids.long().clamp(0, data.shape[0] - 1))


def fused_gather_popcount(data: torch.Tensor, tuples: torch.Tensor,
                          program: Program) -> torch.Tensor:
    """popcount(program(rows of each tuple)): int32[T].

    ``data`` is int32[n, W]; ``tuples`` int32[T, k], leaf j reading column
    ``program.slots[j]``.
    """
    leaves = [gather_rows(data, tuples[:, s]) for s in program.slots]
    return _popcount_words(eval_program(program, leaves))


def fused_rows_popcount(rows: Sequence[torch.Tensor],
                        program: Program) -> torch.Tensor:
    """popcount(program(dense operand rows)): int32[E], one int32[E, W]
    operand per leaf."""
    return _popcount_words(eval_program(program, list(rows)))


def bf_intersect_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a AND b) summed over words. a, b: int32[E, W] -> int32[E]."""
    return _popcount_words(a & b)


def bf_union_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a OR b) summed over words (for the OR estimator)."""
    return _popcount_words(a | b)


def bf_intersect3_pairs(a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """popcount(a AND b AND c) (4-clique triple intersections)."""
    return _popcount_words(a & b & c)


def bf_edge_intersect(bloom: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Gather rows u, v from bloom[n, W] per edge and AND-popcount."""
    return bf_intersect_pairs(gather_rows(bloom, edges[:, 0]),
                              gather_rows(bloom, edges[:, 1]))


def bf_edge_intersect3(bloom: torch.Tensor,
                       triples: torch.Tensor) -> torch.Tensor:
    """Gather rows u, v, w from bloom[n, W] per triple and AND-popcount."""
    return bf_intersect3_pairs(gather_rows(bloom, triples[:, 0]),
                               gather_rows(bloom, triples[:, 1]),
                               gather_rows(bloom, triples[:, 2]))
