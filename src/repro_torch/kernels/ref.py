"""Plain PyTorch versions of the CUDA kernels (their oracles).

The CPU path of every wrapper in :mod:`repro_torch.kernels.fused_expr` and
:mod:`repro_torch.kernels.mh_intersect` runs these, and the tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card. Bloom
rows are int32 bit patterns; integer results are exact.
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


#: compare cells (rows × k × k) one chunk of the plain MinHash count holds
_MH_CHUNK_CELLS = 1 << 26


def mh_intersect_pairs(a: torch.Tensor, b: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """Count of (i, j) with ``a[i] == b[j]``, both below ``sentinel``, per
    row of int32[E, k] x int32[E, k] -> int32[E].

    Duplicates count with multiplicity, so for duplicate-free rows this is
    |set(a) ∩ set(b)|. Rows go in chunks of at most ``_MH_CHUNK_CELLS``
    compares, which bounds the k² temporaries.
    """
    e, k = a.shape
    out = torch.zeros(e, dtype=torch.int32, device=a.device)
    step = max(1, _MH_CHUNK_CELLS // max(k * k, 1))
    for s in range(0, e, step):
        x, y = a[s:s + step], b[s:s + step]
        eq = x[:, :, None] == y[:, None, :]
        valid = (x[:, :, None] < sentinel) & (y[:, None, :] < sentinel)
        out[s:s + step] = torch.sum(eq & valid, dim=(1, 2), dtype=torch.int32)
    return out


def khash_match_pairs(a: torch.Tensor, b: torch.Tensor,
                      sentinel: int) -> torch.Tensor:
    """Aligned (per-hash-function) match count for k-Hash sketches:
    positions with ``a == b`` and both below ``sentinel`` -> int32[E]."""
    return torch.sum((a == b) & (a < sentinel) & (b < sentinel), dim=-1,
                     dtype=torch.int32)
