"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Public surface: the entry points in :mod:`repro_torch.kernels.ops`, the
fused set-expression passes in :mod:`repro_torch.kernels.fused_expr`, the
MinHash counts in :mod:`repro_torch.kernels.mh_intersect`, causal attention
in :mod:`repro_torch.kernels.flash_attention`, and the plain versions in
:mod:`repro_torch.kernels.ref`. Kernels are built with nvcc at
first use (:mod:`repro_torch.kernels._build`), never at import.
"""
from typing import Dict

from . import flash_attention, fused_expr, mh_intersect, ops, program, ref
from .fused_expr import fused_gather_popcount, fused_rows_popcount
from .ops import (bf_edge_intersect, bf_edge_intersect3, bf_intersect3_pairs,
                  bf_intersect_pairs, khash_match_gather, khash_match_pairs,
                  mh_intersect_gather, mh_intersect_pairs)


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    return {**fused_expr.LAUNCHES, **mh_intersect.LAUNCHES,
            **flash_attention.LAUNCHES}


def reset_launch_counts() -> None:
    """Set the launch count of every kernel to 0."""
    fused_expr.reset_launch_counts()
    mh_intersect.reset_launch_counts()
    flash_attention.reset_launch_counts()


__all__ = [
    "bf_edge_intersect", "bf_edge_intersect3", "bf_intersect3_pairs",
    "bf_intersect_pairs", "flash_attention", "fused_expr",
    "fused_gather_popcount",
    "fused_rows_popcount", "khash_match_gather", "khash_match_pairs",
    "launch_counts", "mh_intersect", "mh_intersect_gather",
    "mh_intersect_pairs", "ops", "program", "ref",
    "reset_launch_counts",
]
