"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Public surface: the entry points in :mod:`repro_torch.kernels.ops`, the
fused set-expression passes in :mod:`repro_torch.kernels.fused_expr`, and
the plain versions in :mod:`repro_torch.kernels.ref`. Kernels are built
with nvcc at first use (:mod:`repro_torch.kernels._build`), never at import.
"""
from . import fused_expr, ops, program, ref
from .fused_expr import (LAUNCHES, fused_gather_popcount, fused_rows_popcount,
                         reset_launch_counts)
from .ops import (bf_edge_intersect, bf_edge_intersect3, bf_intersect3_pairs,
                  bf_intersect_pairs)

__all__ = [
    "LAUNCHES", "bf_edge_intersect", "bf_edge_intersect3",
    "bf_intersect3_pairs", "bf_intersect_pairs", "fused_expr",
    "fused_gather_popcount", "fused_rows_popcount", "ops", "program", "ref",
    "reset_launch_counts",
]
