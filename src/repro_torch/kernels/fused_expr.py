"""Fused set-expression popcount passes over Bloom rows: the CUDA kernels.

Two forms, the port of ``repro.kernels.fused_expr`` (see
``csrc/fused_expr.cu`` for the kernels and their design):

  * :func:`fused_gather_popcount` — per tuple, gather the rows its leaves
    name from the int32[n, W] sketch matrix, evaluate the program, popcount.
  * :func:`fused_rows_popcount` — the same over dense int32[E, W] operands.

Dispatch follows the tensors: CUDA tensors launch the kernel, CPU tensors
run the plain version in :mod:`repro_torch.kernels.ref`. On CUDA a build
or launch failure raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES`, so a run can show that it went through the kernels, and
one to :data:`FORM_LAUNCHES` under its form and program (``"gather/and2"``
is the reference's 2-way gather kernel ``bf_edge_intersect``,
``"rows/and3"`` its dense ``bf_intersect3_pairs``, ``".../program"`` any
other expression).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import _build, ref
from .program import MAX_LEAVES, Program

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fused_gather_popcount": 0,
                            "fused_rows_popcount": 0}
#: the same launches by form and program (see the module docstring)
FORM_LAUNCHES: Dict[str, int] = {}

_VOIDP = ctypes.c_void_p


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FORM_LAUNCHES.clear()


def _count(name: str, form: str, program: Program) -> None:
    LAUNCHES[name] += 1
    key = f"{form}/and{program.and_k}" if program.and_k else f"{form}/program"
    FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1


def _lib() -> ctypes.CDLL:
    """The kernel library, with every entry point's C signature declared."""
    lib = _build.load("fused_expr")
    if lib.pg_fused_gather_popcount.argtypes is None:
        lib.pg_fused_gather_popcount.argtypes = [
            _VOIDP, ctypes.c_longlong, ctypes.c_int, _VOIDP,
            ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP]
        lib.pg_fused_gather_popcount.restype = ctypes.c_int
        lib.pg_fused_rows_popcount.argtypes = [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _VOIDP,
            _VOIDP, _VOIDP]
        lib.pg_fused_rows_popcount.restype = ctypes.c_int
        lib.pg_error_string.argtypes = [ctypes.c_int]
        lib.pg_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.pg_error_string(rc).decode()})")


def _check_words(x: torch.Tensor, what: str, device: torch.device) -> None:
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"{what} must be int32[rows, words], got "
                         f"{x.dtype}{list(x.shape)}")
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def fused_gather_popcount(data: torch.Tensor, tuples: torch.Tensor,
                          program: Program) -> torch.Tensor:
    """popcount(program(rows of each tuple)) per tuple: int32[T].

    Args:
      data:    int32[n, W] sketch matrix (uint32 bit patterns).
      tuples:  int32[T, k] row ids; leaf j reads column ``program.slots[j]``.
               Ids outside [0, n) are clamped to the nearest row.
      program: the compiled expression.
    """
    if tuples.dtype != torch.int32 or tuples.dim() != 2:
        raise ValueError(f"tuples must be int32[T, k], got "
                         f"{tuples.dtype}{list(tuples.shape)}")
    if tuples.shape[1] <= max(program.slots):
        raise ValueError(f"program reads tuple column {max(program.slots)} "
                         f"but tuples have width {tuples.shape[1]}")
    if not data.is_cuda:
        if tuples.is_cuda:
            raise ValueError("data is on the CPU but tuples on CUDA")
        return ref.fused_gather_popcount(data, tuples, program)
    _check_words(data, "data", data.device)
    tuples = tuples.contiguous()
    if tuples.device != data.device:
        raise ValueError(f"tuples are on {tuples.device}, data on {data.device}")
    n, w = data.shape
    t = tuples.shape[0]
    out = torch.empty(t, dtype=torch.int32, device=data.device)
    if t == 0:
        return out
    if n == 0 or w == 0:
        raise ValueError("data must have at least one row and one word")
    lib = _lib()
    packed = program.packed()          # kept alive across the call
    with torch.cuda.device(data.device):
        rc = lib.pg_fused_gather_popcount(
            data.data_ptr(), n, w, tuples.data_ptr(), t, tuples.shape[1],
            ctypes.addressof(packed), out.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    _check(lib, rc, "fused_gather_popcount")
    _count("fused_gather_popcount", "gather", program)
    return out


def fused_rows_popcount(rows: Sequence[torch.Tensor],
                        program: Program) -> torch.Tensor:
    """popcount(program(dense operand rows)) per row: int32[E].

    Args:
      rows:    one int32[E, W] operand per leaf, in leaf order.
      program: the compiled expression.
    """
    rows = list(rows)
    if len(rows) != program.n_leaves:
        raise ValueError(f"program has {program.n_leaves} leaves, got "
                         f"{len(rows)} operand matrices")
    shape = rows[0].shape
    if any(r.shape != shape for r in rows):
        raise ValueError("operand matrices differ in shape")
    if not rows[0].is_cuda:
        if any(r.is_cuda for r in rows):
            raise ValueError("operands mix CPU and CUDA tensors")
        return ref.fused_rows_popcount(rows, program)
    for j, r in enumerate(rows):
        _check_words(r, f"rows[{j}]", rows[0].device)
    e, w = shape
    dev = rows[0].device
    out = torch.empty(e, dtype=torch.int32, device=dev)
    if e == 0:
        return out
    if w == 0:
        raise ValueError("operands must have at least one word")
    ptrs = (_VOIDP * MAX_LEAVES)(*[r.data_ptr() for r in rows])
    packed = program.packed()
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.pg_fused_rows_popcount(
            ctypes.addressof(ptrs), len(rows), e, w,
            ctypes.addressof(packed), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, rc, "fused_rows_popcount")
    _count("fused_rows_popcount", "rows", program)
    return out


__all__ = ["FORM_LAUNCHES", "LAUNCHES", "fused_gather_popcount",
           "fused_rows_popcount", "reset_launch_counts"]
