"""Fused set-expression popcount passes over Bloom rows: the CUDA kernels.

Three forms, the port of ``repro.kernels.fused_expr`` (see
``csrc/fused_expr.cu`` for the kernels and their design):

  * :func:`fused_gather_popcount` — per tuple, gather the rows its leaves
    name from the int32[n, W] sketch matrix, evaluate the program, popcount.
  * :func:`fused_rows_popcount` — the same over dense int32[E, W] operands.
    Both run one kernel body, in tiles of tuples per warp, with two row
    sources (:func:`tile_layout` reports its layout).
  * :func:`fused_segment_popcount` — the k-way AND (k = 2..4) of the gather
    form for tuples that come in segments sharing their first k-1 rows,
    which the kernel reads once per segment (the clique passes' launch).

Dispatch follows the tensors: CUDA tensors launch the kernel, CPU tensors
run the plain version in :mod:`repro_torch.kernels.ref`. On CUDA a build
or launch failure raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES`, so a run can show that it went through the kernels, and
one to :data:`FORM_LAUNCHES` under its form and program (``"gather/and2"``
is the reference's 2-way gather kernel ``bf_edge_intersect``,
``"rows/and3"`` its dense ``bf_intersect3_pairs``, ``".../program"`` any
other expression, ``"segment/and3"`` a segmented 3-way AND).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import _build, ref
from .program import MAX_LEAVES, Program

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fused_gather_popcount": 0,
                            "fused_rows_popcount": 0,
                            "fused_segment_popcount": 0}
#: the same launches by form and program (see the module docstring)
FORM_LAUNCHES: Dict[str, int] = {}

#: tiles of 32 tails each warp of the segmented kernel takes
SEGMENT_CHUNK_TILES = 8
#: most segments and tails one segmented launch takes (32-bit positions)
SEGMENT_MAX_COUNT = 1 << 30

_VOIDP = ctypes.c_void_p


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FORM_LAUNCHES.clear()


def _count(name: str, key: str) -> None:
    LAUNCHES[name] += 1
    FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1


def _form(form: str, program: Program) -> str:
    return f"{form}/and{program.and_k}" if program.and_k else f"{form}/program"


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
        lib.pg_fused_segment_popcount.argtypes = [
            _VOIDP, ctypes.c_longlong, ctypes.c_int, _VOIDP, ctypes.c_int,
            ctypes.c_longlong, _VOIDP, ctypes.c_int, _VOIDP,
            ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP]
        lib.pg_fused_segment_popcount.restype = ctypes.c_int
        lib.pg_fused_segment_layout.argtypes = [ctypes.c_int, _VOIDP, _VOIDP]
        lib.pg_fused_segment_layout.restype = None
        lib.pg_fused_tile_layout.argtypes = [ctypes.c_int, _VOIDP, _VOIDP]
        lib.pg_fused_tile_layout.restype = None
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
    _count("fused_gather_popcount", _form("gather", program))
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
    _count("fused_rows_popcount", _form("rows", program))
    return out


def _check_segments(data: torch.Tensor, heads: torch.Tensor,
                    offsets: torch.Tensor, tails: torch.Tensor) -> None:
    """Raise on segment operands the kernel does not take (shapes and
    types only: nothing here reads device memory)."""
    if heads.dtype != torch.int32 or heads.dim() != 2 or \
            not 1 <= heads.shape[1] <= 3:
        raise ValueError(f"heads must be int32[S, k-1] with k in 2..4, got "
                         f"{heads.dtype}{list(heads.shape)}")
    if offsets.dtype not in (torch.int32, torch.int64) or \
            offsets.shape != (heads.shape[0] + 1,):
        raise ValueError(f"offsets must be int32 or int64[S+1] = "
                         f"[{heads.shape[0] + 1}], got "
                         f"{offsets.dtype}{list(offsets.shape)}")
    if tails.dtype != torch.int32 or tails.dim() != 1:
        raise ValueError(f"tails must be int32[T], got "
                         f"{tails.dtype}{list(tails.shape)}")
    if heads.shape[0] == 0 and tails.shape[0] > 0:
        raise ValueError("tails without segments: S = 0 but T > 0")
    if data.dtype != torch.int32 or data.dim() != 2:
        raise ValueError(f"data must be int32[rows, words], got "
                         f"{data.dtype}{list(data.shape)}")


def fused_segment_popcount(data: torch.Tensor, heads: torch.Tensor,
                           offsets: torch.Tensor,
                           tails: torch.Tensor) -> torch.Tensor:
    """popcount(B_heads[s,0] & ... & B_heads[s,k-2] & B_tails[t]) per tail:
    int32[T].

    Args:
      data:    int32[n, W] sketch matrix (uint32 bit patterns).
      heads:   int32[S, k-1], k in 2..4: the rows segment s shares.
      offsets: int32 or int64[S+1], ascending, ``offsets[0] == 0`` and
               ``offsets[S] == T`` (not checked: that would read the
               device); segment s owns ``tails[offsets[s]:offsets[s+1]]``,
               and may be empty.
      tails:   int32[T]: the last row of each tuple.

    Ids outside [0, n) are clamped to the nearest row. The result equals
    :func:`fused_gather_popcount` of the k-way AND over the tuples
    ``cat([heads.repeat_interleave(counts, 0), tails[:, None]], 1)``.
    """
    _check_segments(data, heads, offsets, tails)
    devices = {x.device for x in (data, heads, offsets, tails)}
    if len(devices) > 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")
    if not data.is_cuda:
        return ref.fused_segment_popcount(data, heads, offsets, tails)
    for x, what in ((data, "data"), (heads, "heads"), (offsets, "offsets"),
                    (tails, "tails")):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    n, w = data.shape
    s, t = heads.shape[0], tails.shape[0]
    if max(s, t) > SEGMENT_MAX_COUNT:
        raise ValueError(f"{s} segments and {t} tails: one launch of the "
                         f"kernel takes at most {SEGMENT_MAX_COUNT} of each")
    out = torch.empty(t, dtype=torch.int32, device=data.device)
    if t == 0:
        return out
    if n == 0 or w == 0:
        raise ValueError("data must have at least one row and one word")
    k = heads.shape[1] + 1
    lib = _lib()
    with torch.cuda.device(data.device):
        rc = lib.pg_fused_segment_popcount(
            data.data_ptr(), n, w, heads.data_ptr(), k, s,
            offsets.data_ptr(), offsets.element_size(), tails.data_ptr(), t,
            SEGMENT_CHUNK_TILES, out.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    _check(lib, rc, "fused_segment_popcount")
    _count("fused_segment_popcount", f"segment/and{k}")
    return out


def segment_layout(data: torch.Tensor) -> Dict[str, int]:
    """The layout the segmented kernel picks for ``data`` (a CUDA int32[n,
    W] matrix): words per vector load, lanes per row, cache slots per warp
    and shared memory bytes per block."""
    layout = (ctypes.c_int * 4)()
    _lib().pg_fused_segment_layout(data.shape[1], data.data_ptr(),
                                   ctypes.addressof(layout))
    return dict(zip(("vector_words", "lanes_per_row", "slots",
                     "smem_bytes"), layout))


def tile_layout(data: torch.Tensor) -> Dict[str, int]:
    """The layout the [T, k] gather kernel picks for ``data`` (a CUDA
    int32[n, W] matrix; the dense kernel picks the same for operands with
    the same W and alignment): words per vector load, lanes per row, rows
    per warp step, column blocks, tuples per warp, steps per batch of row
    loads and warps per block."""
    layout = (ctypes.c_int * 7)()
    _lib().pg_fused_tile_layout(data.shape[1], data.data_ptr(),
                                ctypes.addressof(layout))
    return dict(zip(("vector_words", "lanes_per_row", "rows_per_step",
                     "column_blocks", "tuples_per_warp", "steps_per_batch",
                     "warps_per_block"), layout))


__all__ = ["FORM_LAUNCHES", "LAUNCHES", "SEGMENT_CHUNK_TILES",
           "SEGMENT_MAX_COUNT",
           "fused_gather_popcount", "fused_rows_popcount",
           "fused_segment_popcount", "reset_launch_counts", "segment_layout",
           "tile_layout"]
