"""MinHash sketch intersection counts: the CUDA kernels.

Two kernels, the port of ``repro.kernels.mh_intersect`` (see
``csrc/mh_intersect.cu`` for the kernels and their design):

  * :func:`mh_intersect_pairs` — per row pair of sentinel-padded
    int32[E, k] 1-Hash rows, the count of equal valid entry pairs (k²
    compares, duplicates with multiplicity).
  * :func:`khash_match_pairs` — per row pair of k-Hash rows, the count of
    aligned equal valid positions.

An entry is valid when it is below ``sentinel`` (signed). Dispatch follows
the tensors: CUDA tensors launch the kernel, CPU tensors run the plain
version in :mod:`repro_torch.kernels.ref`. On CUDA a build or launch
failure raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build, ref

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"mh_intersect_pairs": 0, "khash_match_pairs": 0}

_VOIDP = ctypes.c_void_p
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The kernel library, with every entry point's C signature declared."""
    lib = _build.load("mh_intersect")
    if lib.pg_mh_intersect_pairs.argtypes is None:
        for fn in (lib.pg_mh_intersect_pairs, lib.pg_khash_match_pairs):
            fn.argtypes = [_VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _VOIDP, _VOIDP]
            fn.restype = ctypes.c_int
        lib.pg_mh_error_string.argtypes = [ctypes.c_int]
        lib.pg_mh_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(a: torch.Tensor, b: torch.Tensor, sentinel: int) -> None:
    """Dtype, shape, device and sentinel checks, made before any launch."""
    for what, x in (("a", a), ("b", b)):
        if x.dtype != torch.int32 or x.dim() != 2:
            raise ValueError(f"{what} must be int32[E, k], got "
                             f"{x.dtype}{list(x.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"a and b differ in shape: {list(a.shape)} vs "
                         f"{list(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device} but b on {b.device}")
    if not _INT32_MIN <= int(sentinel) <= _INT32_MAX:
        raise ValueError(f"sentinel {sentinel} is outside the int32 range")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            sentinel: int) -> torch.Tensor:
    _check_rows(a, b, sentinel)
    if not a.is_cuda:
        return getattr(ref, name)(a, b, int(sentinel))
    a, b = a.contiguous(), b.contiguous()
    e, k = a.shape
    out = torch.zeros(e, dtype=torch.int32, device=a.device)
    if e == 0 or k == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = getattr(lib, f"pg_{name}")(
            a.data_ptr(), b.data_ptr(), e, k, int(sentinel), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.pg_mh_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return out


def mh_intersect_pairs(a: torch.Tensor, b: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """int32[E, k] x int32[E, k] -> int32[E]: per row, the count of (i, j)
    with ``a[i] == b[j]`` and both below ``sentinel``."""
    return _launch("mh_intersect_pairs", a, b, sentinel)


def khash_match_pairs(a: torch.Tensor, b: torch.Tensor,
                      sentinel: int) -> torch.Tensor:
    """int32[E, k] x int32[E, k] -> int32[E]: per row, the count of
    positions with ``a == b`` and both below ``sentinel``."""
    return _launch("khash_match_pairs", a, b, sentinel)


__all__ = ["LAUNCHES", "khash_match_pairs", "mh_intersect_pairs",
           "reset_launch_counts"]
