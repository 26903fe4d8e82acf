"""MinHash sketch intersection counts: the CUDA kernels.

Two counts, the port of ``repro.kernels.mh_intersect`` (see
``csrc/mh_intersect.cu`` for the kernels and their design):

  * :func:`mh_intersect_pairs` — per row pair of sentinel-padded
    int32[E, k] 1-Hash rows, the count of equal valid entry pairs (k²
    compares, duplicates with multiplicity).
  * :func:`khash_match_pairs` — per row pair of k-Hash rows, the count of
    aligned equal valid positions.

Each has two forms: the rows form above (the TPU kernels' signature) and
a gather form, :func:`mh_intersect_gather` / :func:`khash_match_gather`,
that takes the sketch matrix int32[n, k] and pairs int32[E, 2] and reads
each pair's rows from the matrix by id (ids clamped to ``[0, n)``), so
the caller copies no rows.

An entry is valid when it is below ``sentinel`` (signed). Dispatch follows
the tensors: CUDA tensors launch the kernel, CPU tensors run the plain
version in :mod:`repro_torch.kernels.ref`. On CUDA a build or launch
failure raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES` under its count (both forms) and to
:data:`FORM_LAUNCHES` under ``"<count>/rows"`` or ``"<count>/gather"``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build, ref

#: kernel launches per count (both forms) since the last
#: :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"mh_intersect_pairs": 0, "khash_match_pairs": 0}
#: the same launches by form, ``"<count>/rows"`` and ``"<count>/gather"``
FORM_LAUNCHES: Dict[str, int] = {}

_VOIDP = ctypes.c_void_p
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FORM_LAUNCHES.clear()


def _lib() -> ctypes.CDLL:
    """The kernel library, with every entry point's C signature declared."""
    lib = _build.load("mh_intersect")
    if lib.pg_mh_intersect_pairs.argtypes is None:
        for fn in (lib.pg_mh_intersect_pairs, lib.pg_khash_match_pairs):
            fn.argtypes = [_VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _VOIDP, _VOIDP]
            fn.restype = ctypes.c_int
        for fn in (lib.pg_mh_intersect_gather, lib.pg_khash_match_gather):
            fn.argtypes = [_VOIDP, ctypes.c_longlong, _VOIDP,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           _VOIDP, _VOIDP]
            fn.restype = ctypes.c_int
        lib.pg_mh_error_string.argtypes = [ctypes.c_int]
        lib.pg_mh_error_string.restype = ctypes.c_char_p
    return lib


def _check_sentinel(sentinel: int) -> None:
    if not _INT32_MIN <= int(sentinel) <= _INT32_MAX:
        raise ValueError(f"sentinel {sentinel} is outside the int32 range")


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
    _check_sentinel(sentinel)


def _check_gather(data: torch.Tensor, pairs: torch.Tensor,
                  sentinel: int) -> None:
    """The gather form's checks, made before any launch."""
    if data.dtype != torch.int32 or data.dim() != 2:
        raise ValueError(f"data must be int32[n, k], got "
                         f"{data.dtype}{list(data.shape)}")
    if pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"pairs must be int32[E, 2], got "
                         f"{pairs.dtype}{list(pairs.shape)}")
    if data.device != pairs.device:
        raise ValueError(f"data is on {data.device} but pairs on "
                         f"{pairs.device}")
    if data.shape[0] == 0 and pairs.shape[0]:
        raise ValueError("pairs index rows of a matrix with no rows")
    _check_sentinel(sentinel)


def _run(name: str, form: str, ptrs, e: int, k: int,
         device: torch.device) -> torch.Tensor:
    """Launch ``pg_<entry>`` over ``e`` pairs and count it; E or k of 0
    launches nothing. The kernels write every count, so ``out`` starts
    uninitialised."""
    if e == 0 or k == 0:
        return torch.zeros(e, dtype=torch.int32, device=device)
    out = torch.empty(e, dtype=torch.int32, device=device)
    lib = _lib()
    entry = name if form == "rows" else name.replace("_pairs", "_gather")
    with torch.cuda.device(device):
        rc = getattr(lib, f"pg_{entry}")(
            *ptrs, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} "
                           f"({lib.pg_mh_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    key = f"{name}/{form}"
    FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1
    return out


def _rows(name: str, a: torch.Tensor, b: torch.Tensor,
          sentinel: int) -> torch.Tensor:
    _check_rows(a, b, sentinel)
    if not a.is_cuda:
        return getattr(ref, name)(a, b, int(sentinel))
    a, b = a.contiguous(), b.contiguous()
    e, k = a.shape
    return _run(name, "rows", (a.data_ptr(), b.data_ptr(), e, k,
                               int(sentinel)), e, k, a.device)


def _gather(name: str, data: torch.Tensor, pairs: torch.Tensor,
            sentinel: int) -> torch.Tensor:
    _check_gather(data, pairs, sentinel)
    if not data.is_cuda:
        return getattr(ref, name.replace("_pairs", "_gather"))(
            data, pairs, int(sentinel))
    data, pairs = data.contiguous(), pairs.contiguous()
    (n, k), e = data.shape, pairs.shape[0]
    return _run(name, "gather", (data.data_ptr(), n, pairs.data_ptr(), e,
                                 k, int(sentinel)), e, k, data.device)


def mh_intersect_pairs(a: torch.Tensor, b: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """int32[E, k] x int32[E, k] -> int32[E]: per row, the count of (i, j)
    with ``a[i] == b[j]`` and both below ``sentinel``."""
    return _rows("mh_intersect_pairs", a, b, sentinel)


def khash_match_pairs(a: torch.Tensor, b: torch.Tensor,
                      sentinel: int) -> torch.Tensor:
    """int32[E, k] x int32[E, k] -> int32[E]: per row, the count of
    positions with ``a == b`` and both below ``sentinel``."""
    return _rows("khash_match_pairs", a, b, sentinel)


def mh_intersect_gather(data: torch.Tensor, pairs: torch.Tensor,
                        sentinel: int) -> torch.Tensor:
    """int32[n, k] sketch, int32[E, 2] pairs -> int32[E]:
    :func:`mh_intersect_pairs` of rows ``data[u]``, ``data[v]`` per pair
    (u, v), ids clamped to ``[0, n)``."""
    return _gather("mh_intersect_pairs", data, pairs, sentinel)


def khash_match_gather(data: torch.Tensor, pairs: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """int32[n, k] sketch, int32[E, 2] pairs -> int32[E]:
    :func:`khash_match_pairs` of rows ``data[u]``, ``data[v]`` per pair
    (u, v), ids clamped to ``[0, n)``."""
    return _gather("khash_match_pairs", data, pairs, sentinel)


__all__ = ["FORM_LAUNCHES", "LAUNCHES", "khash_match_gather",
           "khash_match_pairs", "mh_intersect_gather", "mh_intersect_pairs",
           "reset_launch_counts"]
