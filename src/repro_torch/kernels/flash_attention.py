"""Causal, optionally windowed, GQA attention forward: the CUDA kernel.

The port of ``repro.kernels.flash_attention`` (see
``csrc/flash_attention.cu`` for the kernel and its design):

  * :func:`flash_attention_folded` — q [BH, Sq, D], k/v [BKV, Skv, D]
    with BH = BKV · groups; query head i reads kv head i // groups.
  * :func:`flash_attention` — the standard layout: q [B, S, H, D], k/v
    [B, Skv, KV, D] -> [B, S, H, D], read through strides (no folded copy).

Scores, softmax and accumulator are float32; the output has the inputs'
type (float32 or bfloat16). Every key is attended: the TPU kernel's
``block_q``/``block_kv``/``interpret`` tiling arguments do not carry over,
and its dropping of a ragged last kv block does not either. Dispatch
follows the tensors: CUDA tensors launch the kernel, CPU tensors run the
plain version in :mod:`repro_torch.kernels.ref`. On CUDA a build or launch
failure raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from . import _build, ref

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

#: largest head dim the kernel takes
MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VOIDP = ctypes.c_void_p


def reset_launch_counts() -> None:
    """Set the launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The kernel library, with its C signatures declared."""
    lib = _build.load("flash_attention")
    if lib.pg_flash_attention.argtypes is None:
        lib.pg_flash_attention.argtypes = (
            [_VOIDP] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, _VOIDP, _VOIDP])
        lib.pg_flash_attention.restype = ctypes.c_int
        lib.pg_flash_error_string.argtypes = [ctypes.c_int]
        lib.pg_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           rank: int) -> None:
    """Type, rank, shape, device and window checks, before any launch."""
    for what, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != rank:
            raise ValueError(f"{what} must have {rank} dims, got "
                             f"{list(x.shape)}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{what} must be float32 or bfloat16, got "
                             f"{x.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if k.shape != v.shape:
        raise ValueError(f"k and v differ in shape: {list(k.shape)} vs "
                         f"{list(v.shape)}")
    d = q.shape[-1]
    if k.shape[-1] != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dims q {d}, k {k.shape[-1]}: both must be "
                         f"equal and in [1, {MAX_HEAD_DIM}]")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(q, k, v, out, *, bh: int, sq: int, skv: int, heads_q: int,
            heads_kv: int, groups: int, window: int, strides) -> None:
    """Launch over tensors whose last dim is contiguous; ``strides`` are
    the (batch, head, position) element strides of q, k, v and out."""
    if sq == 0 or bh == 0:
        return
    if skv == 0:
        raise ValueError("attention needs at least one key")
    d = q.shape[-1]
    lib = _lib()
    arr = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        rc = lib.pg_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], bh, sq, skv, d, heads_q, heads_kv, groups,
            int(window), 1.0 / math.sqrt(d), ctypes.addressof(arr),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"({lib.pg_flash_error_string(rc).decode()})")
    LAUNCHES["flash_attention"] += 1


def _last_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention_folded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, groups: int,
                           window: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D] with BH = BKV · groups; k/v: [BKV, Skv, D] ->
    [BH, Sq, D] in q's dtype."""
    _check(q, k, v, window, 3)
    if groups < 1 or q.shape[0] != k.shape[0] * groups:
        raise ValueError(f"q has {q.shape[0]} heads, k {k.shape[0]}: "
                         f"expected q heads = k heads x groups ({groups})")
    if not q.is_cuda:
        return ref.flash_attention_folded(q, k, v, groups=groups,
                                          window=window)
    q, k, v = (_last_contiguous(x) for x in (q, k, v))
    bh, sq, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, bh=bh, sq=sq, skv=k.shape[1], heads_q=1,
            heads_kv=1, groups=groups, window=window,
            strides=(q.stride(0), 0, q.stride(1), k.stride(0), 0, k.stride(1),
                     v.stride(0), 0, v.stride(1), out.stride(0), 0,
                     out.stride(1)))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Standard layout: q [B, S, H, D], k/v [B, Skv, KV, D] -> [B, S, H, D]
    in q's dtype; H must be a multiple of KV."""
    _check(q, k, v, window, 4)
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or kvh < 1 or h % kvh:
        raise ValueError(f"q [B={b}, H={h}] and k [B={k.shape[0]}, "
                         f"KV={kvh}]: batches must match and H divide by KV")
    if not q.is_cuda:
        return ref.causal_attention(q, k, v, window)
    q, k, v = (_last_contiguous(x) for x in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, bh=b * h, sq=sq, skv=k.shape[1], heads_q=h,
            heads_kv=kvh, groups=h // kvh, window=window,
            strides=(q.stride(0), q.stride(2), q.stride(1),
                     k.stride(0), k.stride(2), k.stride(1),
                     v.stride(0), v.stride(2), v.stride(1),
                     out.stride(0), out.stride(2), out.stride(1)))
    return out


__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "flash_attention",
           "flash_attention_folded", "reset_launch_counts"]
