"""Causal, optionally windowed, GQA attention forward: the CUDA kernels.

The port of ``repro.kernels.flash_attention``, by two routes that follow
the inputs' type:

  * bfloat16: ``csrc/flash_attention_wgmma.cu``, both products on the
    tensor cores (wgmma), K/V fed by TMA through a warp-specialised
    pipeline; P is rounded to bfloat16 before P·V, as in every
    tensor-core flash attention (the source's note bounds the error);
  * float32: ``csrc/flash_attention.cu``, both products in fp32 on the
    CUDA cores, for the reference's fp32 parity.

Entry points:

  * :func:`flash_attention_folded` — q [BH, Sq, D], k/v [BKV, Skv, D]
    with BH = BKV · groups; query head i reads kv head i // groups.
  * :func:`flash_attention` — the standard layout: q [B, S, H, D], k/v
    [B, Skv, KV, D] -> [B, S, H, D], read through strides (no folded copy).

Scores, softmax and accumulator are float32; the output has the inputs'
type (float32 or bfloat16). Every key is attended: the TPU kernel's
``block_q``/``block_kv``/``interpret`` tiling arguments do not carry over,
and its dropping of a ragged last kv block does not either. Dispatch
follows the tensors: CUDA tensors launch a kernel, CPU tensors run the
plain version in :mod:`repro_torch.kernels.ref`. On CUDA a build,
tensor-map or launch failure raises; nothing falls back. Each launch adds
one to :data:`LAUNCHES` and one to its route in :data:`ROUTE_LAUNCHES`.

TMA reads the bfloat16 inputs in place when their head dim is a multiple
of 8 and their base and strides are multiples of 16 bytes; an input that
breaks that is first copied, contiguous and zero-padded to a multiple of
8 in D (:func:`tma_operand`), and the output is cut back to D.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import _build, ref

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
#: the same launches by route: the bfloat16 tensor-core kernel and the
#: float32 CUDA-core kernel
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma_bf16": 0, "fma_fp32": 0}

#: largest head dim the kernel takes
MAX_HEAD_DIM = 256

_VOIDP = ctypes.c_void_p
#: dtype -> (route, library, entry point, error-string function)
_ROUTES = {
    torch.bfloat16: ("wgmma_bf16", "flash_attention_wgmma",
                     "pg_flash_attention_wgmma", "pg_flash_wgmma_error_string"),
    torch.float32: ("fma_fp32", "flash_attention", "pg_flash_attention",
                    "pg_flash_error_string"),
}
#: TMA's rule for a tensor read in place: base and strides 16-byte aligned
_TMA_ALIGN = 16


def reset_launch_counts() -> None:
    """Set the launch counts to 0."""
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _lib(dtype: torch.dtype):
    """The route's name, entry point and error-string function, with their
    C signatures declared."""
    route, name, entry, errors = _ROUTES[dtype]
    lib = _build.load(name)
    fn, err = getattr(lib, entry), getattr(lib, errors)
    if fn.argtypes is None:
        fn.argtypes = ([_VOIDP] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, _VOIDP, _VOIDP])
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return route, fn, err


def tma_ready(x: torch.Tensor) -> bool:
    """Whether TMA can read ``x`` in place: the last dim contiguous and 16
    bytes a multiple of its length, the base and the stride of every
    longer-than-1 dim a positive multiple of 16 bytes."""
    size = x.element_size()
    if (x.stride(-1) != 1 or x.shape[-1] * size % _TMA_ALIGN
            or x.data_ptr() % _TMA_ALIGN):
        return False
    return all(st > 0 and st * size % _TMA_ALIGN == 0
               for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1)


def tma_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the tensor-core kernel reads it: itself when
    :func:`tma_ready`, else a contiguous copy in fresh (aligned) memory
    whose last dim is zero-padded to a multiple of 16 bytes (layout
    preparation, not a fallback)."""
    if tma_ready(x):
        return x
    pad = -x.shape[-1] % (_TMA_ALIGN // x.element_size())
    return F.pad(x, (0, pad)) if pad else x.clone(
        memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           rank: int) -> None:
    """Type, rank, shape, device and window checks, before any launch."""
    for what, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != rank:
            raise ValueError(f"{what} must have {rank} dims, got "
                             f"{list(x.shape)}")
        if x.dtype not in _ROUTES:
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
            heads_kv: int, groups: int, window: int, head_dim: int,
            strides) -> None:
    """Launch the dtype's kernel over prepared tensors (:func:`_operands`);
    ``strides`` are the (batch, head, position) element strides of q, k, v
    and out, ``head_dim`` the true D that sets the scale."""
    if sq == 0 or bh == 0:
        return
    if skv == 0:
        raise ValueError("attention needs at least one key")
    route, fn, err = _lib(q.dtype)
    arr = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, sq, skv, q.shape[-1], heads_q, heads_kv, groups,
                int(window), 1.0 / math.sqrt(head_dim), ctypes.addressof(arr),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}) launch failed: error "
                           f"{rc} ({err(rc).decode()})")
    LAUNCHES["flash_attention"] += 1
    ROUTE_LAUNCHES[route] += 1


def _operands(q, k, v):
    """q, k, v as the dtype's kernel reads them: TMA operands for
    bfloat16, a contiguous last dim for float32."""
    if q.dtype == torch.bfloat16:
        return tuple(tma_operand(x) for x in (q, k, v))
    return tuple(x if x.stride(-1) == 1 else x.contiguous()
                 for x in (q, k, v))


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
    d = q.shape[-1]
    q, k, v = _operands(q, k, v)
    bh, sq, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, bh=bh, sq=sq, skv=k.shape[1], heads_q=1,
            heads_kv=1, groups=groups, window=window, head_dim=d,
            strides=(q.stride(0), 0, q.stride(1), k.stride(0), 0, k.stride(1),
                     v.stride(0), 0, v.stride(1), out.stride(0), 0,
                     out.stride(1)))
    return out if out.shape[-1] == d else out[..., :d].contiguous()


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
    d = q.shape[-1]
    q, k, v = _operands(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, bh=b * h, sq=sq, skv=k.shape[1], heads_q=h,
            heads_kv=kvh, groups=h // kvh, window=window, head_dim=d,
            strides=(q.stride(0), q.stride(2), q.stride(1),
                     k.stride(0), k.stride(2), k.stride(1),
                     v.stride(0), v.stride(2), v.stride(1),
                     out.stride(0), out.stride(2), out.stride(1)))
    return out if out.shape[-1] == d else out[..., :d].contiguous()


__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "ROUTE_LAUNCHES", "flash_attention",
           "flash_attention_folded", "reset_launch_counts", "tma_operand",
           "tma_ready"]
