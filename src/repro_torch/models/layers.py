"""Dense transformer building blocks: norms, RoPE/M-RoPE, attention (GQA,
MQA, qk-norm, sliding window) and the gated MLP.

The port of the dense part of ``repro.models.layers``. Each block is an
``nn.Module`` holding its weights under the reference's names and shapes
(``wq`` [d, H, D], ``wo`` [H, D, d], ...), so a reference parameter tree
carries across leaf by leaf (:func:`repro_torch.convert.model_params_from_numpy`).
The functions under the reference's names (``attention_fwd``,
``attention_decode``, ``mlp_fwd``, ...) take the module as ``p``; the
modules' ``forward`` calls them.

Prefill attention runs through :class:`AttentionCore`, the only caller of
the flash kernel on the model's path: CUDA tensors launch the kernel,
CPU tensors run its plain version. Decode attention (one query against the
cache) is plain torch, as the reference computes it outside any kernel.
MLA and MoE wait for a later slice of the port.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention
from .config import ModelConfig

NEG_INF = -1e30

#: ``ModelConfig.dtype`` names -> torch types
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _init(gen: Optional[torch.Generator], shape, std: float,
          dtype: torch.dtype, device) -> nn.Parameter:
    """N(0, std²) drawn in float32 from ``gen`` and cast to ``dtype``;
    uninitialised memory when ``gen`` is None (a converter fills it)."""
    if gen is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32 with the ``1 + scale`` gain, cast back."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: [...] int -> cos/sin [..., head_dim // 2] (float32)."""
    ang = positions.float()[..., None] * _freqs(head_dim, theta,
                                                positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]):
    """M-RoPE (qwen2-vl): positions [..., 3] (t, h, w); frequency j of the
    half dim reads the position of its section (frequencies past the
    sections read section 0). Identical t = h = w positions reduce to 1D
    RoPE."""
    half = head_dim // 2
    sec_id = torch.zeros(half, dtype=torch.long, device=positions.device)
    off = 0
    for i, s in enumerate(sections):
        sec_id[off:off + s] = i
        off += s
    pos = positions.float()[..., sec_id]
    ang = pos * _freqs(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, ..., D]; cos/sin: [B, S, D/2] — rotate-half convention,
    computed in float32 and cast back."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def positions_cos_sin(cfg: ModelConfig, positions: torch.Tensor,
                      head_dim: int):
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:  # text stub: same position per section
            positions = positions[..., None].expand(*positions.shape, 3)
        return mrope_cos_sin(positions, head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA): flash-kernel prefill and cached decode
# ---------------------------------------------------------------------------

class AttentionCore(nn.Module):
    """q [B, S, H, D], k/v [B, S, KV, D] -> [B, S, H, D]: causal attention,
    optionally windowed, through the flash kernel. It holds no weights; it
    is a module of its own so that a caller can hook each layer's kernel
    call and hold it against the plain version on the same q, k, v."""

    def __init__(self, window: int):
        super().__init__()
        self.window = int(window)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return flash_attention(q, k, v, window=self.window)


class Attention(nn.Module):
    """One layer's attention weights (``init_attention``) and its core."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        dt = _dtype(cfg)
        self.cfg = cfg
        self.wq = _init(gen, (d, h, hd), d ** -0.5, dt, device)
        self.wk = _init(gen, (d, kv, hd), d ** -0.5, dt, device)
        self.wv = _init(gen, (d, kv, hd), d ** -0.5, dt, device)
        self.wo = _init(gen, (h, hd, d), (h * hd) ** -0.5, dt, device)
        if cfg.qk_norm:
            self.q_norm = init_rms_norm(hd, dt, device)
            self.k_norm = init_rms_norm(hd, dt, device)
        self.core = AttentionCore(cfg.sliding_window)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return attention_fwd(self, x, self.cfg, positions)


def init_attention(cfg: ModelConfig, gen: Optional[torch.Generator],
                   device) -> Attention:
    return Attention(cfg, gen, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] times w [d, N, D] -> [B, S, N, D] (one matmul)."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """Projections, qk-norm (before RoPE), RoPE on q and k."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    cos, sin = positions_cos_sin(cfg, positions, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """o [B, S, H, D] times wo [H, D, d] -> [B, S, d]."""
    return o.flatten(2) @ p.wo.flatten(0, 1)


def attention_fwd(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Prefill self-attention: every key at any S (the reference's
    ``chunked_causal_attention`` reshapes S into chunks of 2,048)."""
    q, k, v = _qkv(p, x, cfg, positions)
    return _out(p, p.core(q, k, v))


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """KV cache for one layer. Sliding-window configs keep a ring buffer of
    ``min(max_len, window)`` slots."""
    length = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p: Attention, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                     pos: int) -> torch.Tensor:
    """One-token decode step. x: [B, 1, d]; ``pos`` the synchronized
    position. The new k, v are written into the cache in place (slot
    ``pos % length`` for a ring buffer); scores and softmax in float32."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    slot = pos % length if cfg.sliding_window else pos
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]

    kheads = cfg.num_kv_heads
    g = cfg.num_heads // kheads
    qg = q.reshape(b, 1, kheads, g, cfg.head_dim)
    s_all = torch.einsum("bqkgd,bckd->bkgqc", qg, ck).float()
    s_all = s_all * (1.0 / math.sqrt(cfg.head_dim))
    idx = torch.arange(length, device=x.device)
    if cfg.sliding_window:
        mask = (slot - idx) % length <= min(pos, length - 1)
    else:
        mask = idx <= pos
    s_all = s_all.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s_all, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", w, cv.float())
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
    return _out(p, out)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """One layer's gated MLP weights (``init_mlp``)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = _dtype(cfg)
        self.cfg = cfg
        self.wi_gate = _init(gen, (d, ff), d ** -0.5, dt, device)
        self.wi_up = _init(gen, (d, ff), d ** -0.5, dt, device)
        self.wo = _init(gen, (ff, d), ff ** -0.5, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_fwd(self, x, self.cfg)


def init_mlp(cfg: ModelConfig, gen: Optional[torch.Generator],
             device) -> MLP:
    return MLP(cfg, gen, device)


def _act(cfg: ModelConfig):
    """GELU (tanh form, as ``jax.nn.gelu``) or SiLU."""
    if cfg.act == "gelu":
        return lambda h: F.gelu(h, approximate="tanh")
    return F.silu


def mlp_fwd(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = _act(cfg)(x @ p.wi_gate) * (x @ p.wi_up)
    return h @ p.wo
