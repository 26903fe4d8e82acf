"""Transformer building blocks: norms, RoPE/M-RoPE, attention (GQA, MQA,
qk-norm, sliding window), MLA with the absorbed decode, the gated MLP and
the MoE with sort-based capacity dispatch.

The port of ``repro.models.layers``. Each block is an
``nn.Module`` holding its weights under the reference's names and shapes
(``wq`` [d, H, D], ``wo`` [H, D, d], ...), so a reference parameter tree
carries across leaf by leaf (:func:`repro_torch.convert.model_params_from_numpy`).
The functions under the reference's names (``attention_fwd``,
``attention_decode``, ``mla_fwd``, ``moe_fwd``, ...) take the module as
``p``; the modules' ``forward`` calls them.

Prefill attention, MLA's included, runs through :class:`AttentionCore`,
the only caller of the flash kernel on the model's path: CUDA tensors
launch the kernel, CPU tensors run its plain version. Decode attention
(one query against the cache) and the MoE's expert products are plain
torch, as the reference computes them outside any kernel. The kernel
call is differentiable (``kernels.flash_attention.FlashAttentionFn``), so
training gets q, k and v's gradients through it; ``moe_aux_loss`` is the
reference's load-balancing loss, which its ``loss_fn`` does not add.

On DTensors (under a mesh, ``distributed.sharding.use_rules``) the
projections, the output projection, the gated MLP and the attention core
run as ``local_map`` blocks with a fixed layout (``_sharded_matmul``,
``_sharded_out``, ``_sharded_mlp``, ``_sharded_core``): each rank's batch
shard against its heads or ff slice, the weights gathered over the data
dims, partial sums left for ``shard_as`` to all-reduce; decode attention
over a position-split cache merges each rank's softmax terms.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import sharding as SH
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
        t = torch.randn(shape, generator=gen, device=device).mul_(std).to(
            dtype)
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
    """q, k [B, S, H | KV, D], v [B, S, KV, Dv] with Dv <= D -> [B, S, H,
    Dv]: causal attention, optionally windowed, through the flash kernel,
    scaled by 1/sqrt(D). It holds no weights; it is a module of its own so
    that a caller can hook each layer's kernel call and hold it against the
    plain version on the same q, k, v.

    The kernel takes one head dim for q, k and v. A narrower v (MLA: Dv
    128 against D 192) is padded with zero columns to D and the output cut
    back to Dv, which is exact: zero columns of V give zero output
    columns, and the others do not see them."""

    def __init__(self, window: int):
        super().__init__()
        self.window = int(window)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        if SH.is_dtensor(q):
            return _sharded_core(self._local, q, k, v)
        return self._local(q, k, v)

    def _local(self, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        dv, d = v.shape[-1], q.shape[-1]
        if dv == d:
            return flash_attention(q, k, v, window=self.window)
        return flash_attention(q, k, F.pad(v, (0, d - dv)),
                               window=self.window)[..., :dv]


def _sharded_core(core, q, k, v):
    """The attention core on DTensors: each rank runs the kernel on its
    batch shard and its query heads (heads split over "model" when the
    mesh dim divides them; else every "model" rank takes all heads), with
    the kv heads those heads read (GQA: head i reads kv head i // g).
    Nothing else is split: q, k and v are redistributed to that layout
    first (k and v gathered over "model" unless their heads split alike,
    and then each rank's k, v gradient is partial)."""
    mesh = q.device_mesh
    sizes = SH.axis_sizes(mesh)
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    msize = sizes.get("model", 1)
    heads_split = "model" in sizes and h % msize == 0 and (
        (h // msize) % g == 0 or g % (h // msize) == 0)
    kv_split = heads_split and kvh % msize == 0
    batch = SH.shard_dims(q, 0)
    model = [mesh.mesh_dim_names.index("model")] if heads_split else []
    q_pl = SH.layout(mesh, shard0=batch, shard2=model)
    kv_pl = SH.layout(mesh, shard0=batch, shard2=model if kv_split else [])
    kv_grad = SH.layout(mesh, shard0=batch, **(
        {"shard2": model} if kv_split else {"partial": model}))
    mrank = mesh.get_local_rank("model") if model and not kv_split else 0

    def local(ql, kl, vl):
        if model and not kv_split:
            hl = ql.shape[2]
            first = mrank * hl // g
            last = (mrank * hl + hl - 1) // g + 1
            kl, vl = kl[:, :, first:last], vl[:, :, first:last]
        return core(ql, kl, vl)

    return SH.run_local(local, mesh, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl,
                        (q_pl, kv_grad, kv_grad))


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
    """x [B, S, d] times w [d, N, D] -> [B, S, N, D] (one matmul). On
    DTensors: w gathered over the data dims, each rank's product of its
    batch shard and its N or D slice (:func:`_sharded_matmul`)."""
    if SH.is_dtensor(w):
        return _sharded_matmul(x, w, _proj)
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _sharded_matmul(x, w, local_fn):
    """``local_fn(x, w)`` for x [B, S, ..., K] against a weight w whose
    first dim K is contracted, on DTensors: w gathered over the data dims;
    x on its batch shards and, where w splits K over a mesh dim, split
    alike in its last dim (else replicated there); the output on the batch
    shards, split as w splits its other dims (tensor dim j of w is output
    dim x.dim() - 2 + j) and partial over the mesh dims that split K. The
    gradients are partial where a rank's part differs from its
    neighbours' (w over the batch shards, x over w's splits)."""
    w = SH.gathered(w)
    mesh = w.device_mesh
    batch = SH.shard_dims(x, 0)
    k_dims = SH.shard_dims(w, 0)
    w_out = {f"shard{x.dim() - 2 + j}": SH.shard_dims(w, j)
             for j in range(1, w.dim()) if SH.shard_dims(w, j)}
    w_split = [i for dims in w_out.values() for i in dims]
    x_pl = SH.layout(mesh, shard0=batch, **{f"shard{x.dim() - 1}": k_dims})
    out_pl = SH.layout(mesh, shard0=batch, partial=k_dims, **w_out)
    x_grad = SH.layout(mesh, shard0=batch, partial=w_split,
                       **{f"shard{x.dim() - 1}": k_dims})
    return SH.run_local(local_fn, mesh, (x, w), (x_pl, w.placements), out_pl,
                        (x_grad, SH.partial_over(w.placements, batch)))


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
    """o [B, S, H, D] times wo [H, D, d] -> [B, S, d]; on DTensors each
    rank's heads against its slice of wo, partial over "model"."""
    if SH.is_dtensor(p.wo):
        return _sharded_out(o, p.wo)
    return _out_local(o, p.wo)


def _out_local(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return o.flatten(2) @ wo.flatten(0, 1)


def _sharded_out(o, wo):
    """:func:`_out` on DTensors: wo gathered over the data dims; o on its
    batch shards, split in H (or D) as wo is; the sum partial over the
    mesh dims that split H or D."""
    wo = SH.gathered(wo)
    mesh = wo.device_mesh
    batch = SH.shard_dims(o, 0)
    hd = {f"shard{2 + j}": SH.shard_dims(wo, j) for j in (0, 1)
          if SH.shard_dims(wo, j)}
    split = [i for dims in hd.values() for i in dims]
    o_pl = SH.layout(mesh, shard0=batch, **hd)
    out_pl = SH.layout(mesh, shard0=batch, partial=split)
    return SH.run_local(_out_local, mesh, (o, wo), (o_pl, wo.placements),
                        out_pl, (o_pl, SH.partial_over(wo.placements, batch)))


def attention_fwd(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Prefill self-attention: every key at any S (the reference's
    ``chunked_causal_attention`` reshapes S into chunks of 2,048)."""
    q, k, v = _qkv(p, x, cfg, positions)
    k = SH.shard_as(k, "batch", "seq", "kv_heads", None)
    v = SH.shard_as(v, "batch", "seq", "kv_heads", None)
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
    ``pos % length`` for a ring buffer); scores and softmax in float32.
    Over a DTensor cache each rank works on its part
    (:func:`_decode_shards`)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    (ql, kl, vl), l0, merge, wrap = _decode_shards(ck, (q, k, v), heads=2)
    ckl, cvl = _local(ck), _local(cv)
    length, ll = ck.shape[1], ckl.shape[1]
    slot = pos % length if cfg.sliding_window else _checked(pos, length)
    if l0 <= slot < l0 + ll:
        ckl[:, slot - l0] = kl[:, 0]
        cvl[:, slot - l0] = vl[:, 0]
    bl, kvl, d = ql.shape[0], ckl.shape[2], cfg.head_dim
    g = ql.shape[2] // kvl
    qg = ql.reshape(bl, 1, kvl, g, d)
    sc = torch.einsum("bqkgd,bckd->bkgqc", qg, ckl).float() \
        * (1.0 / math.sqrt(d))
    idx = l0 + torch.arange(ll, device=ckl.device)
    if cfg.sliding_window:
        mask = (slot - idx) % length <= min(pos, length - 1)
    else:
        mask = idx <= pos
    sc = sc.masked_fill(~mask, NEG_INF)
    out = merge(sc, cvl.float().permute(0, 2, 1, 3)[:, :, None])  # b,kv,g,1,d
    out = out.permute(0, 3, 1, 2, 4).reshape(bl, 1, kvl * g, d).to(ql.dtype)
    return _out(p, wrap(out))


def _checked(pos: int, length: int) -> int:
    if not 0 <= pos < length:
        raise IndexError(f"decode position {pos} outside the cache's "
                         f"{length} positions")
    return pos


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return t.to_local() if SH.is_dtensor(t) else t


def _decode_shards(ref: torch.Tensor, acts, heads: Optional[int] = None):
    """This rank's part of a decode step over the cache tensor ``ref``
    ([B, L, ...]): (``acts`` local, the first position it holds, ``merge``,
    ``wrap``). ``merge(scores, values)`` is softmax(scores) · values over
    the key axis (scores [..., C] float32, values [..., C, V]).

    On a plain cache: ``acts`` as they are, position 0, the softmax, and
    ``wrap`` the identity. On a DTensor cache (split over batch,
    positions and, at tensor dim ``heads``, kv heads as its spec says):
    ``acts`` redistributed to the cache's batch and head split, whole in
    S, as local tensors; the first of this rank's positions; a ``merge``
    of each rank's running max, sum and weighted values over its keys by
    all-reduces (max, then sums) over the mesh dims that split the
    positions; and ``wrap``, which lays a local result [b, ...] out as a
    DTensor split as the acts were."""
    if not SH.is_dtensor(ref):
        return (acts, 0,
                lambda scores, values: torch.softmax(scores, -1) @ values,
                lambda t: t)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    mesh = ref.device_mesh
    split = {"shard0": SH.shard_dims(ref, 0)}
    if heads is not None:
        split[f"shard{heads}"] = SH.shard_dims(ref, heads)
    pl = SH.layout(mesh, **split)
    seq_dims = SH.shard_dims(ref, 1)
    l0 = SH.mesh_index(mesh, [mesh.mesh_dim_names[i] for i in seq_dims]) \
        * ref.to_local().shape[1]

    def merge(scores, values):
        m = scores.amax(dim=-1, keepdim=True)
        for i in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        e = torch.exp(scores - m)
        l, acc = e.sum(-1), e @ values
        for i in seq_dims:
            l = funcol.all_reduce(l, "sum", (mesh, i))
            acc = funcol.all_reduce(acc, "sum", (mesh, i))
        return acc / l[..., None]

    return ([t.redistribute(mesh, pl).to_local() for t in acts], l0, merge,
            lambda t: DTensor.from_local(t, mesh, pl, run_check=False))


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): low-rank q/kv compression, absorbed decode
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """One layer's MLA weights (``init_mla``) and its attention core."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        nd, rd, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.wdq = _init(gen, (d, qr), d ** -0.5, dt, device)
        self.q_norm = init_rms_norm(qr, dt, device)
        self.wuq = _init(gen, (qr, h, nd + rd), qr ** -0.5, dt, device)
        self.wdkv = _init(gen, (d, kr + rd), d ** -0.5, dt, device)
        self.kv_norm = init_rms_norm(kr, dt, device)
        self.wuk = _init(gen, (kr, h, nd), kr ** -0.5, dt, device)
        self.wuv = _init(gen, (kr, h, vd), kr ** -0.5, dt, device)
        self.wo = _init(gen, (h, vd, d), (h * vd) ** -0.5, dt, device)
        self.core = AttentionCore(0)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return mla_fwd(self, x, self.cfg, positions)


def init_mla(cfg: ModelConfig, gen: Optional[torch.Generator],
             device) -> MLA:
    return MLA(cfg, gen, device)


def _mla_qkv_compressed(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor):
    """Returns (q_nope [B, S, H, nd], q_rope [B, S, H, rd], c_kv [B, S,
    kv_lora], k_rope [B, S, rd]); RoPE on the rope parts."""
    nd, rd, kr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    cq = rms_norm(x @ SH.gathered(p.wdq), p.q_norm, cfg.norm_eps)
    q = _proj(cq, p.wuq)
    dkv = x @ SH.gathered(p.wdkv)
    c_kv = rms_norm(dkv[..., :kr], p.kv_norm, cfg.norm_eps)
    cos, sin = positions_cos_sin(cfg, positions, rd)
    return (q[..., :nd], apply_rope(q[..., nd:], cos, sin), c_kv,
            apply_rope(dkv[..., kr:], cos, sin))


def mla_fwd(p: MLA, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor) -> torch.Tensor:
    """Prefill: k and v expanded per head, k_rope broadcast over the heads,
    attention through the core (qk head dim nd + rd, v head dim vd)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_compressed(p, x, cfg, positions)
    k_nope = _proj(c_kv, p.wuk)
    v = _proj(c_kv, p.wuv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    return _out(p, p.core(q, k, v))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The compressed stream: ``ckv`` [B, max_len, kv_lora] and ``krope``
    [B, max_len, rd]."""
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_decode(p: MLA, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig, pos: int) -> torch.Tensor:
    """Absorbed-matrix decode of one token: W_uk folded into the query,
    W_uv into the output, so attention runs in the compressed space. The
    new c_kv, k_rope are written into the cache in place at ``pos``. Over
    a DTensor cache each rank works on its part (:func:`_decode_shards`)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_compressed(p, x, cfg, positions)
    ckv, krp = cache["ckv"], cache["krope"]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, p.wuk)
    (qa, qr, cl, kr), l0, merge, wrap = _decode_shards(
        ckv, (q_abs, q_rope, c_kv, k_rope))
    ckl, krl = _local(ckv), _local(krp)
    ll = ckl.shape[1]
    _checked(pos, ckv.shape[1])
    if l0 <= pos < l0 + ll:
        ckl[:, pos - l0] = cl[:, 0]
        krl[:, pos - l0] = kr[:, 0]
    s_c = torch.einsum("bshr,bcr->bhsc", qa, ckl)
    s_r = torch.einsum("bshr,bcr->bhsc", qr, krl)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    sc = (s_c + s_r).float() * scale
    mask = l0 + torch.arange(ll, device=ckl.device) <= pos
    ctx = merge(sc.masked_fill(~mask, NEG_INF), ckl.float()[:, None])
    ctx = ctx.permute(0, 2, 1, 3).to(qa.dtype)                # [b,1,h,r]
    return _out(p, torch.einsum("bshr,rhv->bshv", wrap(ctx), p.wuv))


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """One layer's gated MLP weights (``init_mlp``), of width ``d_ff``
    (``cfg.d_ff`` unless given: the MoE's shared expert)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, d_ff: Optional[int] = None):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        dt = _dtype(cfg)
        self.cfg = cfg
        self.wi_gate = _init(gen, (d, ff), d ** -0.5, dt, device)
        self.wi_up = _init(gen, (d, ff), d ** -0.5, dt, device)
        self.wo = _init(gen, (ff, d), ff ** -0.5, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_fwd(self, x, self.cfg)


def init_mlp(cfg: ModelConfig, gen: Optional[torch.Generator],
             device, d_ff: Optional[int] = None) -> MLP:
    return MLP(cfg, gen, device, d_ff)


def _act(cfg: ModelConfig):
    """GELU (tanh form, as ``jax.nn.gelu``) or SiLU."""
    if cfg.act == "gelu":
        return lambda h: F.gelu(h, approximate="tanh")
    return F.silu


def mlp_fwd(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP; on DTensors each rank's batch shard through its ff
    slice (the weights gathered over the data dims), partial over the
    mesh dims that split ff."""
    if SH.is_dtensor(p.wi_gate):
        return _sharded_mlp(p, x, cfg)
    return _mlp_local(x, p.wi_gate, p.wi_up, p.wo, cfg)


def _mlp_local(x, wi_gate, wi_up, wo, cfg: ModelConfig):
    return (_act(cfg)(x @ wi_gate) * (x @ wi_up)) @ wo


def _sharded_mlp(p: MLP, x, cfg: ModelConfig):
    wg, wu, wo = (SH.gathered(w) for w in (p.wi_gate, p.wi_up, p.wo))
    mesh = wg.device_mesh
    batch = SH.shard_dims(x, 0)
    ff = SH.shard_dims(wg, 1)
    x_pl = SH.layout(mesh, shard0=batch)
    w_grads = [SH.partial_over(w.placements, batch) for w in (wg, wu, wo)]
    return SH.run_local(
        lambda xl, a, b, c: _mlp_local(xl, a, b, c, cfg), mesh,
        (x, wg, wu, wo), (x_pl, wg.placements, wu.placements, wo.placements),
        SH.layout(mesh, shard0=batch, partial=ff),
        (SH.layout(mesh, shard0=batch, partial=ff), *w_grads))


# ---------------------------------------------------------------------------
# MoE: top-k routing, sort-based capacity dispatch, optional shared experts
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """One layer's experts (``init_moe``): a float32 ``router`` [d, E]
    whatever the model's dtype, ``wi_gate``/``wi_up`` [E, d, ff], ``wo``
    [E, ff, d] and, with shared experts, ``shared`` (an :class:`MLP` of
    width ``moe_d_ff · moe_shared_experts``)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
        dt = _dtype(cfg)
        self.cfg = cfg
        self.router = _init(gen, (d, e), d ** -0.5, torch.float32, device)
        self.wi_gate = _init(gen, (e, d, ff), d ** -0.5, dt, device)
        self.wi_up = _init(gen, (e, d, ff), d ** -0.5, dt, device)
        self.wo = _init(gen, (e, ff, d), ff ** -0.5, dt, device)
        if cfg.moe_shared_experts:
            self.shared = MLP(cfg, gen, device,
                              cfg.moe_d_ff * cfg.moe_shared_experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_fwd(self, x, self.cfg)


def init_moe(cfg: ModelConfig, gen: Optional[torch.Generator],
             device) -> MoE:
    return MoE(cfg, gen, device)


class Routing(NamedTuple):
    """One call's routing over its t tokens (assignment i = token i // k,
    its (i % k)-th choice)."""
    logits: torch.Tensor   # [t, E] float32, the router's
    gates: torch.Tensor    # [t, k] float32, renormalised over the k choices
    idx: torch.Tensor      # [t, k] int64 expert ids, by falling probability
    rank: torch.Tensor     # [t·k] int64 rank within the expert, in token order
    keep: torch.Tensor     # [t·k] bool: rank < cap
    dest: torch.Tensor     # [t·k] int64 slot: expert·cap + rank, or E·cap
    cap: int               # slots per expert in this call


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call over ``tokens`` tokens."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    return max(int(math.ceil(tokens * k / e * cfg.capacity_factor)), 1)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest probabilities of each row and their expert ids, ties
    to the smaller id (as ``lax.top_k``): a stable descending sort."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def moe_route(p: MoE, xt: torch.Tensor, cfg: ModelConfig,
              cap: Optional[int] = None, router=None) -> Routing:
    """The reference's routing of ``xt`` [t, d], integer for integer: a
    float32 softmax of the router's logits, the top k by probability (ties
    to the smaller expert id, as ``lax.top_k``: a stable descending sort),
    gates renormalised, then each assignment's rank within its expert in
    token order (a stable sort of the flat expert ids), kept below the
    capacity (``moe_capacity(t)`` unless given) and sent to the drop slot
    E·cap otherwise. ``router`` replaces ``p.router`` (a rank's local
    copy)."""
    t = xt.shape[0]
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = moe_capacity(t, cfg) if cap is None else cap
    logits = xt.float() @ (p.router if router is None else router)
    gates, idx = _top_k(torch.softmax(logits, dim=-1), k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.zeros(e, dtype=e_flat.dtype, device=xt.device)
    counts.index_add_(0, e_sorted, torch.ones_like(e_sorted))
    starts = counts.cumsum(0) - counts
    rank = torch.empty_like(e_flat)
    rank[order] = torch.arange(t * k, device=xt.device) - starts[e_sorted]
    keep = rank < cap
    dest = torch.where(keep, e_flat * cap + rank, e * cap)
    return Routing(logits, gates, idx, rank, keep, dest, cap)


def moe_experts(xt: torch.Tensor, r: Routing, wi_gate: torch.Tensor,
                wi_up: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
                first: int = 0) -> torch.Tensor:
    """The routed experts' output [t, d] for tokens ``xt`` [t, d]: each
    kept assignment to an expert in [first, first + E_w) (E_w =
    ``wi_gate.shape[0]``, all E by default) scattered into its slot of a
    [E_w·cap + 1, d] buffer (the last row the drop slot), the experts'
    gated MLPs as batched products over [E_w, cap, d], each assignment's
    row gathered back and the k rows summed by gate. A kept slot receives
    exactly one add, so the scatter is deterministic on CUDA too; only the
    discarded drop slot sums many."""
    t, d = xt.shape
    k, cap = cfg.moe_top_k, r.cap
    ew = wi_gate.shape[0]
    local_e = r.idx.reshape(t * k) - first
    mine = r.keep & (local_e >= 0) & (local_e < ew)
    dest = torch.where(mine, local_e * cap + r.rank, ew * cap)
    tok_of = torch.arange(t * k, device=xt.device) // k
    buf = torch.zeros((ew * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dest, xt[tok_of])
    buf = SH.shard_as(buf[:-1].view(ew, cap, d), "expert", "moe_capacity",
                      None)
    h = _act(cfg)(torch.bmm(buf, wi_gate)) * torch.bmm(buf, wi_up)
    out_buf = SH.shard_as(torch.bmm(h, wo), "expert", "moe_capacity", None)
    flat_out = torch.cat([out_buf.reshape(ew * cap, d),
                          buf.new_zeros((1, d))])
    y_assign = flat_out[dest].view(t, k, d)
    return (y_assign * r.gates.to(y_assign.dtype)[..., None]).sum(1)


def moe_fwd(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: routing (:func:`moe_route`, capacity over
    all B·S tokens), the routed experts (:func:`moe_experts`) plus the
    shared expert. On DTensors (under a mesh) it runs
    :func:`.moe_ep.moe_fwd_sharded`, which keeps that capacity."""
    if SH.is_dtensor(x):
        from .moe_ep import moe_fwd_sharded
        return moe_fwd_sharded(p, x, cfg)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    r = moe_route(p, xt, cfg)
    y = moe_experts(xt, r, p.wi_gate, p.wi_up, p.wo, cfg)
    if cfg.moe_shared_experts:
        y = y + mlp_fwd(p.shared, x, cfg).reshape(t, d)
    return y.reshape(b, s, d)


def moe_aux_loss(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E · Σ_e (share of the
    top-k assignments routed to e) · (mean router probability of e), in
    float32 over the B·S tokens of x [B, S, d]."""
    e = cfg.moe_num_experts
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p.router,
                          dim=-1)
    _, idx = _top_k(probs, cfg.moe_top_k)
    frac = F.one_hot(idx, e).to(torch.float32).mean(dim=(0, 1))
    return e * torch.sum(frac * probs.mean(dim=0))
