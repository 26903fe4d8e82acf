"""Mamba2 (SSD, state-space duality) block: chunked scan and O(1) decode.

The port of ``repro.models.ssm``. Within a chunk of Q positions the
recurrence is a masked, decay-weighted quadratic form; across chunks a
float32 state [B, H, P, N] carries over. The reference scans the chunks
with ``lax.scan``; the port computes every chunk's own terms at once
([B, nc, ...] tensors, O(S) memory as the reference's stacked outputs) and
loops in Python over the state carry only, one fused multiply-add a
chunk. Decode is the exact one-step recurrence. The reference's
three-operand einsums are written as two-operand products (the same sums;
torch's path for three operands builds a [B, Q, H, P, N] intermediate).

Precisions are the reference's: ``a_log``, ``d_skip``, ``dt_bias`` and the
state are float32 in a bf16 model; dt, the cumulative decays and the state
carry are float32; the quadratic forms take operands in the model's dtype
and accumulate in float32 (the reference's ``preferred_element_type``),
which the port gets by casting the operands to float32 before the product.

Single group (ngroups = 1): the B and C projections are shared by the
heads. Reference fault 9: ``ssm_fwd`` raises ``TypeError`` for S longer
than ``ssm_chunk`` and not a multiple of it; the port raises ``ValueError``
naming the precondition (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import sharding as SH
from .config import ModelConfig
from .layers import _dtype, _init, rms_norm


class SSM(nn.Module):
    """One layer's SSD weights (``init_ssm``): the z, x, BC and dt
    projections, the depthwise convolutions of x and BC, ``a_log``,
    ``d_skip``, ``dt_bias`` (float32), the gated norm and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        d = cfg.d_model
        di, n, h, convw = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_conv
        dt = _dtype(cfg)
        self.cfg = cfg

        def const(shape, value, dtype):
            return nn.Parameter(torch.full(shape, value, dtype=dtype,
                                           device=device),
                                requires_grad=False)

        self.z_proj = _init(gen, (d, di), d ** -0.5, dt, device)
        self.x_proj = _init(gen, (d, di), d ** -0.5, dt, device)
        self.bc_proj = _init(gen, (d, 2 * n), d ** -0.5, dt, device)
        self.dt_proj = _init(gen, (d, h), d ** -0.5, dt, device)
        self.conv_wx = _init(gen, (convw, di), convw ** -0.5, dt, device)
        self.conv_bx = const((di,), 0.0, dt)
        self.conv_wbc = _init(gen, (convw, 2 * n), convw ** -0.5, dt, device)
        self.conv_bbc = const((2 * n,), 0.0, dt)
        self.a_log = const((h,), 0.0, torch.float32)
        self.d_skip = const((h,), 1.0, torch.float32)
        self.dt_bias = const((h,), 0.0, torch.float32)
        self.norm = const((di,), 0.0, dt)
        self.out_proj = _init(gen, (di, d), di ** -0.5, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ssm_fwd(self, x, self.cfg)


def init_ssm(cfg: ModelConfig, gen: Optional[torch.Generator],
             device) -> SSM:
    return SSM(cfg, gen, device)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if SH.is_dtensor(w):
        from .layers import _sharded_matmul
        return _sharded_matmul(x, w, torch.matmul)
    return x @ w


def _project(p: SSM, x: torch.Tensor):
    return tuple(_matmul(x, w) for w in (p.z_proj, p.x_proj, p.bc_proj,
                                         p.dt_proj))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [K, C], then SiLU.
    The taps are summed in float32 and rounded once to the input's dtype,
    as :func:`ssm_decode`'s window product (the reference's einsum) is, so
    that a bf16 prefill and decode round the convolution alike."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)).float()
    out = sum(pad[:, i:i + s] * w[i].float() for i in range(k))
    return F.silu(out.to(xbc.dtype) + b)


def ssm_fwd(p: SSM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Prefill. x: [B, S, d] with S <= ssm_chunk or S a multiple of it."""
    s = x.shape[1]
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(
            f"ssm_fwd needs S <= ssm_chunk or S a multiple of it: S = {s}, "
            f"ssm_chunk = {cfg.ssm_chunk}")
    z, xc, bc, dt_raw = _project(p, x)
    weights = (p.conv_wx, p.conv_bx, p.conv_wbc, p.conv_bbc, p.a_log,
               p.d_skip, p.dt_bias)
    if SH.is_dtensor(xc):
        y = _sharded_scan(cfg, xc, bc, dt_raw, weights)
    else:
        y = _scan(cfg, xc, bc, dt_raw, *weights)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p.norm, cfg.norm_eps)
    return _matmul(y, p.out_proj)


def _scan(cfg: ModelConfig, xc, bc, dt_raw, conv_wx, conv_bx, conv_wbc,
          conv_bbc, a_log, d_skip, dt_bias) -> torch.Tensor:
    """The convolutions and the chunked SSD scan of [B, S, H·P] inputs
    (any H: the heads these tensors hold) -> y [B, S, H·P] float32."""
    bsz, s, di = xc.shape
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    h = di // hp
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    xc = _causal_conv(xc, conv_wx, conv_bx)
    bc = _causal_conv(bc, conv_wbc, conv_bbc)
    xs = xc.reshape(bsz, s, h, hp)
    dt = F.softplus(dt_raw.float() + dt_bias)                    # [B, S, H]
    a = -torch.exp(a_log)                                        # [H]

    xs_c = xs.reshape(bsz, nc, q, h, hp)
    xs_f = xs_c.float()
    b_c = bc[..., :n].reshape(bsz, nc, q, n).float()
    c_c = bc[..., n:].reshape(bsz, nc, q, n).float()
    dt_c = dt.reshape(bsz, nc, q, h)
    cs = torch.cumsum(dt_c * a, dim=2)                           # inclusive
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xc.device))

    # intra-chunk, every chunk at once: the masked quadratic form, decays
    # in float32, wmat rounded to the model's dtype as the reference's
    # operand
    li = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # [B,nc,Q,Q,H]
    li = li.masked_fill(~tri[:, :, None], 0.0)
    scores = c_c @ b_c.transpose(-1, -2)                         # [B,nc,Q,Q]
    wmat = scores[..., None] * li * dt_c[:, :, None, :, :]
    intra = torch.einsum("bcijh,bcjhp->bcihp",
                         wmat.to(xs.dtype).float(), xs_f)
    # the state each chunk adds, decayed to its end  [B, nc, H, P, N]
    decay_out = torch.exp(cs[:, :, -1:, :] - cs)                 # [B,nc,Q,H]
    carry = torch.einsum("bcjn,bcjhp->bchpn", b_c,
                         xs_f * (decay_out * dt_c)[..., None])
    # the only sequential step: the float32 state entering each chunk,
    # written over that chunk's own contribution once it is used
    decay = torch.exp(cs[:, :, -1, :])[..., None, None]          # [B,nc,H,1,1]
    state = torch.zeros_like(carry[:, 0])
    for c in range(nc):
        nxt = torch.addcmul(carry[:, c], state, decay[:, c])
        carry[:, c] = state
        state = nxt
    # inter-chunk: the carried-in state read at every position
    inter = torch.einsum("bcin,bchpn->bcihp", c_c, carry) \
        * torch.exp(cs)[..., None]

    y = (intra + inter).reshape(bsz, s, h, hp)
    y = y + d_skip[None, None, :, None] * xs.float()
    return y.reshape(bsz, s, di).to(xc.dtype)


def _sharded_scan(cfg: ModelConfig, xc, bc, dt_raw, weights):
    """:func:`_scan` on DTensors: each rank scans its batch shard and, when
    "model" splits the inner dim into whole heads, its heads (the shared
    B, C projection and each head's dt, A, D and bias sliced out of their
    replicated copies); else every "model" rank scans all heads."""
    conv_wx, conv_bx, conv_wbc, conv_bbc, a_log, d_skip, dt_bias = weights
    mesh = xc.device_mesh
    sizes = SH.axis_sizes(mesh)
    h = cfg.ssm_heads
    msize = sizes.get("model", 1)
    batch = SH.shard_dims(xc, 0)
    heads = ([mesh.mesh_dim_names.index("model")]
             if "model" in sizes and h % msize == 0 else [])
    hl = h // msize if heads else h
    first = mesh.get_local_rank("model") * hl if heads else 0
    # a replicated weight's gradient is partial where ranks differ
    shared = SH.layout(mesh, partial=batch + heads)
    inner = SH.layout(mesh, shard0=batch, shard2=heads)
    rows = SH.layout(mesh, shard0=batch)
    args = (xc, bc, dt_raw, conv_wx, conv_bx, conv_wbc, conv_bbc, a_log,
            d_skip, dt_bias)
    in_pl = (inner, rows, rows, SH.layout(mesh, shard1=heads),
             SH.layout(mesh, shard0=heads)) + (SH.layout(mesh),) * 5
    grads = (inner, SH.layout(mesh, shard0=batch, partial=heads),
             SH.layout(mesh, shard0=batch, partial=heads),
             SH.layout(mesh, shard1=heads, partial=batch),
             SH.layout(mesh, shard0=heads, partial=batch)) + (shared,) * 5

    def local(xl, bl, dl, wx, bx, wbc, bbc, al, ds, db):
        sl = slice(first, first + hl)
        return _scan(cfg, xl, bl, dl[..., sl], wx, bx, wbc, bbc, al[sl],
                     ds[sl], db[sl])

    return SH.run_local(local, mesh, args, in_pl, inner, grads)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    """The last ``ssm_conv - 1`` inputs of each convolution and the float32
    state [B, H, P, N]."""
    di, n, h, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    k = cfg.ssm_conv - 1
    return {"conv_x": torch.zeros((batch, k, di), dtype=dtype, device=device),
            "conv_bc": torch.zeros((batch, k, 2 * n), dtype=dtype,
                                   device=device),
            "state": torch.zeros((batch, h, hp, n), dtype=torch.float32,
                                 device=device)}


def _window_conv(win: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The convolution at the newest position: window [B, K, C] times
    kernel [K, C], summed over K in float32, rounded once."""
    return (win.float() * w.float()).sum(1).to(win.dtype)


def ssm_decode(p: SSM, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """One token of the recurrence. x: [B, 1, d]; the cache's windows and
    state are updated in place (the state is position-free)."""
    bsz = x.shape[0]
    di, n, h, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xc_raw, bc_raw, dt_raw = _project(p, x)
    win_x = torch.cat([cache["conv_x"], xc_raw], dim=1)          # [B, K, di]
    win_bc = torch.cat([cache["conv_bc"], bc_raw], dim=1)        # [B, K, 2n]
    xc = F.silu(_window_conv(win_x, p.conv_wx) + p.conv_bx)
    bcv = F.silu(_window_conv(win_bc, p.conv_wbc) + p.conv_bbc)
    xs = xc.reshape(bsz, h, hp).float()
    bmat, cmat = bcv[:, :n].float(), bcv[:, n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)            # [B, H]
    da = torch.exp(dt * -torch.exp(p.a_log))
    state = cache["state"] * da[..., None, None] \
        + (xs * dt[..., None])[..., None] * bmat[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cmat, state) \
        + p.d_skip[None, :, None] * xs
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    cache["conv_x"].copy_(win_x[:, 1:])
    cache["conv_bc"].copy_(win_bc[:, 1:])
    cache["state"].copy_(state)
    return _matmul(y, p.out_proj)
