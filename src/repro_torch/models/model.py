"""Model assembly: block planning, prefill forward and the synchronized
cached decode step, for every layer signature of the architecture pool.

The port of ``repro.models.model``. The reference stacks each block's
layers and scans over them; the port keeps one :class:`DecoderLayer` per
layer in a ``ModuleList``, in the reference's layer order (block by block,
repeat-major), which is the order
:func:`repro_torch.convert.model_params_from_numpy` unstacks the
reference's ``blocks[b][slot]`` leaves into. A layer is a mixer
(``attn``, ``mla`` or ``ssm``) and a feed-forward (``mlp``, ``moe`` or
``none``), each pre-normed and added to the residual.

Entry points run on CUDA unless the caller passes ``device="cpu"``. The
weights are created without ``requires_grad``, for serving; the training
state (``distributed.step.init_train_state``) turns it on. ``loss_fn`` is
the reference's train loss; with ``cfg.remat`` and grad on, each layer's
activations are recomputed in the backward
(``torch.utils.checkpoint``), as the reference checkpoints its scan body.

``params_logical_axes`` and ``cache_logical_axes`` give every parameter
(by its ``named_parameters()`` name) and cache tensor its logical axes:
the reference's per-layer tuples without the "layers" axis of its
stacked leaves. Laid out by them as DTensors, the same functions run
over a mesh (``shard_as`` at the reference's points, the vocab lookup,
the LM head and the gold logit as per-rank blocks over vocab slices).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..distributed import sharding as SH
from . import layers as L
from . import ssm as SSM
from .config import ModelConfig

LayerSig = Tuple[str, str]  # (mixer_kind, ffn_kind)
Cache = Dict[str, Any]


# ---------------------------------------------------------------------------
# Block planning
# ---------------------------------------------------------------------------

def layer_sigs(cfg: ModelConfig) -> List[LayerSig]:
    sigs = []
    for li in range(cfg.num_layers):
        if cfg.layer_pattern:
            mixer = cfg.layer_pattern[li % len(cfg.layer_pattern)]
        elif cfg.ssm:
            mixer = "ssm"
        elif cfg.mla:
            mixer = "mla"
        else:
            mixer = "attn"
        if cfg.ssm and not cfg.layer_pattern:
            ffn = "none"  # pure mamba block has no separate FFN
        elif (cfg.moe_num_experts > 0 and li >= cfg.moe_layer_start
              and (li - cfg.moe_layer_start) % cfg.moe_every == 0):
            ffn = "moe"
        else:
            ffn = "mlp"
        sigs.append((mixer, ffn))
    return sigs


@dataclasses.dataclass(frozen=True)
class Block:
    sigs: Tuple[LayerSig, ...]   # sublayers of one repeat, in order
    repeat: int                  # repeats of the block


def build_plan(cfg: ModelConfig) -> List[Block]:
    """The reference's grouping of layers into repeated blocks; the port
    uses it only to order layers as the reference stacks them."""
    sigs = layer_sigs(cfg)
    n = len(sigs)
    runs: List[Tuple[LayerSig, int]] = []
    for s in sigs:
        if runs and runs[-1][0] == s:
            runs[-1] = (s, runs[-1][1] + 1)
        else:
            runs.append((s, 1))
    if len(runs) <= 4:
        return [Block((s,), c) for s, c in runs]
    for p in range(1, min(n, 16) + 1):
        if n % p == 0 and all(sigs[i] == sigs[i % p] for i in range(n)):
            return [Block(tuple(sigs[:p]), n // p)]
    return [Block((s,), 1) for s in sigs]


def plan_sigs(cfg: ModelConfig) -> List[LayerSig]:
    """Each layer's signature in the order of :func:`build_plan` (block by
    block, repeat-major)."""
    return [sig for blk in build_plan(cfg) for _ in range(blk.repeat)
            for sig in blk.sigs]


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """One layer of signature ``sig``: pre-norm mixer, then (unless the
    ffn is "none") pre-norm MLP or MoE, each added to the residual; the
    reference's ``_init_sublayer`` / ``_apply_sublayer``."""

    def __init__(self, cfg: ModelConfig, sig: LayerSig,
                 gen: Optional[torch.Generator], device):
        super().__init__()
        mixer, ffn = sig
        dt = L._dtype(cfg)
        self.cfg, self.sig = cfg, sig
        self.ln1 = L.init_rms_norm(cfg.d_model, dt, device)
        if mixer == "attn":
            self.mixer = L.init_attention(cfg, gen, device)
        elif mixer == "mla":
            self.mixer = L.init_mla(cfg, gen, device)
        elif mixer == "ssm":
            self.mixer = SSM.init_ssm(cfg, gen, device)
        else:
            raise ValueError(f"unknown mixer {mixer!r}")
        if ffn != "none":
            self.ln2 = L.init_rms_norm(cfg.d_model, dt, device)
            self.ffn = (L.init_moe(cfg, gen, device) if ffn == "moe"
                        else L.init_mlp(cfg, gen, device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = L.rms_norm(x, self.ln1, self.cfg.norm_eps)
        h = self.mixer(h) if self.sig[0] == "ssm" else self.mixer(h, positions)
        x = x + SH.shard_as(h, "batch", "seq", "embed_act")
        return SH.shard_as(_apply_ffn(self, x), "batch", "seq", "embed_act")


def _apply_ffn(p: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
    if p.sig[1] == "none":
        return x
    h = L.rms_norm(x, p.ln2, p.cfg.norm_eps)
    h = _moe(p.ffn, h, p.cfg) if p.sig[1] == "moe" else p.ffn(h)
    return x + SH.shard_as(h, "batch", "seq", "embed_act")


def _sublayer_axes(cfg: ModelConfig, sig: LayerSig) -> Dict[str, tuple]:
    """The logical axes of one layer's parameters by their names in
    :class:`DecoderLayer`: the reference's per-slot axes without the
    leading "layers" axis of its stacked leaves."""
    mixer, ffn = sig
    ax: Dict[str, tuple] = {"ln1": ("embed",)}
    if mixer == "attn":
        ax.update({
            "mixer.wq": ("embed_fsdp", "heads", "head_dim_tp"),
            "mixer.wk": ("embed_fsdp", "kv_heads", "head_dim_tp"),
            "mixer.wv": ("embed_fsdp", "kv_heads", "head_dim_tp"),
            "mixer.wo": ("heads", "head_dim_tp", "embed_fsdp"),
        })
        if cfg.qk_norm:
            ax["mixer.q_norm"] = ("head_dim",)
            ax["mixer.k_norm"] = ("head_dim",)
    elif mixer == "mla":
        ax.update({
            "mixer.wdq": ("embed_fsdp", "q_lora"),
            "mixer.q_norm": ("q_lora",),
            "mixer.wuq": ("q_lora", "heads", None),
            "mixer.wdkv": ("embed_fsdp", "kv_lora"),
            "mixer.kv_norm": ("kv_lora",),
            "mixer.wuk": ("kv_lora", "heads", None),
            "mixer.wuv": ("kv_lora", "heads", None),
            "mixer.wo": ("heads", None, "embed_fsdp"),
        })
    else:
        ax.update({
            "mixer.z_proj": ("embed_fsdp", "ssm_inner"),
            "mixer.x_proj": ("embed_fsdp", "ssm_inner"),
            "mixer.bc_proj": ("embed_fsdp", None),
            "mixer.dt_proj": ("embed_fsdp", None),
            "mixer.conv_wx": ("conv", "ssm_inner"),
            "mixer.conv_bx": ("ssm_inner",),
            "mixer.conv_wbc": ("conv", None), "mixer.conv_bbc": (None,),
            "mixer.a_log": (None,), "mixer.d_skip": (None,),
            "mixer.dt_bias": (None,), "mixer.norm": ("ssm_inner",),
            "mixer.out_proj": ("ssm_inner", "embed_fsdp"),
        })
    if ffn != "none":
        ax["ln2"] = ("embed",)
        mlp = {"wi_gate": ("embed_fsdp", "ff"), "wi_up": ("embed_fsdp", "ff"),
               "wo": ("ff", "embed_fsdp")}
        if ffn == "moe":
            ax.update({"ffn.router": ("embed", None),
                       "ffn.wi_gate": ("expert", "embed_fsdp", "ff"),
                       "ffn.wi_up": ("expert", "embed_fsdp", "ff"),
                       "ffn.wo": ("expert", "ff", "embed_fsdp")})
            if cfg.moe_shared_experts:
                ax.update({f"ffn.shared.{k}": v for k, v in mlp.items()})
        else:
            ax.update({f"ffn.{k}": v for k, v in mlp.items()})
    return ax


def _sublayer_cache_axes(cfg: ModelConfig, sig: LayerSig) -> Dict[str, tuple]:
    """The logical axes of one layer's cache by its keys (the reference's
    without the leading "layers" axis)."""
    if sig[0] == "attn":
        axes = ("batch", "decode_cache_seq", "kv_heads", None)
        return {"k": axes, "v": axes}
    if sig[0] == "mla":
        return {"ckv": ("batch", "decode_cache_seq", None),
                "krope": ("batch", "decode_cache_seq", None)}
    return {"conv_x": ("batch", None, "ssm_inner"),
            "conv_bc": ("batch", None, None),
            "state": ("batch", None, None, None)}


def _moe(p: L.MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE layer: ``moe_impl="ep"`` (expert parallel) runs
    :func:`.moe_ep.moe_fwd_ep`, which is ``moe_fwd`` unless a mesh with a
    "model" dim that divides the experts is active."""
    if cfg.moe_impl == "ep":
        from .moe_ep import moe_fwd_ep
        return moe_fwd_ep(p, x, cfg)
    return p(x)


def _decode_sublayer(cfg: ModelConfig, p: DecoderLayer,
                     cache: Dict[str, torch.Tensor], x: torch.Tensor,
                     pos: int) -> torch.Tensor:
    """The layer on one position; its cache is updated in place."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    mixer = p.sig[0]
    if mixer == "attn":
        h = L.attention_decode(p.mixer, h, cache, cfg, pos)
    elif mixer == "mla":
        h = L.mla_decode(p.mixer, h, cache, cfg, pos)
    else:
        h = SSM.ssm_decode(p.mixer, h, cache, cfg)
    return _apply_ffn(p, x + SH.shard_as(h, "batch", "seq", "embed_act"))


def _init_sublayer_cache(cfg: ModelConfig, sig: LayerSig, batch: int,
                         max_len: int, dtype: torch.dtype,
                         device) -> Dict[str, torch.Tensor]:
    if sig[0] == "attn":
        return L.init_attention_cache(cfg, batch, max_len, dtype, device)
    if sig[0] == "mla":
        return L.init_mla_cache(cfg, batch, max_len, dtype, device)
    return SSM.init_ssm_cache(cfg, batch, dtype, device)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """The decoder's weights: ``embed`` [padded vocab, d] (token input),
    ``layers``, ``final_norm`` and ``head`` [d, padded vocab] (untied)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        sigs = plan_sigs(cfg)
        dt = L._dtype(cfg)
        self.cfg = cfg
        if cfg.input_mode == "tokens":
            self.embed = L._init(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                                 dt, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, sig, gen, device) for sig in sigs)
        self.final_norm = L.init_rms_norm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.head = L._init(gen, (cfg.d_model, cfg.padded_vocab), 0.02,
                                dt, device)

    def forward(self, inputs: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self, self.cfg, inputs, positions)


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device: DeviceLike = DEFAULT_DEVICE) -> Model:
    """A :class:`Model` with random weights: embedding and head N(0, 0.02²)
    over the padded vocab, projections N(0, 1/fan_in), norms 0 (gain 1).
    ``key`` is a seed or a ``torch.Generator`` on ``device``. The numbers
    are not the reference's (another generator); carry those with
    :func:`repro_torch.convert.model_params_from_numpy`."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(key))
    return Model(cfg, gen, dev)


def params_logical_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Every parameter's logical axes by its name in :class:`Model`
    (``named_parameters()``); built from the config alone, so that a
    full-size model's shardings need no tensor."""
    ax: Dict[str, tuple] = {}
    if cfg.input_mode == "tokens":
        ax["embed"] = ("vocab", "embed")
    for i, sig in enumerate(plan_sigs(cfg)):
        ax.update({f"layers.{i}.{k}": v
                   for k, v in _sublayer_axes(cfg, sig).items()})
    ax["final_norm"] = ("embed",)
    if not cfg.tie_embeddings:
        ax["head"] = ("embed", "vocab")
    return ax


def cache_logical_axes(cfg: ModelConfig) -> Cache:
    """The cache's logical axes in :func:`init_cache`'s layout."""
    return {"layers": [_sublayer_cache_axes(cfg, sig)
                       for sig in plan_sigs(cfg)],
            "pos": ()}


def _embed(params: Model, cfg: ModelConfig, inputs: torch.Tensor):
    """Token embeddings (a lookup; over a vocab-sharded table a masked
    partial sum) or the embeddings cast."""
    if cfg.input_mode != "tokens":
        return inputs.to(L._dtype(cfg))
    if SH.is_dtensor(params.embed):
        return _sharded_embed(params.embed, inputs)
    return F.embedding(inputs, params.embed)


def _sharded_embed(embed, ids):
    """The lookup on DTensors: each rank looks its batch shard's ids up in
    its vocab slice (zero rows for ids outside it); the rows are partial
    over the mesh dims that split the vocab."""
    mesh = embed.device_mesh
    vdims = SH.shard_dims(embed, 0)
    first = _slice_start(mesh, vdims)
    batch = SH.shard_dims(ids, 0) if SH.is_dtensor(ids) else []

    def local(idl, el):
        rel = idl.long() - first * el.shape[0]
        out = F.embedding(rel.clamp(0, el.shape[0] - 1), el)
        return out.masked_fill(((rel < 0) | (rel >= el.shape[0]))[..., None],
                               0)

    id_pl = SH.layout(mesh, shard0=batch)
    table = SH.gathered(embed)
    return SH.run_local(local, mesh, (ids, table), (id_pl, table.placements),
                        SH.layout(mesh, shard0=batch, partial=vdims),
                        (id_pl, SH.partial_over(table.placements, batch)))


def forward(params: Model, cfg: ModelConfig, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: int tokens [B, S] or embeddings [B, S, d]. Returns logits
    [B, S, padded vocab], the pad region -1e30."""
    x = SH.shard_as(_embed(params, cfg, inputs), "batch", "seq", "embed_act")
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.layers:
        x = (checkpoint(layer, x, positions, use_reentrant=False,
                        context_fn=_remat_contexts) if remat
             else layer(x, positions))
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _lm_head(params, cfg, x)


def _remat_contexts():
    """Remat's contexts: none for the forward; for the recompute, which a
    CUDA backward runs on autograd's own thread, the forward's sharding
    rules."""
    return contextlib.nullcontext(), SH.same_rules()


def _lm_head(params: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab; the pad region set to -1e30 in place
    (safe under autograd: the product's backward does not read its
    output). On DTensors each rank's batch shard against its vocab slice
    (:func:`.layers._sharded_matmul`), the pad region masked by each rank
    in its slice."""
    w = params.embed.t() if cfg.tie_embeddings else params.head
    if SH.is_dtensor(w):
        first = _slice_start(w.device_mesh, SH.shard_dims(w, 1))

        def local(xl, wl):
            return _masked_logits(xl @ wl, cfg, first * wl.shape[-1])

        logits = L._sharded_matmul(x, w, local)
    else:
        logits = _masked_logits(x @ w, cfg, 0)
    return SH.shard_as(logits, "batch", "seq", "vocab")


def _masked_logits(logits: torch.Tensor, cfg: ModelConfig,
                   first: int) -> torch.Tensor:
    """Logits of vocab ids ``first``.. with the pad ids (>= vocab_size)
    set to -1e30 in place."""
    pad = cfg.vocab_size - first
    if pad < logits.shape[-1]:
        logits[..., max(pad, 0):] = L.NEG_INF
    return logits


def loss_fn(params: Model, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal LM cross-entropy (mean over tokens) plus the z-loss
    1e-4 · mean(logz²), in float32: ``batch`` holds ``inputs`` (tokens
    [B, S] or embeddings [B, S, d]), ``labels`` [B, S] and optionally
    ``positions``. logz = log Σ exp(logit - m) + m with the row max m
    detached, as the reference's ``stop_gradient``; the gold logit is
    gathered (the reference's masked sum over the vocab picks the same
    single value). Over a vocab-sharded mesh the [B, S] statistics are
    all-reduced, the logits stay sharded."""
    logits = forward(params, cfg, batch["inputs"],
                     batch.get("positions")).float()
    m = SH.shard_as(logits.amax(dim=-1, keepdim=True).detach(),
                    "batch", "seq", None)
    sumexp = SH.shard_as(torch.exp(logits - m).sum(dim=-1), "batch", "seq")
    logz = torch.log(sumexp) + m[..., 0]
    gold = SH.shard_as(_gold_logit(logits, batch["labels"]), "batch", "seq")
    return torch.mean(logz - gold) + 1e-4 * torch.mean(logz.square())


def _gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[b, s, labels[b, s]]: a gather, or, on vocab-sharded DTensor
    logits, the reference's masked sum over each rank's vocab slice,
    summed over the ranks (so the logits stay sharded)."""
    if not SH.is_dtensor(logits):
        return logits.gather(-1, labels.long()[..., None])[..., 0]
    mesh = logits.device_mesh
    batch = SH.shard_dims(logits, 0)
    first = _slice_start(mesh, SH.shard_dims(logits, logits.dim() - 1))

    def local(lg, lb):
        start = first * lg.shape[-1]
        ids = torch.arange(start, start + lg.shape[-1], device=lg.device)
        hit = ids == lb.long()[..., None]
        return torch.where(hit, lg, torch.zeros((), dtype=lg.dtype,
                                                 device=lg.device)).sum(-1)

    return SH.run_local(
        local, mesh, (logits, labels),
        (logits.placements, SH.layout(mesh, shard0=batch)),
        SH.layout(mesh, shard0=batch,
                  partial=SH.shard_dims(logits, logits.dim() - 1)))


def _slice_start(mesh, dims) -> int:
    """This rank's shard index of a tensor dim split over the mesh dims
    ``dims`` (indices, the first major): its slice starts at that times
    the local size."""
    return SH.mesh_index(mesh, [mesh.mesh_dim_names[i] for i in dims])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = DEFAULT_DEVICE) -> Cache:
    """Per layer its mixer's cache (attention: KV, a ring buffer of
    ``min(max_len, window)`` slots for sliding-window configs; MLA: the
    compressed stream; SSM: convolution windows and the float32 state),
    and the synchronized position."""
    dev = resolve_device(device)
    dt = L._dtype(cfg)
    return {"layers": [_init_sublayer_cache(cfg, sig, batch, max_len, dt,
                                            dev) for sig in plan_sigs(cfg)],
            "pos": 0}


def decode_step(params: Model, cache: Cache, cfg: ModelConfig,
                inputs: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One synchronized decode step. inputs: [B, 1] tokens or [B, 1, d]
    embeddings. Returns logits [B, 1, padded vocab] and the cache at
    ``pos + 1``; its tensors are updated in place."""
    pos = int(cache["pos"])
    x = SH.shard_as(_embed(params, cfg, inputs), "batch", None, "embed_act")
    for layer, lc in zip(params.layers, cache["layers"]):
        x = _decode_sublayer(cfg, layer, lc, x, pos)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _lm_head(params, cfg, x), {"layers": cache["layers"],
                                      "pos": pos + 1}
