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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
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
        x = x + (self.mixer(h) if self.sig[0] == "ssm"
                 else self.mixer(h, positions))
        return _apply_ffn(self, x)


def _apply_ffn(p: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
    if p.sig[1] == "none":
        return x
    h = L.rms_norm(x, p.ln2, p.cfg.norm_eps)
    return x + (_moe(p.ffn, h, p.cfg) if p.sig[1] == "moe" else p.ffn(h))


def _moe(p: L.MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE layer. ``moe_impl="ep"`` (expert parallel) is the reference's
    ``moe_fwd_ep``, which runs ``moe_fwd`` unless a mesh with a "model"
    axis is active; the port does the same and raises under such a mesh."""
    if cfg.moe_impl == "ep":
        mesh = SH.active_mesh()
        if mesh is not None and "model" in SH.axis_sizes(mesh):
            raise NotImplementedError(
                "expert-parallel MoE (moe_impl='ep') under a mesh with a "
                "'model' axis is not ported yet: it waits for ROADMAP "
                "Queue 1, item 4 (production sharding)")
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
    return _apply_ffn(p, x + h)


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


def _embed(params: Model, cfg: ModelConfig, inputs: torch.Tensor):
    if cfg.input_mode == "tokens":
        return params.embed[inputs]
    return inputs.to(L._dtype(cfg))


def forward(params: Model, cfg: ModelConfig, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: int tokens [B, S] or embeddings [B, S, d]. Returns logits
    [B, S, padded vocab], the pad region -1e30."""
    x = _embed(params, cfg, inputs)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.layers:
        x = (checkpoint(layer, x, positions, use_reentrant=False) if remat
             else layer(x, positions))
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _lm_head(params, cfg, x)


def _lm_head(params: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab; the pad region set to -1e30 in place
    (safe under autograd: the product's backward does not read its
    output)."""
    if cfg.tie_embeddings:
        logits = x @ params.embed.t()
    else:
        logits = x @ params.head
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = L.NEG_INF
    return logits


def loss_fn(params: Model, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal LM cross-entropy (mean over tokens) plus the z-loss
    1e-4 · mean(logz²), in float32: ``batch`` holds ``inputs`` (tokens
    [B, S] or embeddings [B, S, d]), ``labels`` [B, S] and optionally
    ``positions``. logz = log Σ exp(logit - m) + m with the row max m
    detached, as the reference's ``stop_gradient``; the gold logit is
    gathered (the reference's masked sum over the vocab picks the same
    single value)."""
    logits = forward(params, cfg, batch["inputs"],
                     batch.get("positions")).float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(logz - gold) + 1e-4 * torch.mean(logz.square())


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
    x = _embed(params, cfg, inputs)
    for layer, lc in zip(params.layers, cache["layers"]):
        x = _decode_sublayer(cfg, layer, lc, x, pos)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _lm_head(params, cfg, x), {"layers": cache["layers"],
                                      "pos": pos + 1}
