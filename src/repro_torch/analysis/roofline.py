"""Roofline terms of a step on H100s, from its per-device counts.

The port of ``repro.analysis.roofline``:

  compute term    = flops per device / PEAK_FLOPS_BF16
  memory term     = bytes per device / HBM_BW
  collective term = ring-model link bytes per device / LINK_BW

The counts come from :mod:`.cost` (this rank's dispatched ops, the
counterpart of the reference's post-partitioning HLO), so no division by
the device count is needed. ``model_flops`` (6·N·D for training) and
``attention_flops`` are the reference's arithmetic over the global batch;
their sum over the devices' counted flops is ``useful_ratio``.

The peaks are one H100 SXM's (NVIDIA data sheet, dense rates, 700 W).
``LINK_BW`` is the slowest link a 16-wide mesh dim crosses: sixteen GPUs
span two 8-GPU HGX H100 nodes, which talk over one 400 Gb/s NDR
InfiniBand port per GPU (NVIDIA DGX H100 user guide: eight ConnectX-7
adapters), 50e9 bytes/s; inside a node NVLink 4 gives 450e9 bytes/s each
way, so a ring over both is bound by the InfiniBand hop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import ModelConfig, ShapeConfig

#: dense bf16 tensor-core rate of one H100 SXM, flop/s (NVIDIA data sheet)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s (NVIDIA data sheet)
HBM_BW = 3.35e12
#: one 400 Gb/s NDR InfiniBand port per GPU, bytes/s (NVIDIA DGX H100)
LINK_BW = 50e9


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    link_bytes_per_device: float
    model_flops_global: float
    useful_ratio: float           # model_flops / (counted flops × chips)
    bottleneck: str
    per_device_memory_gb: Optional[float] = None
    peak_fraction: float = 0.0    # compute_s / max(all terms)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D for training; 2·N_active·tokens for inference steps."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Quadratic attention term (excluded from 6ND; reported separately)."""
    if cfg.num_heads == 0:
        return 0.0
    n_attn_layers = sum(
        1 for i in range(cfg.num_layers)
        if (not cfg.layer_pattern)
        or cfg.layer_pattern[i % len(cfg.layer_pattern)] == "attn")
    if cfg.ssm and not cfg.layer_pattern:
        n_attn_layers = 0
    hd = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) if cfg.mla
          else cfg.head_dim)
    s, b = shape.seq_len, shape.global_batch
    ctx = min(s, cfg.sliding_window) if cfg.sliding_window else s
    if shape.kind == "decode":
        # one query against the cached context (ring buffer for SWA)
        return n_attn_layers * b * cfg.num_heads * (2.0 * 2 * ctx * hd)
    mult = 3 if shape.kind == "train" else 1  # fwd+bwd
    if cfg.sliding_window and cfg.sliding_window < s:
        per_q = cfg.sliding_window
    else:
        per_q = 0.5 * s  # causal
    return mult * n_attn_layers * b * cfg.num_heads * (2.0 * 2 * per_q * s * hd)


def build(arch: str, shape_cfg: ShapeConfig, cfg: ModelConfig, mesh_name: str,
          chips: int, stats, per_device_memory_bytes: Optional[float] = None
          ) -> Roofline:
    """The three terms of ``stats`` (a :class:`.cost.OpStats`), the
    bottleneck and the useful share of the counted flops."""
    compute_s = stats.flops / PEAK_FLOPS_BF16
    memory_s = stats.bytes_proxy / HBM_BW
    collective_s = stats.collective_link_bytes / LINK_BW
    mf = model_flops(cfg, shape_cfg) + attention_flops(cfg, shape_cfg)
    total = stats.flops * chips
    useful = mf / total if total else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    dominant = max(terms.values()) or 1.0
    return Roofline(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops_per_device=stats.flops,
        hlo_bytes_per_device=stats.bytes_proxy,
        link_bytes_per_device=stats.collective_link_bytes,
        model_flops_global=mf, useful_ratio=useful, bottleneck=bottleneck,
        per_device_memory_gb=(per_device_memory_bytes / 2**30
                              if per_device_memory_bytes else None),
        peak_fraction=compute_s / dominant)
