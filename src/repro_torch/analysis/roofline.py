"""Flop counts of a model's steps and the H100's peaks to bound them.

The port of ``model_flops`` and ``attention_flops`` from
``repro.analysis.roofline``: arithmetic over :class:`ModelConfig` and
:class:`ShapeConfig`, the same numbers as the reference. The peaks are
the H100 SXM's, from NVIDIA's data sheet (dense rates, 700 W); a bound
is the work over them. The reference's ``Roofline``/``build`` read XLA
HLO costs and wait for a torch cost source (ROADMAP Queue 1).
"""
from __future__ import annotations

from ..models.config import ModelConfig, ShapeConfig

#: dense bf16 tensor-core rate of one H100 SXM, flop/s (NVIDIA data sheet)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s (NVIDIA data sheet)
HBM_BW = 3.35e12


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
