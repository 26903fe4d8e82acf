"""Model / shape configuration for the assigned architecture pool (the
port's copy of ``repro.models.config``: pure Python, field for field)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    act: str = "silu"               # "silu" | "gelu" (both gated: SwiGLU/GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_kind: str = "default"      # "default" | "mrope"
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0         # 0 = full attention

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_experts: int = 0     # deepseek shared expert count
    moe_layer_start: int = 0        # first MoE layer (leading layers are dense)
    moe_every: int = 1              # MoE applied every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"         # "gspmd" | "ep" (shard_map expert parallel)

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # hybrid interleave (jamba): kinds within one repeating period
    layer_pattern: Tuple[str, ...] = ()   # e.g. ("ssm","ssm","ssm","attn",...)

    input_mode: str = "tokens"      # "tokens" | "embeddings" (stub frontend)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    logical_rules: Optional[str] = None   # sharding rule-set override name

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the 'model' mesh axis always divides it
        (embedding/head/logits shard cleanly). Logits beyond vocab_size are
        masked to -1e30; labels never reference the pad region."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.ssm and not self.layer_pattern and self.num_heads == 0

    @property
    def period(self) -> int:
        return len(self.layer_pattern) if self.layer_pattern else 1

    def active_params(self) -> int:
        """Approximate active parameter count (per-token, MoE-aware)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self, active_only=False)


def _param_count(c: ModelConfig, active_only: bool) -> int:
    d = c.d_model
    emb = c.vocab_size * d * (1 if c.tie_embeddings else 2)

    def attn_params() -> int:
        if c.mla:
            q = d * c.q_lora_rank + c.q_lora_rank * c.num_heads * (c.qk_nope_head_dim + c.qk_rope_head_dim)
            kv = d * (c.kv_lora_rank + c.qk_rope_head_dim)
            kv += c.kv_lora_rank * c.num_heads * (c.qk_nope_head_dim + c.v_head_dim)
            o = c.num_heads * c.v_head_dim * d
            return q + kv + o
        q = d * c.num_heads * c.head_dim
        kv = 2 * d * c.num_kv_heads * c.head_dim
        o = c.num_heads * c.head_dim * d
        return q + kv + o

    def mlp_params(ff: int) -> int:
        return 3 * d * ff

    def moe_params() -> int:
        n_active = c.moe_top_k + c.moe_shared_experts
        n = n_active if active_only else (c.moe_num_experts + c.moe_shared_experts)
        return n * mlp_params(c.moe_d_ff) + d * c.moe_num_experts

    def ssm_params() -> int:
        di, h, n = c.ssm_d_inner, c.ssm_heads, c.ssm_state
        in_proj = d * (2 * di + 2 * n + h)
        out = di * d
        return in_proj + out + c.ssm_conv * (di + 2 * n) + 2 * h

    total = emb
    pattern = c.layer_pattern or (("ssm",) if c.attention_free else ("attn",))
    reps = c.num_layers // len(pattern)
    for li in range(c.num_layers):
        kind = pattern[li % len(pattern)]
        if kind == "attn" or not c.layer_pattern and not c.ssm:
            total += attn_params()
        if kind == "ssm" or (c.ssm and not c.layer_pattern):
            total += ssm_params()
        # feed-forward
        is_moe = (c.moe_num_experts > 0 and li >= c.moe_layer_start
                  and (li - c.moe_layer_start) % c.moe_every == 0)
        if is_moe:
            total += moe_params()
        elif not (c.ssm and not c.layer_pattern):
            total += mlp_params(c.d_ff)
    return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(c: ModelConfig, layers: int = 2, d_model: int = 64, heads: int = 4,
            kv: Optional[int] = None, ff: int = 128, vocab: int = 512) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        num_layers=layers, d_model=d_model, d_ff=ff, vocab_size=vocab)
    if c.num_heads:
        kw.update(num_heads=heads, num_kv_heads=min(kv if kv is not None else max(1, heads // 2), heads),
                  head_dim=max(8, d_model // heads))
    else:
        kw.update(num_heads=0, num_kv_heads=0, head_dim=0)
    if c.moe_num_experts:
        kw.update(moe_num_experts=4, moe_top_k=2, moe_d_ff=ff,
                  moe_shared_experts=min(c.moe_shared_experts, 1),
                  moe_layer_start=min(c.moe_layer_start, 1), moe_every=c.moe_every)
    if c.mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    if c.ssm:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if c.layer_pattern:
        pat = c.layer_pattern[:4] if layers % len(c.layer_pattern[:4]) == 0 else c.layer_pattern
        # keep a 1-attn + (p-1)-ssm period that divides num_layers
        kw.update(layer_pattern=("attn", "ssm"), num_layers=max(2, layers - layers % 2))
    if c.sliding_window:
        kw.update(sliding_window=64)
    if c.mrope_sections:
        hd = kw.get("head_dim", 16)
        kw.update(mrope_sections=(hd // 4, hd // 8, hd // 8))
    return dataclasses.replace(c, **kw)
