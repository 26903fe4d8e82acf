"""qwen3-8b [dense] — hf:Qwen/Qwen3-8B.

36L, d_model 4096, 32 heads GQA (kv=8), head_dim 128, SwiGLU d_ff 12288,
vocab 151936, per-head qk RMS-norm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_8b",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1_000_000.0,
)
