"""qwen2-vl-72b [vlm] — arXiv:2409.12191 (hf).

80L backbone: d_model 8192, 64 heads GQA (kv=8), head_dim 128, SwiGLU
d_ff 29568, vocab 152064, M-RoPE with (t, h, w) sections (16, 24, 24) over
the 64 half-dim frequencies. The dynamic-resolution ViT frontend is the
modality STUB: ``input_specs()`` provides precomputed patch embeddings
[B, S, d_model] plus [B, S, 3] M-RoPE positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_72b",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    act="silu",
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    input_mode="embeddings",
    rope_theta=1_000_000.0,
)
