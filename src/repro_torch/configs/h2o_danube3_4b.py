"""h2o-danube-3-4b [dense] — arXiv:2401.16818 (unverified tier).

24L, d_model 3840, 32 heads GQA (kv=8), head_dim 120, SwiGLU d_ff 10240,
vocab 32000, mistral-style sliding-window attention (window 4096). The SWA
ring-buffer KV cache bounds decode state, so this arch runs the ``long_500k``
cell (DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube3_4b",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    act="silu",
    sliding_window=4096,
    rope_theta=10_000.0,
)
