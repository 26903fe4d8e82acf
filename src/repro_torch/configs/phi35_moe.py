"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct.

32L, d_model 4096, 32 heads GQA (kv=8), head_dim 128, vocab 32064,
16 experts top-2 with expert d_ff 6400 in every layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi35_moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    act="silu",
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=6400,
    moe_layer_start=0,
    moe_every=1,
    rope_theta=10_000.0,
)
