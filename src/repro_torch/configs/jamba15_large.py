"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf).

72L in 9 periods of 8 (1 attention + 7 mamba, the paper's 1:7 interleave):
d_model 8192, attention 64 heads GQA (kv=8, head_dim 128); SSM blocks use
the SSD formulation (state 128, head_dim 64). MoE (16 experts, top-2,
expert d_ff 24576) on every other layer. vocab 65536. SSM-dominated state
=> runs the ``long_500k`` cell (attention KV is 9 layers only).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba15_large",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    act="silu",
    layer_pattern=("attn", "ssm", "ssm", "ssm", "ssm", "ssm", "ssm", "ssm"),
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_layer_start=1,
    moe_every=2,
    ssm=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    ssm_conv=4,
    rope_theta=10_000.0,
)
