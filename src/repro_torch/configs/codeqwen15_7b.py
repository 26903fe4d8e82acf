"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B.

32L, d_model 4096, 32 heads MHA (kv=32), head_dim 128, SwiGLU d_ff 13440,
vocab 92416. (QKV biases of the qwen1.5 family are omitted — bias terms are
<0.01% of params and do not change sharding or roofline terms.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen15_7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    act="silu",
    rope_theta=1_000_000.0,
)
