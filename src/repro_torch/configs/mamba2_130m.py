"""mamba2-130m [ssm] — arXiv:2405.21060 (unverified tier).

24L attention-free SSD blocks: d_model 768, expand 2 (d_inner 1536),
ssm_state 128, head_dim 64 (24 ssm heads), vocab 50280. O(1) decode state
=> runs the ``long_500k`` cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    ssm_conv=4,
    tie_embeddings=True,
)
