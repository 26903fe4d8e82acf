"""gemma-2b [dense] — arXiv:2403.08295 (hf).

18L, d_model 2048, 8 heads with MQA (kv=1), head_dim 256, GeGLU d_ff 16384,
vocab 256000, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma_2b",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
