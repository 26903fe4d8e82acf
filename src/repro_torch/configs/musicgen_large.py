"""musicgen-large [audio] — arXiv:2306.05284 (hf).

48L decoder-only over EnCodec tokens: d_model 2048, 32 heads MHA (kv=32),
head_dim 64, d_ff 8192, vocab 2048 (one codebook head). The EnCodec frontend
and the 4-codebook delay-pattern interleave are the modality STUB:
``input_specs()`` provides precomputed frame embeddings [B, S, d_model]
(sum of codebook embeddings), per the assignment brief.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    input_mode="embeddings",
    rope_theta=10_000.0,
)
