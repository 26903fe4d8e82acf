"""deepseek-v3-671b [moe] — arXiv:2412.19437 (hf).

61L, d_model 7168, 128 heads with MLA (q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v 128), vocab 129280. First 3 layers dense
(d_ff 18432), remaining 58 layers MoE: 256 routed experts top-8 + 1 shared,
expert d_ff 2048. MTP (multi-token prediction) heads are a training-loss
add-on, not a backbone change — omitted and noted in DESIGN.md.

Decode uses the absorbed-matrix MLA path: the KV cache stores only the
compressed (kv_lora + rope) stream — this is the memory feature that makes
decode_32k fit.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_v3",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,            # qk_nope + qk_rope (derived; MLA path governs)
    d_ff=18432,
    vocab_size=129280,
    act="silu",
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe_num_experts=256,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_shared_experts=1,
    moe_layer_start=3,
    moe_every=1,
    rope_theta=10_000.0,
)
