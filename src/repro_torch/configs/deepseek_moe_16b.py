"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]

Layer 0 uses a dense FFN (d_ff=10944, per the public config); layers 1..27
are MoE with per-expert d_ff=1408.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, Segment

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    segments=(Segment("attn_dense", 1), Segment("attn", 27)),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, d_ff_shared=1408),
    rope_base=10000.0,
    source="arXiv:2401.06066 + hf:deepseek-ai/deepseek-moe-16b-base",
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("attn_dense", 1), Segment("attn", 2)),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  num_shared=2, d_ff_shared=32),
    rope_base=10000.0,
)
