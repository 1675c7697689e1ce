"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Interpretation notes (DESIGN.md §Arch-applicability): every layer is MoE with
one shared expert (Scout's interleave step is 1); d_ff=8192 is the per-expert
hidden dim. Text backbone only.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, Segment

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    segments=(Segment("attn", 48),),
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  num_shared=1, d_ff_shared=8192),
    rope_base=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    segments=(Segment("attn", 2),),
    moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=96,
                  num_shared=1, d_ff_shared=96),
    rope_base=500000.0,
)
