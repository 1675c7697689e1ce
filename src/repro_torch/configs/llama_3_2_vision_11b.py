"""llama-3.2-vision-11b — cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only: 40 layers = 8 units x (4 self-attn + 1 gated cross-attn).
The vision tower is a STUB — input_specs() supplies precomputed patch
embeddings (B, n_patches, frontend_dim) used as cross-attention KV.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    segments=(Segment("vision_unit", 8, self_per_unit=4),),
    frontend_dim=7680,
    cross_attn_kv_len=1601,
    rope_base=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision (unverified)",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("vision_unit", 1, self_per_unit=2),),
    frontend_dim=96,
    cross_attn_kv_len=17,
    rope_base=500000.0,
)
