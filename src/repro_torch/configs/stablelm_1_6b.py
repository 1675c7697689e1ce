"""stablelm-1.6b — plain dense transformer.
[hf:stabilityai/stablelm-2-1_6b; unverified]

Deviation note: StableLM-2 uses LayerNorm and partial rotary (25%); we use the
framework-standard RMSNorm + full rotary (recorded in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    segments=(Segment("attn", 24),),
    rope_base=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b (unverified)",
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("attn", 2),),
    rope_base=10000.0,
)
