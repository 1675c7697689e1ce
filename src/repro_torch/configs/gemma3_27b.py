"""gemma3-27b — dense, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-27b-pt pattern; assignment tag unverified]

Every 6th layer is global; locals use a 1024-token sliding window. Expressed
as a *data-dependent window* inside one segment (the per-layer window of
``transformer.window_schedule``).
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    segments=(Segment("attn", 62),),
    local_window=1024,
    global_every=6,
    rope_base=1000000.0,
    max_seq_len=131072,
    source="hf:google/gemma-3-27b (unverified)",
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("attn", 6),),
    local_window=16,
    global_every=6,
    rope_base=1000000.0,
)
