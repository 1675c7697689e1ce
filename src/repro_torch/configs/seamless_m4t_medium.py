"""seamless-m4t-medium — encoder-decoder, multimodal (speech/text).
[arXiv:2308.11596; hf]

Backbone only per the assignment: 12 encoder + 12 decoder layers, d=1024.
The speech frontend is a STUB — input_specs() supplies precomputed frame
embeddings (B, T_frames, 1024) which the encoder consumes directly.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    segments=(Segment("encoder", 12), Segment("decoder", 12)),
    frontend_dim=1024,
    rope_base=10000.0,
    source="arXiv:2308.11596",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("encoder", 2), Segment("decoder", 2)),
    frontend_dim=64,
    rope_base=10000.0,
)
