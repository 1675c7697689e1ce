"""deepseek-7b — llama-architecture dense reference.
[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base]
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    segments=(Segment("attn", 30),),
    rope_base=10000.0,
    source="arXiv:2401.02954",
)

SMOKE = ModelConfig(
    name="deepseek7b-smoke",
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
