"""rwkv6-3b "Finch" — attention-free, data-dependent decay linear attention.
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]

num_heads is nominal (d_model / head_dim = 40 WKV heads); there is no
softmax attention anywhere (long_500k eligible — O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig, Segment

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    segments=(Segment("rwkv", 32),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, chunk=64),
    source="arXiv:2404.05892",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("rwkv", 2),),
    rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=4, chunk=16),
)
