"""zamba2-7b — hybrid: Mamba2 backbone + shared full-attention block.
[arXiv:2411.15242; unverified]

Interpretation (DESIGN.md): 81 layers = 13 units x (5 mamba + 1 shared attn)
+ 3 trailing mamba. The attention block's weights are *shared* across all 13
applications (Zamba's parameter-sharing trick); its KV caches are per-instance.
ssm_state=64 per the assignment.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, Segment

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    segments=(Segment("zamba_unit", 13, mamba_per_unit=5), Segment("mamba", 3)),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=128),
    rope_base=10000.0,
    source="arXiv:2411.15242 (unverified)",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=7,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("zamba_unit", 2, mamba_per_unit=2), Segment("mamba", 1)),
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    rope_base=10000.0,
)
