"""minicpm3-4b — dense with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]

MLA dims per the public config: q_lora_rank=768, kv_lora_rank=256,
qk_rope_head_dim=32, qk_nope_head_dim=64, v_head_dim=64 (40 heads).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, Segment

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    segments=(Segment("attn", 62),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
                  nope_head_dim=64, v_head_dim=64),
    rope_base=10000.0,
    source="hf:openbmb/MiniCPM3-4B",
)

SMOKE = ModelConfig(
    name="minicpm3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    segments=(Segment("attn", 2),),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    rope_base=10000.0,
)
