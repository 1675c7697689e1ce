"""gpt2-small — the paper's own main experimental model (Figs. 6-8).

Used by the paper-faithful FlexRank experiments (decompose -> DP -> distill)
at laptop scale; not part of the assigned 10-arch pool.
"""
from repro_torch.configs.base import FlexRankConfig, ModelConfig, Segment

CONFIG = ModelConfig(
    name="gpt2-small",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=50257,
    # one segment per layer: every linear is its own FlexRank group, so the
    # DP produces depth-heterogeneous rank profiles (paper Fig. 6)
    segments=tuple(Segment("attn", 1) for _ in range(12)),
    rope_base=10000.0,
    flexrank=FlexRankConfig(enabled=True),
    source="paper §5 (GPT-2 experiments)",
)

SMOKE = ModelConfig(
    name="gpt2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    segments=tuple(Segment("attn", 1) for _ in range(2)),
    rope_base=10000.0,
    flexrank=FlexRankConfig(enabled=True),
)
