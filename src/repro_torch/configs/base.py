"""Config schema for all architectures + FlexRank settings.

A model is described by a sequence of *segments*; each segment is one
``lax.scan`` over ``count`` identical blocks with stacked params. Block-level
heterogeneity that XLA can express as data (e.g. gemma3's 5:1 local:global
attention windows) stays inside one segment via per-layer scanned scalars;
structural heterogeneity (zamba2's shared attention block, vision cross-attn
interleaves, enc-dec) becomes separate segments or composite "unit" blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0           # per shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    rope_head_dim: int = 32
    nope_head_dim: int = 64
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2                # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128
    num_groups: int = 1            # B/C groups (GVA-style)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" time-mix / channel-mix."""
    head_dim: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    mix_lora: int = 32             # rank of the ddlerp token-shift LoRA
    # WKV chunk kept small: the chunk-local pairwise decay tensor carries the
    # key-channel dim (Q, Q, H, N), unlike SSD's (Q, Q, H) — 64 keeps it in MB.
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class Segment:
    """One scanned stack of ``count`` blocks of a given kind.

    kinds: 'attn' (self-attn + FFN/MoE), 'mamba', 'rwkv',
           'zamba_unit' (mamba_per_unit mambas + 1 *shared* attn block),
           'vision_unit' (self_per_unit self-attn + 1 cross-attn block),
           'encoder' (bidirectional attn + FFN), 'decoder' (self + cross + FFN)
    """
    kind: str
    count: int
    mamba_per_unit: int = 5
    self_per_unit: int = 4


@dataclasses.dataclass(frozen=True)
class FlexRankConfig:
    """Which linears get factorized and the elastic budget grid."""
    enabled: bool = False
    budgets: Tuple[float, ...] = (0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
    # '/'-separated path substrings that are *excluded* from factorization
    exclude: Tuple[str, ...] = ("router", "embed", "lm_head", "norm", "conv",
                                "a_log", "dt_bias", "decay", "mix", "bonus")
    max_rank: Optional[int] = None       # cap factor rank (None = min(m, n))
    rank_levels: int = 16                # probing grid per layer (paper's K)
    kd_temperature: float = 1.0
    kd_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int                # decoder/backbone layers (sum over segments)
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    head_dim: Optional[int] = None         # default d_model // num_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # attention windows: (local_window, global_every) -> 5:1 pattern etc.
    local_window: Optional[int] = None
    global_every: int = 0                  # 0 = all global
    encoder_layers: int = 0                # enc-dec (seamless)
    cross_attn_kv_len: int = 0             # vlm/audio: frontend embed count
    frontend_dim: int = 0                  # stub modality embedding dim
    tie_embeddings: bool = True
    rope_base: float = 500000.0
    norm_eps: float = 1e-6
    max_seq_len: int = 131072
    attn_logit_softcap: float = 0.0
    flexrank: FlexRankConfig = FlexRankConfig()
    # notes for DESIGN.md provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.num_heads, 1)

    def with_flexrank(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, flexrank=dataclasses.replace(self.flexrank, enabled=True, **kw))

    def scaled_down(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

# archs allowed to run long_500k (sub-quadratic / O(1)-state decode)
LONG_CONTEXT_ARCHS = ("zamba2-7b", "rwkv6-3b")
