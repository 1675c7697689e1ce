"""Architecture registry: every config of the JAX package."""
from typing import List, Tuple

from repro_torch.configs.base import (LM_SHAPES, LONG_CONTEXT_ARCHS,
                                      FlexRankConfig, ModelConfig, Segment,
                                      ShapeConfig)
from repro_torch.configs import (deepseek_7b, deepseek_moe_16b, gemma3_27b,
                                 gpt2_small, llama4_scout_17b_a16e,
                                 llama_3_2_vision_11b, minicpm3_4b, rwkv6_3b,
                                 seamless_m4t_medium, stablelm_1_6b,
                                 zamba2_7b)

_MODULES = {
    "deepseek-7b": deepseek_7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "gemma3-27b": gemma3_27b,
    "gpt2-small": gpt2_small,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "minicpm3-4b": minicpm3_4b,
    "rwkv6-3b": rwkv6_3b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "stablelm-1.6b": stablelm_1_6b,
    "zamba2-7b": zamba2_7b,
}


# the dry run's archs, in the reference's order: every arch but gpt2-small
ASSIGNED_ARCHS: Tuple[str, ...] = (
    "llama4-scout-17b-a16e", "deepseek-moe-16b", "stablelm-1.6b",
    "minicpm3-4b", "gemma3-27b", "deepseek-7b", "zamba2-7b",
    "seamless-m4t-medium", "llama-3.2-vision-11b", "rwkv6-3b")


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_MODULES)}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


def list_archs() -> List[str]:
    return sorted(_MODULES)


def shapes_for(name: str) -> List[ShapeConfig]:
    """The assigned shape cells of an arch: ``LM_SHAPES``, without
    ``long_500k`` unless the arch is in ``LONG_CONTEXT_ARCHS``."""
    return [s for s in LM_SHAPES
            if s.name != "long_500k" or name in LONG_CONTEXT_ARCHS]


__all__ = ["ASSIGNED_ARCHS", "FlexRankConfig", "LM_SHAPES",
           "LONG_CONTEXT_ARCHS", "ModelConfig", "Segment", "ShapeConfig", "get_config",
           "list_archs", "shapes_for"]
