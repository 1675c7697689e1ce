"""Architecture registry over the configs ported so far."""
from typing import List

from repro_torch.configs.base import (FlexRankConfig, ModelConfig, Segment)
from repro_torch.configs import gemma3_27b, gpt2_small, rwkv6_3b, zamba2_7b

_MODULES = {
    "gemma3-27b": gemma3_27b,
    "gpt2-small": gpt2_small,
    "rwkv6-3b": rwkv6_3b,
    "zamba2-7b": zamba2_7b,
}


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported so far: "
                       f"{sorted(_MODULES)}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


def list_archs() -> List[str]:
    return sorted(_MODULES)


__all__ = ["FlexRankConfig", "ModelConfig", "Segment", "get_config",
           "list_archs"]
