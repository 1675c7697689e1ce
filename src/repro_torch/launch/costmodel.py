"""Analytic HBM traffic of one decode step on one device, by component: the
decode terms of the JAX package's ``launch/costmodel.py``, which the
cost-model audit (``obs/costaudit.py``) reads. The train and prefill terms
and the mesh divisors are not ported: the port has no caller for them.

Parameters and activations count at bfloat16, as in the reference. The
port serves in float32; the model is ported as it is, since the audit
calibrates its own bandwidth and only the ratios between its cells matter:

decode:  1 x param read + full cache read + negligible activations.

The cache bytes are those of the reference's decode state at bfloat16
(``launch/specs.py``), every leaf counted, its int32 positions included.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as SP
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

BF16 = 2
F32 = 4
ALPHA_WORKING = 8.0   # intra-layer activation tensors per boundary tensor


def memory_traffic(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Bytes one decode step of ``shape`` moves on one device, by
    component."""
    if shape.kind != "decode":
        raise ValueError(f"only decode traffic is ported, not {shape.kind!r}")
    b = max(shape.global_batch, 1)
    layers = cfg.num_layers + cfg.encoder_layers
    boundary = b * cfg.d_model * BF16
    out: Dict[str, float] = {
        "params": float(cm.param_count(tfm.model_spec(cfg)) * BF16),
        "cache": float(SP.state_nbytes(SP.cache_specs(cfg, shape))),
        "activations": layers * boundary * (1 + ALPHA_WORKING),
        "logits": b * float(cfg.vocab_size) * F32,
    }
    out["total"] = float(sum(out.values()))
    return out
