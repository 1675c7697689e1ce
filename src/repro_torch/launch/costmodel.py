"""Analytic HBM traffic of one step on one device of a mesh, by component:
the JAX package's ``launch/costmodel.py``. All quantities are per device
per step, bfloat16 parameters and activations, float32 optimizer state;
``mesh_shape`` gives the sizes of the 'model', 'data' and 'pod' axes
(missing ones count 1; the cost-model audit (``obs/costaudit.py``) reads
the decode term at one device). The port trains and serves in float32;
the model is ported as it is, since the audit calibrates its own
bandwidth and only the ratios between its cells matter.

train (remat on):
    params:       2 reads (fwd + recompute) + 1 grad-time read      = 3 x P
    grads:        1 write + 1 read (optimizer)                      = 2 x P
    optimizer:    mu, nu fp32 read+write (16 B/param) + param write
    activations:  layer-boundary saves: write+read of (B, S, D) per layer
                  + alpha x per-layer working set
    logits:       fp32 write+read (B, S, V_local)
prefill: 1 x param read + working set + KV writes.
decode:  1 x param read + full cache read + negligible activations.

P is the parameters over the 'model' axis, B the batch over the data
axes, V the vocabulary over 'model' where it divides; the cache is split
over every axis. Its bytes are those of the reference's decode state at
bfloat16 (``launch/specs.py``), every leaf counted, its int32 positions
included.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as SP
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

BF16 = 2
F32 = 4
ALPHA_WORKING = 8.0   # intra-layer activation tensors per boundary tensor


def _param_bytes_local(cfg: ModelConfig, chips_model: int) -> float:
    return cm.param_count(tfm.model_spec(cfg)) * BF16 / chips_model


def _cache_bytes_local(cfg: ModelConfig, shape: ShapeConfig,
                       chips: Dict[str, int]) -> float:
    total = SP.state_nbytes(SP.cache_specs(cfg, shape))
    div = chips.get("model", 1) * chips.get("data", 1) * chips.get("pod", 1)
    return float(total) / div


def memory_traffic(cfg: ModelConfig, shape: ShapeConfig, *,
                   mesh_shape: Optional[Dict[str, int]] = None
                   ) -> Dict[str, float]:
    """Bytes one step of ``shape`` moves on one device of a mesh of
    ``mesh_shape`` (default: one device), by component."""
    mesh_shape = mesh_shape or {}
    chips_model = mesh_shape.get("model", 1)
    chips_data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    b_loc = max(shape.global_batch // chips_data, 1)
    s = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model
    layers = cfg.num_layers + cfg.encoder_layers
    v_loc = cfg.vocab_size / (chips_model if cfg.vocab_size % chips_model == 0
                              else 1)

    p_local = _param_bytes_local(cfg, chips_model)
    boundary = b_loc * s * d * BF16
    out: Dict[str, float] = {}
    if shape.kind == "train":
        out["params"] = 3 * p_local
        out["grads"] = 2 * p_local
        out["optimizer"] = p_local / BF16 * F32 * 4 + p_local
        out["activations"] = layers * boundary * (2 + 2 + 2 * ALPHA_WORKING)
        out["logits"] = 3 * b_loc * s * v_loc * F32
    elif shape.kind == "prefill":
        out["params"] = p_local
        out["activations"] = layers * boundary * (1 + ALPHA_WORKING)
        out["kv_write"] = _cache_bytes_local(
            cfg, ShapeConfig("x", shape.seq_len, shape.global_batch,
                             "decode"), mesh_shape)
        out["logits"] = b_loc * shape.seq_len * v_loc * F32
    else:  # decode
        out["params"] = p_local
        out["cache"] = _cache_bytes_local(cfg, shape, mesh_shape)
        out["activations"] = layers * boundary * (1 + ALPHA_WORKING)
        out["logits"] = b_loc * v_loc * F32
    out["total"] = float(sum(out.values()))
    return out
