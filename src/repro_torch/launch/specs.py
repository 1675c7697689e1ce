"""Decode-state shapes of a cell, without allocating them: the part of the
JAX package's ``launch/specs.py`` that the cost model reads
(``frontend_len`` and ``cache_specs``). The state is built on the ``meta``
device, so a full-size config costs no memory. Its input, parameter and
optimizer specs and its step functions belong to training's launch
modes, which are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tfm

COMPUTE_DTYPE = torch.bfloat16
INT32 = 4


def frontend_len(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.cross_attn_kv_len or 1601
    if cfg.family == "audio":
        return 1024  # precomputed speech frames (stub frontend)
    return 0


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype=COMPUTE_DTYPE) -> Dict:
    """The decode state of ``shape`` (batch ``global_batch``, ``seq_len``
    positions) on ``meta``: shapes and dtypes only. Cross-attention K/V
    buffers are included for vlm/audio (precomputed once a request)."""
    ckv = frontend_len(cfg) if cfg.family in ("vlm", "audio") else 0
    return tfm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 dtype=dtype, device="meta",
                                 cross_kv_len=ckv)


def state_nbytes(state) -> int:
    """Bytes of a decode state laid out as the reference lays it out: every
    tensor, plus ``pos`` (an int32 scalar there) and each ``idx`` (an int32
    a stacked block, the lead dims of its ``k`` or MLA ``c_kv``), which the
    port keeps as host ints."""
    if state is None:
        return 0
    if isinstance(state, (list, tuple)):
        return sum(state_nbytes(s) for s in state)
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    total = 0
    for k, v in state.items():
        if k == "pos":
            total += INT32
        elif k == "idx":
            c = state["k"] if "k" in state else state["c_kv"]
            lead = c.shape[:c.dim() - (4 if "k" in state else 3)]
            total += INT32 * int(np.prod(lead, dtype=np.int64))
        else:
            total += state_nbytes(v)
    return total
