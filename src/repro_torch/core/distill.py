"""Knowledge-consolidation losses (paper §3.3).

The elastic submodels are trained against the frozen base model's logits:

    L = lambda_kd * T^2 * KL(softmax(t/T) || softmax(s/T))
      + (1 - lambda_kd) * CE(labels, s)

plus an optional feature-matching term. The teacher's side is detached
(the reference's ``stop_gradient``).
"""
from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(per_tok: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(per_tok)
    mask = mask.to(per_tok.dtype)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def kl_distill(student_logits: torch.Tensor, teacher_logits: torch.Tensor, *,
               temperature: float = 1.0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean KL(teacher || student) with temperature scaling.
    logits: (..., vocab); ``mask``: (...,) 0/1 validity weights."""
    t = temperature
    s_log = torch.log_softmax(student_logits / t, dim=-1)
    t_log = torch.log_softmax(teacher_logits.detach() / t, dim=-1)
    t_prob = torch.exp(t_log)
    per_tok = torch.sum(t_prob * (t_log - s_log), dim=-1) * (t * t)
    return _masked_mean(per_tok, mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. labels: int (...,); logits: (..., vocab)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -_masked_mean(ll, mask)


def consolidation_loss(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor, labels: torch.Tensor, *,
                       kd_weight: float = 1.0, temperature: float = 1.0,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper Eq. (5); ``kd_weight=1.0`` is pure KD."""
    loss = kd_weight * kl_distill(student_logits, teacher_logits,
                                  temperature=temperature, mask=mask)
    if kd_weight < 1.0:
        loss = loss + (1.0 - kd_weight) * cross_entropy(
            student_logits, labels, mask=mask)
    return loss


def feature_match(student_feats: torch.Tensor, teacher_feats: torch.Tensor,
                  *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-squared feature matching (optional auxiliary term)."""
    d = student_feats - teacher_feats.detach()
    return _masked_mean(torch.mean(d * d, dim=-1), mask)
