"""Knowledge-consolidation losses (paper §3.3).

The elastic submodels are trained against the frozen base model's logits:

    L = lambda_kd * T^2 * KL(softmax(t/T) || softmax(s/T))
      + (1 - lambda_kd) * CE(labels, s)

plus an optional feature-matching term. The teacher's side is detached
(the reference's ``stop_gradient``).

Given ``vocab``, logits narrower than it are a 'model' rank's columns of
the vocabulary (``models/tp.py``): the losses then combine the shards'
maxima, exponential sums, label logits and KL terms over the axis (sums
through ``collectives.reduce_from``: the same loss on every rank, each
rank's logits getting their own gradient) and never gather the (T, V)
logits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.models import tp


def _masked_mean(per_tok: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(per_tok)
    mask = mask.to(per_tok.dtype)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _lse(logits: torch.Tensor, group) -> torch.Tensor:
    """The log-sum-exp over the last axis of logits whose columns are
    spread over ``group``'s ranks (keepdim): the same on every rank."""
    with torch.no_grad():
        m = torch.amax(logits, dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    s = C.reduce_from(torch.sum(torch.exp(logits - m), dim=-1,
                                keepdim=True), group)
    return m + torch.log(s)


def kl_distill(student_logits: torch.Tensor, teacher_logits: torch.Tensor, *,
               temperature: float = 1.0,
               mask: Optional[torch.Tensor] = None,
               vocab: Optional[int] = None) -> torch.Tensor:
    """Token-mean KL(teacher || student) with temperature scaling.
    logits: (..., vocab) or a rank's columns of it (module note: there
    ``sum p_t (t - s) / T - lse_t + lse_s``, each log-sum-exp whole);
    ``mask``: (...,) 0/1 validity weights."""
    t = temperature
    group = tp.vocab_group(student_logits, vocab)
    if group is None:
        s_log = torch.log_softmax(student_logits / t, dim=-1)
        t_log = torch.log_softmax(teacher_logits.detach() / t, dim=-1)
        t_prob = torch.exp(t_log)
        per_tok = torch.sum(t_prob * (t_log - s_log), dim=-1) * (t * t)
        return _masked_mean(per_tok, mask)
    s_t, t_t = student_logits / t, teacher_logits.detach() / t
    t_lse = _lse(t_t, group)
    t_prob = torch.exp(t_t - t_lse)
    cross = C.reduce_from(torch.sum(t_prob * (t_t - s_t), dim=-1), group)
    per_tok = (cross - t_lse[..., 0] + _lse(s_t, group)[..., 0]) * (t * t)
    return _masked_mean(per_tok, mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token CE. labels: int (...,); logits: (..., vocab) or a
    rank's columns of it (module note: there the label's logit, summed
    over the ranks, less the whole log-sum-exp)."""
    group = tp.vocab_group(logits, vocab)
    labels = labels.long()
    if group is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        return -_masked_mean(ll, mask)
    cols = logits.shape[-1]
    local = labels - dist.get_rank(group) * cols
    mine = (local >= 0) & (local < cols)
    picked = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    picked = C.reduce_from(picked * mine.to(picked.dtype), group)
    return -_masked_mean(picked - _lse(logits, group)[..., 0], mask)


def consolidation_loss(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor, labels: torch.Tensor, *,
                       kd_weight: float = 1.0, temperature: float = 1.0,
                       mask: Optional[torch.Tensor] = None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Paper Eq. (5); ``kd_weight=1.0`` is pure KD."""
    loss = kd_weight * kl_distill(student_logits, teacher_logits,
                                  temperature=temperature, mask=mask,
                                  vocab=vocab)
    if kd_weight < 1.0:
        loss = loss + (1.0 - kd_weight) * cross_entropy(
            student_logits, labels, mask=mask, vocab=vocab)
    return loss


def feature_match(student_feats: torch.Tensor, teacher_feats: torch.Tensor,
                  *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-squared feature matching (optional auxiliary term)."""
    d = student_feats - teacher_feats.detach()
    return _masked_mean(torch.mean(d * d, dim=-1), mask)
