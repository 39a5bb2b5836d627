"""Knowledge-distillation loss for SiLQ (paper §3.1, ablations Table 4).

The teacher is the original unquantized model; the student is the
quantized model. The paper's best configuration is *pure* KD
(kd_ratio=1.0) at temperature 1; ``kd_ratio``/``kd_temperature`` stay
configurable for the ablations.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Denom = Optional[Union[float, torch.Tensor]]


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0,
            mask: Optional[torch.Tensor] = None,
            denom: Denom = None) -> torch.Tensor:
    """Soft cross-entropy against the teacher distribution at
    ``temperature``, scaled by T^2 (Hinton et al., 2015) so the gradient
    magnitude is temperature-invariant. Shapes: (..., vocab); ``mask``
    broadcasts over (...); ``denom``: see :func:`_masked_mean`."""
    t = float(temperature)
    sl = student_logits.float() / t
    tl = teacher_logits.detach().float() / t
    log_p_s = torch.log_softmax(sl, dim=-1)
    p_t = torch.softmax(tl, dim=-1)
    ce = -torch.sum(p_t * log_p_s, dim=-1) * (t * t)
    return _masked_mean(ce, mask, denom)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    denom: Denom = None) -> torch.Tensor:
    """Standard next-token cross entropy (labels already shifted)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask, denom)


def silq_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              labels: torch.Tensor, kd_ratio: float = 1.0,
              kd_temperature: float = 1.0,
              mask: Optional[torch.Tensor] = None,
              denom: Denom = None) -> torch.Tensor:
    """kd_ratio * KD + (1 - kd_ratio) * next-token CE (paper default 1.0)."""
    loss = 0.0
    if kd_ratio > 0.0:
        loss = kd_ratio * kd_loss(student_logits, teacher_logits,
                                  kd_temperature, mask, denom)
    if kd_ratio < 1.0:
        loss = loss + (1.0 - kd_ratio) * next_token_loss(
            student_logits, labels, mask, denom)
    return loss


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                 denom: Denom = None) -> torch.Tensor:
    """The mean of ``x`` over its unmasked entries. ``denom`` replaces
    this batch's own count with a global one (the mask count, or B·T
    unmasked, summed over the data ranks, already at least 1): each
    data rank's loss is then its share of the global batch's mean, and
    the shares sum to it. None: the local mean."""
    if denom is not None:
        return torch.sum(x if mask is None else x * mask.float()) / denom
    if mask is None:
        return torch.mean(x)
    m = mask.float()
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)
