"""Knowledge-distillation loss for SiLQ (paper §3.1, ablations Table 4).

The teacher is the original unquantized model; the student is the
quantized model. The paper's best configuration is *pure* KD
(kd_ratio=1.0) at temperature 1; ``kd_ratio``/``kd_temperature`` stay
configurable for the ablations.
"""
from __future__ import annotations

from typing import Optional

import torch


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft cross-entropy against the teacher distribution at
    ``temperature``, scaled by T^2 (Hinton et al., 2015) so the gradient
    magnitude is temperature-invariant. Shapes: (..., vocab); ``mask``
    broadcasts over (...)."""
    t = float(temperature)
    sl = student_logits.float() / t
    tl = teacher_logits.detach().float() / t
    log_p_s = torch.log_softmax(sl, dim=-1)
    p_t = torch.softmax(tl, dim=-1)
    ce = -torch.sum(p_t * log_p_s, dim=-1) * (t * t)
    return _masked_mean(ce, mask)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard next-token cross entropy (labels already shifted)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def silq_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              labels: torch.Tensor, kd_ratio: float = 1.0,
              kd_temperature: float = 1.0,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """kd_ratio * KD + (1 - kd_ratio) * next-token CE (paper default 1.0)."""
    loss = 0.0
    if kd_ratio > 0.0:
        loss = kd_ratio * kd_loss(student_logits, teacher_logits,
                                  kd_temperature, mask)
    if kd_ratio < 1.0:
        loss = loss + (1.0 - kd_ratio) * next_token_loss(
            student_logits, labels, mask)
    return loss


def _masked_mean(x: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    m = mask.float()
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)
