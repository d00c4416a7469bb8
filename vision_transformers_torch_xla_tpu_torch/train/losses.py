"""Losses: label-smoothing CE, soft-target CE, the KD loss, top-k counts.

Counterpart of vision_transformers_torch_xla_tpu/train/losses.py. All
reductions are in fp32.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over the batch with optional label smoothing (int labels)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if smoothing > 0.0:
        nll = (1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)
    return nll.mean()


def soft_target_cross_entropy(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """CE against a soft target distribution (mixup/cutmix path)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-targets.float() * logp).sum(dim=-1).mean()


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, base_loss: torch.Tensor,
                      alpha: float, temperature: float) -> torch.Tensor:
    """(1-α)·base + α·T²·KL(log_softmax(s/T) ‖ softmax(t/T)), batchmean,
    teacher detached."""
    t = temperature
    s = F.log_softmax(student_logits.float() / t, dim=-1)
    p_t = F.softmax(teacher_logits.detach().float() / t, dim=-1)
    kl = (p_t * (torch.log(p_t.clamp_min(1e-12)) - s)).sum(dim=-1).mean()
    return (1.0 - alpha) * base_loss + alpha * (t * t) * kl


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: Sequence[int] = (1, 5)) -> Dict[str, torch.Tensor]:
    """Counts of top-k correct predictions, summable across batches."""
    top_idx = torch.topk(logits.float(), max(ks), dim=-1).indices
    match = top_idx == labels.long()[:, None]
    out = {f"top{k}": match[:, :k].any(dim=-1).sum() for k in ks}
    out["count"] = torch.tensor(labels.shape[0], dtype=torch.int32,
                                device=labels.device)
    return out
