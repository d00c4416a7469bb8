"""Optimizer factory, AdamW path.

Counterpart of vision_transformers_torch_xla_tpu/train/optim.py over timm
parameter names (`blocks.N.…`) instead of flax paths:

* `wd_mask`: weight decay applies where ndim > 1 and no
  NO_WEIGHT_DECAY_KEYWORDS fragment is in the name (:36-46);
* `vit_layer_id` and `scale_by_layer_decay`: per-parameter update scales
  decay^(depth + 1 − layer id) (:49-66, :113-155);
* `maybe_fused_optimizer` and `create_optimizer` for `adamw` and its
  `fusedadamw` spelling, both as train/fused.py::FusedAdamW.

Every other optimizer name, lookahead and `update_freq > 1` raise
NotImplementedError naming ROADMAP M7.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Union

import torch

from vision_transformers_torch_xla_tpu_torch.models.vit import (
    NO_WEIGHT_DECAY_KEYWORDS,
)
from vision_transformers_torch_xla_tpu_torch.train.fused import FusedAdamW

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP M7); the port has adamw")


def wd_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: ndim > 1 and no skip keyword."""
    return {k: p.ndim > 1 and not any(s in k for s in NO_WEIGHT_DECAY_KEYWORDS)
            for k, p in params.items()}


def vit_layer_id(name: str, depth: int) -> int:
    """Layer id for layer decay: embeddings 0, block i -> i + 1, the rest
    depth + 1."""
    if any(k in name for k in ("patch_embed", "cls_token", "pos_embed",
                               "reg_token")):
        return 0
    m = re.match(r"blocks\.(\d+)\.", name)
    return int(m.group(1)) + 1 if m else depth + 1


def scale_by_layer_decay(params: Mapping[str, torch.Tensor], decay: float,
                         depth: int) -> Dict[str, float]:
    """Per-parameter update scale decay^(num_layers − 1 − layer id), with
    num_layers = depth + 2 (the ViT grouping of the JAX transform)."""
    num_layers = depth + 2
    return {k: decay ** (num_layers - 1 - vit_layer_id(k, depth))
            for k in params}


def _adamw_name(opt: str) -> None:
    name = opt.lower()
    if name.startswith("lookahead_"):
        raise _not_ported(f"optimizer {opt!r} (lookahead)")
    if name.removeprefix("fused") != "adamw":
        raise _not_ported(f"optimizer {opt!r}")


def maybe_fused_optimizer(
    opt: str,
    learning_rate: ScalarOrSchedule,
    params: Mapping[str, torch.Tensor],
    weight_decay: float = 0.0,
    weight_decay_schedule: Optional[Callable] = None,
    opt_eps: float = 1e-8,
    opt_betas: Optional[tuple] = None,
    clip_grad: Optional[float] = None,
    layer_decay: float = 1.0,
    update_freq: int = 1,
    ema_decay: Optional[float] = None,
) -> Optional[FusedAdamW]:
    """The one-pass AdamW(+EMA) when the recipe is plain adamw (no wd
    schedule, no layer decay, no accumulation), else None."""
    if opt.lower().removeprefix("fused") != "adamw" or \
            weight_decay_schedule is not None or layer_decay < 1.0 or \
            update_freq > 1:
        return None
    b1, b2 = opt_betas if opt_betas is not None else (0.9, 0.999)
    return FusedAdamW(learning_rate, weight_decay=weight_decay, b1=b1, b2=b2,
                      eps=opt_eps, ema_decay=ema_decay, clip_grad=clip_grad,
                      mask=wd_mask(params))


def create_optimizer(
    opt: str,
    learning_rate: ScalarOrSchedule,
    params: Mapping[str, torch.Tensor],
    weight_decay: float = 0.0,
    weight_decay_schedule: Optional[Callable] = None,
    opt_eps: float = 1e-8,
    opt_betas: Optional[tuple] = None,
    clip_grad: Optional[float] = None,
    layer_decay: float = 1.0,
    model_depth: int = 12,
    update_freq: int = 1,
    ema_decay: Optional[float] = None,
) -> FusedAdamW:
    """AdamW with [clip], the wd mask, an optional wd schedule and layer
    decay; the EMA rides along when `ema_decay` is given (the JAX step
    applies it after the update, steps.py:126-129)."""
    _adamw_name(opt)
    if update_freq > 1:
        raise _not_ported("gradient accumulation (update_freq > 1)")
    b1, b2 = opt_betas if opt_betas is not None else (0.9, 0.999)
    scales = scale_by_layer_decay(params, layer_decay, model_depth) \
        if layer_decay < 1.0 else None
    return FusedAdamW(
        learning_rate, weight_decay=weight_decay_schedule or weight_decay,
        b1=b1, b2=b2, eps=opt_eps, ema_decay=ema_decay,
        clip_grad=clip_grad if clip_grad is not None and clip_grad > 0
        else None,
        mask=wd_mask(params), scales=scales)
