"""Train state: what the step updates.

Counterpart of vision_transformers_torch_xla_tpu/train/state.py. The
params are the model's own parameters, by timm name; the step updates them,
the optimizer state and the EMA copies in place. The step count lives on
the host, so no step reads it back from the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model: nn.Module, tx: Any,
                       with_ema: bool = False) -> TrainState:
    """State over `model`'s parameters; the EMA starts as a copy of them."""
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()} \
        if with_ema else None
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      ema_params=ema)


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float) -> None:
    """ema <- ema·d + p·(1−d), in place."""
    for k, e in ema_params.items():
        e.mul_(decay).add_(params[k].to(e.dtype), alpha=1.0 - decay)
