"""Train state: what the step updates.

Counterpart of vision_transformers_torch_xla_tpu/train/state.py. The
params are the model's own parameters, by timm name; the step updates them,
the optimizer state and the EMA copies in place. The step count lives on
the host, so no step reads it back from the device.

A checkpoint holds `state_dict()`, a dict view of the four fields (JAX
ckpt/checkpoint.py::_as_dict); `load_state_dict` copies one back into the
live tensors, so the model keeps training the tensors it holds. Under
FSDP the live tensors are DTensor shards: `state_dict()` still holds them,
the checkpoint gathers them (ckpt/checkpoint.py), and `load_state_dict`
copies each rank's rows of a whole saved tensor into its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
    copy_full_into,
    local,
)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self) -> Dict[str, Any]:
        """{'step', 'params', 'opt_state', 'ema_params'}: the live tensors
        (detached) and host ints."""
        return {f.name: _detached(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping[str, Any]) -> "TrainState":
        """Copy `saved` (a `state_dict()`, on any device) into the live
        tensors and set the host ints; the names and shapes must match."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, _copy_into(getattr(self, f.name),
                                             saved[f.name], f.name))
        return self


def _detached(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, Mapping):
        return {k: _detached(v) for k, v in x.items()}
    return x


def _copy_into(live, saved, path: str):
    """`live` with `saved`'s values: tensors copied in place, dicts walked,
    anything else (the host step and count) replaced."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != live.shape:
            raise ValueError(
                f"checkpoint {path}: {getattr(saved, 'shape', type(saved))} "
                f"does not fit the live {tuple(live.shape)}")
        copy_full_into(live, saved)
        return live
    if isinstance(live, Mapping):
        if not isinstance(saved, Mapping) or set(saved) != set(live):
            got = set(saved) if isinstance(saved, Mapping) else set()
            raise KeyError(
                f"checkpoint {path}: missing {sorted(set(live) - got)}, "
                f"unexpected {sorted(got - set(live))}")
        for k in live:
            live[k] = _copy_into(live[k], saved[k], f"{path}.{k}")
        return live
    if (live is None) != (saved is None):
        raise ValueError(f"checkpoint {path}: saved {type(saved).__name__}, "
                         f"live {type(live).__name__}")
    return saved


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
        local(e).mul_(decay).add_(local(params[k]).to(e.dtype),
                                  alpha=1.0 - decay)
