"""Train state: what the step updates.

Counterpart of vision_transformers_torch_xla_tpu/train/state.py. The
params are the model's own parameters, by timm name; the step updates them,
the optimizer state and the EMA copies in place. The step count lives on
the host, so no step reads it back from the device.

A checkpoint holds `state_dict()`, a dict view of the four fields (JAX
ckpt/checkpoint.py::_as_dict); `load_state_dict` copies one back into the
live tensors, so the model keeps training the tensors it holds. Under
FSDP the live tensors are DTensor shards, and on the mesh's model axis the
split ones are each rank's part (`splits`, by name; parallel/split.py):
`state_dict()` still holds them, the checkpoint gathers them
(ckpt/checkpoint.py), and `load_state_dict` copies each rank's rows of a
whole saved tensor into its part.
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
from vision_transformers_torch_xla_tpu_torch.parallel.split import Split

# what a checkpoint holds
STATE_KEYS = ("step", "params", "opt_state", "ema_params")


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # the tensors cut over the model axis, by parameter name (their
    # moments and EMA alike); not saved: the mesh decides it
    splits: Dict[str, Split] = dataclasses.field(default_factory=dict)

    def state_dict(self) -> Dict[str, Any]:
        """{'step', 'params', 'opt_state', 'ema_params'}: the live tensors
        (detached) and host ints."""
        return {k: _detached(getattr(self, k)) for k in STATE_KEYS}

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping[str, Any]) -> "TrainState":
        """Copy `saved` (a `state_dict()` of whole tensors, on any device)
        into the live tensors and set the host ints; the names and shapes
        must match."""
        for k in STATE_KEYS:
            setattr(self, k, _copy_into(getattr(self, k), saved[k], k,
                                        self.splits))
        return self


def _detached(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, Mapping):
        return {k: _detached(v) for k, v in x.items()}
    return x


def _copy_into(live, saved, path: str, splits: Mapping[str, Split],
               key: str = ""):
    """`live` with `saved`'s values: tensors copied in place (a tensor cut
    over the model axis takes its part, by its name `key`), dicts walked,
    anything else (the host step and count) replaced."""
    if isinstance(live, torch.Tensor):
        split = splits.get(key)
        want = saved.shape if split is None or not isinstance(
            saved, torch.Tensor) else split.rows(saved).shape
        if not isinstance(saved, torch.Tensor) or want != live.shape:
            raise ValueError(
                f"checkpoint {path}: {getattr(saved, 'shape', type(saved))} "
                f"does not fit the live {tuple(live.shape)}")
        copy_full_into(live, saved, split)
        return live
    if isinstance(live, Mapping):
        if not isinstance(saved, Mapping) or set(saved) != set(live):
            got = set(saved) if isinstance(saved, Mapping) else set()
            raise KeyError(
                f"checkpoint {path}: missing {sorted(set(live) - got)}, "
                f"unexpected {sorted(got - set(live))}")
        for k in live:
            live[k] = _copy_into(live[k], saved[k], f"{path}.{k}", splits, k)
        return live
    if (live is None) != (saved is None):
        raise ValueError(f"checkpoint {path}: saved {type(saved).__name__}, "
                         f"live {type(live).__name__}")
    return saved


def create_train_state(model: nn.Module, tx: Any, with_ema: bool = False,
                       splits: Optional[Dict[str, Split]] = None
                       ) -> TrainState:
    """State over `model`'s parameters; the EMA starts as a copy of them.
    `splits` (parallel/sharding.py::wrap_model) names the parameters cut
    over the model axis."""
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()} \
        if with_ema else None
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      ema_params=ema, splits=dict(splits or {}))


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float) -> None:
    """ema <- ema·d + p·(1−d), in place."""
    for k, e in ema_params.items():
        local(e).mul_(decay).add_(local(params[k]).to(e.dtype),
                                  alpha=1.0 - decay)
