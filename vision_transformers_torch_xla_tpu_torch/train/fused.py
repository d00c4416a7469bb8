"""AdamW + EMA + grad-norm update.

Counterpart of vision_transformers_torch_xla_tpu/train/fused.py
(`make_fused_adamw`, :52-128), with its numerics: the global grad norm, an
optional clip by min(1, clip/‖g‖), bias-corrected moments through the
scalars c1 = 1/(1−β1ᵗ) and c2 = 1/(1−β2ᵗ), decoupled weight decay on the
masked params, the parameter write, then the EMA blend from the new params:

    m ← β1·m + (1−β1)·g;  v ← β2·v + (1−β2)·g²
    p ← p − lr·((m·c1)/(√(v·c2) + eps) + wd·p·mask)
    ema ← d·ema + (1−d)·p

In the JAX package this is XLA's elementwise work, not a Pallas kernel, so
here it is plain PyTorch: a loop over the tensors under no_grad that
updates params, moments and EMA in place (JAX returns new arrays; updating
in place keeps one copy of each). A hand-written fused optimizer kernel is
a later performance step (ROADMAP). The step count and the learning rate
live on the host, so the update makes no device round trip; the grad norm
stays a device scalar.

Under FSDP (parallel/sharding.py) the params, grads, moments and EMA are
DTensor shards, and on the mesh's model axis (parallel/split.py) the
split tensors are each rank's part: the update runs on each rank's local
tensors, and the global norm sums each tensor's squares over the axes that
cut it, and only those (a tensor replicated over an axis counts once), so
the clip sees the whole gradient's norm. The `mask` stays keyed by name.

train/optim.py takes this route for plain adamw alone, as JAX
`maybe_fused_optimizer` decides; a wd schedule, layer decay, lookahead or
accumulation take train/transforms.py's chain.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist

from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
    is_sharded,
    local,
)
from vision_transformers_torch_xla_tpu_torch.parallel.split import Split

Schedule = Union[float, Callable[[int], float]]


class FusedAdamW:
    """init(params) -> state; fused_update(grads, state, params, ema) ->
    device grad norm. `params`, `grads` and `ema` map names to tensors;
    `mask` maps names to True where weight decay applies (None: all)."""

    def __init__(self, learning_rate: Schedule, *, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 ema_decay: Optional[float] = None,
                 clip_grad: Optional[float] = None,
                 mask: Optional[Mapping[str, bool]] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.ema_decay = ema_decay
        self.clip_grad = clip_grad
        self.mask = mask

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        """{'count': host int, 'mu', 'nu': fp32 zeros like each param}."""
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"count": 0, "mu": zeros,
                "nu": {k: torch.zeros_like(z) for k, z in zeros.items()}}

    @torch.no_grad()
    def fused_update(self, grads: Mapping[str, torch.Tensor], state: Dict,
                     params: Mapping[str, torch.Tensor],
                     ema: Optional[Mapping[str, torch.Tensor]] = None,
                     splits: Optional[Mapping[str, Split]] = None
                     ) -> torch.Tensor:
        """Update params, state and ema in place; return the global grad
        norm (before the clip) as a device scalar. `splits` names the
        tensors cut over the model axis."""
        count = state["count"]
        lr = self.learning_rate(count) if callable(self.learning_rate) \
            else self.learning_rate
        wd = self.weight_decay
        t = count + 1
        b1, b2 = self.b1, self.b2
        c1 = 1.0 / (1.0 - b1 ** t)
        c2 = 1.0 / (1.0 - b2 ** t)
        norm = global_norm(grads, splits)
        gscale = None
        if self.clip_grad is not None:
            gscale = torch.clamp(self.clip_grad / (norm + 1e-16), max=1.0)
        decay = ema is not None and self.ema_decay is not None
        for k, p in params.items():
            p = local(p)
            g = local(grads[k]).float()
            if gscale is not None:
                g = g * gscale
            m, v = local(state["mu"][k]), local(state["nu"][k])
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m * c1) / ((v * c2).sqrt_() + self.eps)
            p32 = p.float()
            if wd and (self.mask is None or self.mask[k]):
                upd.add_(p32, alpha=wd)
            p.copy_(p32.add_(upd, alpha=-lr))
            if decay:
                e = local(ema[k])
                e.copy_(e.float().mul_(self.ema_decay).add_(
                    p32, alpha=1.0 - self.ema_decay))
        state["count"] = t
        return norm


def global_norm(grads: Mapping[str, torch.Tensor],
                splits: Optional[Mapping[str, Split]] = None
                ) -> torch.Tensor:
    """√Σ‖g‖² in fp32, as a device scalar. Each tensor's local squares are
    summed over the groups that cut it, in one all-reduce a group for each
    set of tensors cut alike: FSDP's data group for a DTensor shard, the
    model axis's group for a tensor in `splits`, both in turn for one cut
    by both. A tensor replicated over an axis is counted once."""
    splits = splits or {}
    by_cut: Dict[tuple, list] = {}
    for k, g in grads.items():
        cut = ((g.device_mesh.get_group(0),) if is_sharded(g) else ()) + \
            ((splits[k].axis.group,) if k in splits else ())
        by_cut.setdefault(cut, []).append(
            torch.linalg.vector_norm(local(g).float()))
    if list(by_cut) == [()]:
        return torch.linalg.vector_norm(torch.stack(by_cut[()]))
    total = []
    for cut, norms in by_cut.items():
        squares = torch.stack(norms).square().sum()
        for group in cut:
            dist.all_reduce(squares, group=group)
        total.append(squares)
    return torch.stack(total).sum().sqrt()
