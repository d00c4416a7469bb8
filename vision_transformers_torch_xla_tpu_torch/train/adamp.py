"""AdamP and SGDP (Heo et al., 2021) as updates of train/transforms.py.

Counterpart of vision_transformers_torch_xla_tpu/train/adamp.py: when
every output channel of a weight is nearly orthogonal to its update
(cosine below delta / √dim), the update is projected onto the tangent
space of each channel's sphere and the weight decay scaled by wd_ratio
(`channel_project`, JAX :25-44). A channel is an output unit: the last
axis of a flax kernel, which is axis 0 of the port's weights (a dense's
(out, in), a conv's (O, I, kh, kw)); tensors kept in one layout by both
packages (position embeddings, tokens) keep the last axis. 1-D params are
not projected. The projection reads whole tensors, so on FSDP's shards
and the model axis's parts these optimizers raise
(transforms.py::Optimizer).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from vision_transformers_torch_xla_tpu_torch.parallel.sharding import local
from vision_transformers_torch_xla_tpu_torch.train.transforms import (
    Schedule,
    Transform,
    _moment,
    _sq_moment,
    at,
    zeros,
)


def channel_project(name: str, p: torch.Tensor, update: torch.Tensor,
                    delta: float, eps: float = 1e-8):
    """(update, wd_gate): the update projected off p's channels where
    every channel's |cos(p, update)| < delta / √dim, with wd_gate 0, else
    the update and 1."""
    if p.ndim < 2:
        return update, 1.0
    axis = 0 if name.endswith("weight") else p.ndim - 1
    pm = p.movedim(axis, 0).reshape(p.shape[axis], -1)
    um = update.movedim(axis, 0).reshape(p.shape[axis], -1)
    pn = pm / (torch.linalg.vector_norm(pm, dim=1, keepdim=True) + eps)
    dot = (pn * um).sum(1)
    cos = dot.abs() / (torch.linalg.vector_norm(um, dim=1) + eps)
    project = bool(cos.max() < delta / pm.shape[1] ** 0.5)
    if not project:
        return update, 1.0
    out = um - dot[:, None] * pn
    return out.reshape(p.movedim(axis, 0).shape).movedim(0, axis), 0.0


class AdamP(Transform):
    """-lr · (adam step, projected, + wd·wd_scale·p on the mask)."""
    whole_tensor = True

    def __init__(self, learning_rate: Schedule, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay: Schedule = 0.0, delta=0.1, wd_ratio=0.1,
                 mask: Optional[Mapping[str, bool]] = None):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.wd, self.delta, self.wd_ratio, self.mask = \
            weight_decay, delta, wd_ratio, mask

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, u, state, params, count, **extra):
        lr, wd, t = at(self.lr, count), at(self.wd, count), count + 1
        out = {}
        for k, g in u.items():
            m = _moment(local(state["mu"][k]), g, self.b1)
            v = _sq_moment(local(state["nu"][k]), g, self.b2)
            step = (m / (1 - self.b1 ** t)) / (
                (v / (1 - self.b2 ** t)).sqrt() + self.eps)
            step, gate = channel_project(k, params[k], step, self.delta)
            decay = wd * (gate + (1 - gate) * self.wd_ratio) \
                if self.mask is None or self.mask[k] else 0.0
            out[k] = -lr * (step + decay * params[k])
        return out


class SGDP(Transform):
    """-lr · (nesterov momentum step, projected, + wd·wd_scale·p)."""
    whole_tensor = True

    def __init__(self, learning_rate: Schedule, momentum=0.9,
                 weight_decay: Schedule = 0.0, delta=0.1, wd_ratio=0.1,
                 nesterov=True, mask: Optional[Mapping[str, bool]] = None):
        self.lr, self.momentum, self.wd = learning_rate, momentum, weight_decay
        self.delta, self.wd_ratio, self.nesterov, self.mask = \
            delta, wd_ratio, nesterov, mask

    def init(self, params):
        return {"momentum": zeros(params)}

    def update(self, u, state, params, count, **extra):
        lr, wd, mo = at(self.lr, count), at(self.wd, count), self.momentum
        out = {}
        for k, g in u.items():
            buf = local(state["momentum"][k])
            buf.copy_(mo * buf + g)
            d = g + mo * buf if self.nesterov else buf.clone()
            d, gate = channel_project(k, params[k], d, self.delta)
            decay = wd * (gate + (1 - gate) * self.wd_ratio) \
                if self.mask is None or self.mask[k] else 0.0
            out[k] = -lr * (d + decay * params[k])
        return out
