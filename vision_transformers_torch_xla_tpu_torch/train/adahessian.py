"""AdaHessian (Yao et al., arXiv:2006.00719): Adam with the square of a
Hutchinson Hessian-diagonal estimate as its second moment.

Counterpart of vision_transformers_torch_xla_tpu/train/adahessian.py.
JAX takes D = z ⊙ (H z), z Rademacher, by forward-over-reverse (a jvp of
the gradient function, :46-70); the port takes H z by a double backward
(`hessian_vector_product`: the gradients with create_graph, then their
gradient against z), the same product since H is symmetric. Conv kernels
(the flax `nn.Conv` weights: ConvNeXt's depthwise convs and overlap
stems, `conv_kernel_names`) have D averaged over their spatial axes, as
JAX averages its HWIO kernels over (0, 1); a conv-shaped weight that JAX
holds as a dense kernel (the patch stems) is not averaged.

The update (`ScaleByAdahessian`, then decoupled weight decay and the
learning rate, JAX :73-134):

    m ← b1·m + (1−b1)·g;  v ← b2·v + (1−b2)·D²
    p ← p − lr·((m / (1−b1ᵗ)) / ((v / (1−b2ᵗ))^(k/2) + eps) + wd·p·mask)

The port's autograd Functions for the attention and MLP kernels have no
double backward (JAX cannot take a jvp through their custom_vjp either),
so the train step raises on a kernel route (`check_route`).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Set

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.models.convnext import Conv2d
from vision_transformers_torch_xla_tpu_torch.parallel.sharding import local
from vision_transformers_torch_xla_tpu_torch.train.transforms import (
    AddDecayedWeights,
    Chain,
    Schedule,
    ScaleByLearningRate,
    Transform,
    _moment,
    zeros,
)


def conv_kernel_names(model: nn.Module) -> Set[str]:
    """Names of the weights that the JAX model holds as HWIO conv
    kernels: those of models/convnext.py::Conv2d."""
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, Conv2d)}


def check_route(model: nn.Module) -> None:
    """Raise when a layer takes the attention or MLP kernel route."""
    routed = sorted(name for name, m in model.named_modules()
                    if getattr(m, "use_pallas", False))
    if routed:
        raise NotImplementedError(
            f"adahessian needs a double backward, which the kernel route "
            f"(use_pallas_attn / use_pallas_mlp: {routed[0]} and "
            f"{len(routed) - 1} more) does not have, as JAX cannot take a "
            f"jvp through its custom_vjp; train with --pallas_attn off and "
            f"--pallas_mlp off")


def rademacher_like(params: Mapping[str, torch.Tensor],
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """iid ±1 draws like each param, in fp32."""
    return {k: torch.randint(0, 2, p.shape, generator=generator,
                             device=p.device).float().mul_(2).sub_(1)
            for k, p in params.items()}


def hessian_diag(loss: torch.Tensor, params: Mapping[str, torch.Tensor],
                 z: Mapping[str, torch.Tensor], conv_kernels: Set[str]
                 ) -> tuple:
    """(grads, D): the gradients of `loss` and the Hutchinson estimate
    z ⊙ (H z), averaged over the spatial axes of `conv_kernels`."""
    names: List[str] = list(params)
    ps = [params[k] for k in names]
    grads = torch.autograd.grad(loss, ps, create_graph=True)
    hz = torch.autograd.grad(grads, ps, grad_outputs=[
        z[k].to(p.dtype) for k, p in zip(names, ps)])
    diag = {}
    for k, zk, h in zip(names, (z[k] for k in names), hz):
        d = zk * h.float()
        if k in conv_kernels:
            d = d.mean(dim=(2, 3), keepdim=True).expand_as(d)
        diag[k] = d
    return {k: g.detach() for k, g in zip(names, grads)}, diag


class ScaleByAdahessian(Transform):
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, hessian_power=1.0):
        self.b1, self.b2, self.eps, self.k = b1, b2, eps, hessian_power

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, u, state, params, count, hessian_diag=None, **extra):
        if hessian_diag is None:
            raise ValueError("adahessian's update needs hessian_diag")
        t = count + 1
        out = {}
        for k, g in u.items():
            m = _moment(local(state["mu"][k]), g, self.b1)
            d = hessian_diag[k]
            v = local(state["nu"][k])
            v.mul_(self.b2).addcmul_(d, d, value=1.0 - self.b2)
            out[k] = (m / (1 - self.b1 ** t)) / (
                (v / (1 - self.b2 ** t)) ** (self.k / 2) + self.eps)
        return out


def adahessian(learning_rate: Schedule, b1=0.9, b2=0.999, eps=1e-8,
               weight_decay: Schedule = 0.0, hessian_power=1.0,
               mask=None) -> Chain:
    return Chain(ScaleByAdahessian(b1, b2, eps, hessian_power),
                 AddDecayedWeights(weight_decay, mask),
                 ScaleByLearningRate(learning_rate))
