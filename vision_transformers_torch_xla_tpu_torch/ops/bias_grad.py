"""Bias add with an fp32 bias gradient.

Counterpart of vision_transformers_torch_xla_tpu/ops/bias_grad.py::bias_add.
The forward is a plain add in y's dtype. The backward passes dy through and
reduces it over every leading axis in fp32, then casts to the bias dtype,
as the JAX version's ones-vector dot with preferred_element_type=f32 does
(:36-42). Autograd alone would sum a bf16 dy into a bf16 db first.
"""
from __future__ import annotations

import torch


class _BiasAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, b):
        ctx.b_dtype = b.dtype
        return y + b.to(y.dtype)

    @staticmethod
    def backward(ctx, dy):
        db = dy.sum(dim=tuple(range(dy.ndim - 1)), dtype=torch.float32)
        return dy, db.to(ctx.b_dtype)


def bias_add(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b, b broadcast over y's leading axes and cast to y's dtype."""
    return _BiasAdd.apply(y, b)
