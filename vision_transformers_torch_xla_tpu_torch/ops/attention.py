"""Plain softmax attention and the op-level multi-head attention entry.

Counterpart of vision_transformers_torch_xla_tpu/ops/attention.py. Every
function there is plain tensor code, so every one here is plain PyTorch:
scores and softmax in fp32, the p·v product on p cast to v's dtype,
accumulated in fp32. `multi_head_attention(use_pallas=True)` is the one
route to a kernel: `ops/flash_attention.py::fused_attention` (K7, K8).
"""
from __future__ import annotations

from typing import Optional

import torch


def _pv(p: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """p (fp32) cast to v's dtype, times v, accumulated in fp32."""
    return torch.einsum(eq, p.to(v.dtype).float(), v.float())


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, H, S, D) -> (B, H, S, D) in q's dtype (:18)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention with an additive mask broadcastable to (B, H, Q, K) (:30)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s + mask.float(), dim=-1)
    return _pv(p, v, "bhqk,bhkd->bhqd").to(q.dtype)


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention in (B, S, H, D) layout, no head transposes (:47)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    return _pv(p, v, "bhqk,bkhd->bqhd").to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None,
                         use_pallas: bool = False) -> torch.Tensor:
    """Softmax attention, (B, H, S, D) -> (B, H, S, D) (:64).

    use_pallas takes the fused kernels (`fused_attention`: K7 forward, K8
    backward on CUDA tensors, their plain versions on CPU tensors); the
    default the plain `reference_attention`. The JAX flag's name is kept."""
    if use_pallas:
        from vision_transformers_torch_xla_tpu_torch.ops.flash_attention import (
            fused_attention,
        )

        return fused_attention(q, k, v, scale=scale)
    return reference_attention(q, k, v, scale)
