"""PyTorch building blocks of the ViT, with timm parameter names.

Counterpart of vision_transformers_torch_xla_tpu/models/layers.py. Params
are kept in the param dtype (fp32); every dense layer casts its input and
weight to the compute dtype (bf16) and adds its bias there, as the flax
layers do (layers.py:235-236, :374-375). LayerNorm statistics are fp32.

Parameters are created empty; `init_weights` fills them from an explicit
`torch.Generator` with the flax initializers (truncated normal 0.02, zero
biases, unit norms), or a state dict is loaded over them. Stochastic
layers (dropout, drop_path) also take an explicit generator.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_torch_xla_tpu_torch.ops.attention import (
    reference_attention,
)
from vision_transformers_torch_xla_tpu_torch.ops.bias_grad import bias_add
from vision_transformers_torch_xla_tpu_torch.ops.flash_attention import (
    qkv_proj_attention,
)

# flax's truncated_normal(stddev) draws a unit normal cut at ±2 and scales
# it by stddev / 0.8796..., the std of that cut normal
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s,
                                 generator=generator)


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by timm name (layers.py:64)."""
    table = {
        # timm's GELU is exact erf; "gelu_tanh" is the tanh approximation
        "gelu": F.gelu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
        "silu": F.silu,
        "relu": F.relu,
        "hard_swish": F.hardswish,
        "hard_sigmoid": F.hardsigmoid,
    }
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown act_layer {name!r}; known {sorted(table)}"
                         ) from None


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    if generator is None:
        raise ValueError("a stochastic layer needs an explicit torch.Generator")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator],
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth: drop whole samples of the residual branch, scale the
    kept ones by 1/keep (layers.py:84). `keep`, a (B, 1, ...) bool mask,
    replaces the draw (tests feed the JAX draws)."""
    if deterministic or rate == 0.0:
        return x
    if keep is None:
        keep = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), rate,
                          generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator],
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element dropout with inverted scaling (flax nn.Dropout). `keep`, a
    bool mask of x's shape, replaces the draw."""
    if deterministic or rate == 0.0:
        return x
    if keep is None:
        keep = _keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


class Dense(nn.Module):
    """x·Wᵀ (+b) in the compute dtype; W stored (out, in) as torch does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = empty_param((out_features, in_features), param_dtype,
                                  device)
        self.bias = empty_param((out_features,), param_dtype, device) \
            if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return bias_add(y, self.bias) if self.bias is not None else y


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and affine, output in the compute dtype
    (flax nn.LayerNorm with dtype=bf16, param_dtype=fp32)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = empty_param((dim,), param_dtype, device)
        self.bias = empty_param((dim,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class _ConvWeight(nn.Module):
    """Holds the patch projection as torch's stride-p Conv2d stores it:
    weight (D, C, p, p) and bias (D,), under timm's name `proj`."""

    def __init__(self, embed_dim: int, in_chans: int, patch_size: int,
                 bias: bool, param_dtype, device):
        super().__init__()
        self.weight = empty_param(
            (embed_dim, in_chans, patch_size, patch_size), param_dtype, device)
        self.bias = empty_param((embed_dim,), param_dtype, device) \
            if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class PatchEmbed(nn.Module):
    """NHWC image -> patch tokens by reshape + one matmul (layers.py:101)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = _ConvWeight(embed_dim, in_chans, patch_size, bias,
                                param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        # cast before the patchify copy, as the JAX layer does
        x = x.to(self.dtype)
        if h != gh * p or w != gw * p:
            # a strided conv floors: trailing rows/cols drop
            x = x[:, :gh * p, :gw * p]
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        # (D, C, p, p) -> the (p·p·C, D) matmul kernel of the flax layer
        w_mat = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        x = torch.matmul(x, w_mat.to(self.dtype))
        if self.proj.bias is not None:
            x = bias_add(x, self.proj.bias)
        return x


class Mlp(nn.Module):
    """fc1 -> act -> dropout -> fc2 -> dropout (layers.py:167, plain path).

    `use_pallas` (the JAX layer's fused-backward MLP, layers.py:199-211)
    needs the K3 kernel, which is not ported: it raises."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, bias: bool = True, act: str = "gelu",
                 drop: float = 0.0, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 use_pallas: bool = False):
        super().__init__()
        if use_pallas:
            raise NotImplementedError(
                "the fused-backward MLP (--pallas_mlp on) needs the "
                "_fc2_bwd_kernel port, which is not in the port yet "
                "(ROADMAP K3)")
        self.act = act_fn(act)
        self.drop = drop
        self.fc1 = Dense(in_features, hidden_features, bias, dtype,
                         param_dtype, device)
        self.fc2 = Dense(hidden_features, out_features, bias, dtype,
                         param_dtype, device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.act(self.fc1(x)), self.drop, deterministic, generator)
        return dropout(self.fc2(x), self.drop, deterministic, generator)


class Attention(nn.Module):
    """Multi-head self-attention (layers.py:265).

    Without qk_norm and without an active attn_drop, the fused projection +
    attention (ops/flash_attention.py::qkv_proj_attention) computes it, as
    the JAX layer's kernel route does (layers.py:295-302): the CUDA kernels
    on the card, their plain versions on the CPU. With a gradient that is
    one autograd Function, whose backward is the attention-backward kernel.
    Otherwise the plain path projects, splits the heads and runs the
    fp32-softmax attention under autograd."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False, proj_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 norm_eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qk_norm = qk_norm
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, param_dtype, device)
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, norm_eps, dtype,
                                    param_dtype, device)
            self.k_norm = LayerNorm(self.head_dim, norm_eps, dtype,
                                    param_dtype, device)
        self.proj = Dense(dim, dim, proj_bias, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, s, d = x.shape
        h, hd = self.num_heads, self.head_dim
        scale = hd ** -0.5
        attn_dropping = self.attn_drop > 0.0 and not deterministic
        if not self.qk_norm and not attn_dropping:
            o = qkv_proj_attention(x.to(self.dtype), self.qkv.weight.t(),
                                   self.qkv.bias, h, scale=scale)
        else:
            qkv = self.qkv(x).reshape(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if self.qk_norm:
                q, k = self.q_norm(q), self.k_norm(k)
            if attn_dropping:
                # dropout on the softmax probabilities (timm semantics)
                p = torch.softmax(
                    torch.matmul(q.float(), k.float().transpose(-1, -2))
                    * scale, dim=-1)
                p = dropout(p, self.attn_drop, False, generator)
                o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
            else:
                o = reference_attention(q, k, v, scale)
            o = o.transpose(1, 2).reshape(b, s, d)
        return dropout(self.proj(o), self.proj_drop, deterministic, generator)


class LayerScale(nn.Module):
    """Per-channel residual scale (layers.py:385)."""

    def __init__(self, dim: int, init_values: float = 1e-5,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.init_values = init_values
        self.gamma = empty_param((dim,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.gamma, self.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm block: x + DP(LS(attn(LN(x)))), then the same with the MLP
    (layers.py:402)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_norm: bool = False,
                 proj_bias: bool = True, init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, act: str = "gelu",
                 norm_eps: float = 1e-6, mlp_hidden: Optional[int] = None,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, use_pallas_mlp: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, norm_eps, dtype, param_dtype, device)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_norm, proj_bias,
                              attn_drop, proj_drop, norm_eps, dtype,
                              param_dtype, device)
        self.ls1 = LayerScale(dim, init_values, param_dtype, device) \
            if init_values is not None else None
        self.norm2 = LayerNorm(dim, norm_eps, dtype, param_dtype, device)
        self.mlp = Mlp(dim, mlp_hidden or int(dim * mlp_ratio), dim,
                       proj_bias, act, proj_drop, dtype, param_dtype, device,
                       use_pallas_mlp)
        self.ls2 = LayerScale(dim, init_values, param_dtype, device) \
            if init_values is not None else None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.attn(self.norm1(x), deterministic, generator)
        if self.ls1 is not None:
            y = self.ls1(y)
        x = x + drop_path(y, self.drop_path_rate, deterministic, generator)
        y = self.mlp(self.norm2(x), deterministic, generator)
        if self.ls2 is not None:
            y = self.ls2(y)
        return x + drop_path(y, self.drop_path_rate, deterministic, generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `module` with the flax initializers, drawing
    from `generator` in module order."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
