"""PyTorch building blocks of the ViT, with timm parameter names.

Counterpart of vision_transformers_torch_xla_tpu/models/layers.py. Params
are kept in the param dtype (fp32); every dense layer casts its input and
weight to the compute dtype (bf16) and adds its bias there, as the flax
layers do (layers.py:235-236, :374-375). LayerNorm statistics are fp32.

Parameters are created empty; `init_weights` fills them from an explicit
`torch.Generator` with the flax initializers (truncated normal 0.02, zero
biases, unit norms), or a state dict is loaded over them. Stochastic
layers (dropout, drop_path) also take an explicit generator.

On the mesh's `model` axis (parallel/split.py) `Attention`,
`AttentionPoolLatent` and `Mlp` run their rank's heads or hidden columns
(`heads_split`, `hidden_split`, set by parallel/sharding.py::split_heads),
and `Attention` its rank's query rows of the gathered tokens under sp
(`seq_split`); unsplit, those attributes are None.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_torch_xla_tpu_torch.core.rng import global_rand
from vision_transformers_torch_xla_tpu_torch.ops.attention import (
    reference_attention,
)
from vision_transformers_torch_xla_tpu_torch.ops.bias_grad import bias_add
from vision_transformers_torch_xla_tpu_torch.ops.flash_attention import (
    MAX_SEQ,
    fused_attention_qkv_cols,
    qkv_proj_attention,
)
from vision_transformers_torch_xla_tpu_torch.ops.mlp_fused import (
    WIDTH_MULTIPLE,
    mlp_gelu,
    mlp_gelu_columns,
)
from vision_transformers_torch_xla_tpu_torch.parallel.split import (
    ModelAxis,
    copy_in,
    gather_tokens,
    reduce_out,
    token_count,
    token_slice,
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
    """The keep mask of a batch-first `shape`: on W data-parallel processes
    this process's rows of the global batch's draw (core/rng.py)."""
    if generator is None:
        raise ValueError("a stochastic layer needs an explicit torch.Generator")
    return global_rand(shape, generator, device) < 1.0 - rate


def _split_keep(shape, dim: int, axis: ModelAxis, rate: float,
                generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The keep mask of this rank's part, along `dim`, of a tensor split
    over the model axis: the whole tensor's draw, narrowed, so every rank
    draws what the unsplit layer draws."""
    whole = list(shape)
    whole[dim] *= axis.count
    return _keep_mask(tuple(whole), rate, generator, device).narrow(
        dim, axis.index * shape[dim], shape[dim])


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
        return self.add_bias(self.product(x))

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """x·Wᵀ without the bias (a row-parallel layer's partial sum)."""
        return torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return bias_add(y, self.bias) if self.bias is not None else y


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and affine, output in the compute dtype
    (flax nn.LayerNorm with dtype=bf16, param_dtype=fp32). `weight_init` is
    the weight's initial value (ResPostBlock's post-norms take
    init_values, layers.py:541-550)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 weight_init: float = 1.0):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight_init = weight_init
        self.weight = empty_param((dim,), param_dtype, device)
        self.bias = empty_param((dim,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.weight, self.weight_init)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                through: Optional[Callable] = None) -> torch.Tensor:
        """`through` maps the weight and bias first (a split region passes
        them through parallel/split.py::copy_in)."""
        w, b = self.weight, self.bias
        if through is not None:
            w, b = through(w), through(b)
        return F.layer_norm(x.float(), w.shape, w.float(), b.float(),
                            self.eps).to(self.dtype)


class RMSNorm(nn.Module):
    """flax nn.RMSNorm: x · rsqrt(mean(x²) + eps) · scale, the mean of
    squares and the product in fp32, output in the compute dtype; one
    `weight` (flax `scale`), no bias."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = empty_param((dim,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor,
                through: Optional[Callable] = None) -> torch.Tensor:
        w = self.weight if through is None else through(self.weight)
        x = x.float()
        mul = torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return (x * (mul * w.float())).to(self.dtype)


def make_norm(norm_type: str, dim: int, eps: float = 1e-6,
              dtype=torch.bfloat16, param_dtype=torch.float32,
              device=None) -> nn.Module:
    """The norm a site takes by `norm_type` (JAX `_layer_norm`, :46-61)."""
    if norm_type == "rmsnorm":
        return RMSNorm(dim, eps, dtype, param_dtype, device)
    if norm_type != "layernorm":
        raise ValueError(f"unknown norm_type {norm_type!r}")
    return LayerNorm(dim, eps, dtype, param_dtype, device)


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
    """NHWC image -> patch tokens by reshape + one matmul (layers.py:101);
    `use_norm` adds the norm after the projection (aimv2's embed_norm)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32, device=None,
                 use_norm: bool = False, norm_type: str = "layernorm",
                 norm_eps: float = 1e-6):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = _ConvWeight(embed_dim, in_chans, patch_size, bias,
                                param_dtype, device)
        self.norm = make_norm(norm_type, embed_dim, norm_eps, dtype,
                              param_dtype, device) if use_norm else None

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
        return self.norm(x) if self.norm is not None else x


class Mlp(nn.Module):
    """fc1 -> act -> dropout [-> norm] -> fc2 -> dropout (layers.py:167).

    `glu` is timm's packed SwiGLU (layers.py:195-216): fc1 is `hidden // 2
    * 2` wide, its output splits in halves and silu(first) * second feeds
    fc2, whatever `act` says. `use_norm` puts a norm after the activation's
    dropout, before fc2 (scale_mlp_norm, beit3).

    `use_pallas` routes the plain tanh-GELU recipe through the fused-backward
    MLP (ops/mlp_fused.py::mlp_gelu, the fc2-backward kernel K3), by the
    JAX layer's rule (layers.py:199-203): no glu, no norm, gelu_tanh, no
    dropout, a 3-D input and every width a multiple of 128. Anything else
    takes the plain path; the parameters are fc1/fc2 either way, so state
    dicts load with strict=True on both.

    Split over the model axis (`hidden_split`), fc1 holds the rank's
    hidden columns (a packed SwiGLU's of both halves) and fc2 the same
    columns of its input: the rank's partial fc2 product is summed over
    the ranks before fc2's bias; K3 runs on the rank's columns
    (ops/mlp_fused.py::mlp_gelu_columns)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, bias: bool = True, act: str = "gelu",
                 drop: float = 0.0, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 use_pallas: bool = False, glu: bool = False,
                 use_norm: bool = False, norm_type: str = "layernorm",
                 norm_eps: float = 1e-6):
        super().__init__()
        self.act_name = act
        self.act = act_fn(act)
        self.drop = drop
        self.use_pallas = use_pallas
        self.glu = glu
        self.dtype = dtype
        hidden = hidden_features // 2 * 2 if glu else hidden_features
        mid = hidden // 2 if glu else hidden
        self.fc1 = Dense(in_features, hidden, bias, dtype, param_dtype,
                         device)
        self.norm = make_norm(norm_type, mid, norm_eps, dtype, param_dtype,
                              device) if use_norm else None
        self.fc2 = Dense(mid, out_features, bias, dtype, param_dtype, device)
        self.hidden_split: Optional[ModelAxis] = None

    def _fused(self, x: torch.Tensor) -> bool:
        widths = (x.shape[-1], self.fc1.weight.shape[0],
                  self.fc2.weight.shape[0])
        return (self.use_pallas and not self.glu and self.norm is None
                and self.act_name == "gelu_tanh"
                and self.drop == 0.0 and x.ndim == 3
                and all(w % WIDTH_MULTIPLE == 0 for w in widths))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cols = self.hidden_split
        if cols is not None:
            x = copy_in(x, cols)
        if self._fused(x):
            w1, w2 = self.fc1.weight.t(), self.fc2.weight.t()
            if cols is None:
                return mlp_gelu(x.to(self.dtype), w1, self.fc1.bias, w2,
                                self.fc2.bias)
            y = mlp_gelu_columns(x.to(self.dtype), w1, self.fc1.bias, w2)
            return self.fc2.add_bias(reduce_out(y, cols))
        x = self.fc1(x)
        if self.glu:
            gate, x = x.chunk(2, dim=-1)
            x = F.silu(gate) * x
        else:
            x = self.act(x)
        keep = None
        if cols is not None and self.drop > 0.0 and not deterministic:
            keep = _split_keep(x.shape, -1, cols, self.drop, generator,
                               x.device)
        x = dropout(x, self.drop, deterministic, generator, keep)
        if self.norm is not None:
            x = self.norm(x)
        if cols is None:
            y = self.fc2(x)
        else:
            y = self.fc2.add_bias(reduce_out(self.fc2.product(x), cols))
        return dropout(y, self.drop, deterministic, generator)


def attention_route(use_pallas: bool, qk_norm: bool, attn_dropping: bool,
                    num_heads: int, head_dim: int, seq_len: int) -> str:
    """The JAX layer's route (layers.py:296-299): the kernels only when
    `use_pallas and not qk_norm and not attn_dropping and head_dim % 64 ==
    0 and num_heads % 2 == 0`, then 'qkv_proj' for S <= 1024 and
    'qkv_cols' above; else 'plain'."""
    if not (use_pallas and not qk_norm and not attn_dropping
            and head_dim % 64 == 0 and num_heads % 2 == 0):
        return "plain"
    return "qkv_proj" if seq_len <= MAX_SEQ else "qkv_cols"


class Attention(nn.Module):
    """Multi-head self-attention (layers.py:265).

    Routed by the JAX layer's rule (`attention_route`; JAX `use_pallas`
    comes from the model's `use_pallas_attn`, off by default):
    * 'qkv_proj', S <= 1024: the fused projection + attention
      (ops/flash_attention.py::qkv_proj_attention, K1/K2); with a gradient
      one autograd Function, whose backward is the attention-backward
      kernel.
    * 'qkv_cols', S > 1024: the qkv Dense, then `fused_attention_qkv_cols`
      (the blocked kernels K4-K6 of ops/flash_blocked.py), then the proj
      Dense.
    The CUDA kernels run on the card, in bf16, fp16 or fp32 (a CUDA tensor
    of another dtype raises in the wrapper), their plain versions on the
    CPU, in any float dtype.
    * 'plain': the qkv Dense, the heads split, q_norm/k_norm, the
      fp32-softmax attention (`reference_attention`, the counterpart of
      JAX's multi_head_attention(use_pallas=False)) or, with an active
      attn_drop, dropout on the probabilities, under autograd.
    On every route `scale_norm` (scale_attn_norm, beit3) puts a norm on
    the merged heads before `proj` (layers.py:358-362); q_norm, k_norm and
    that norm take `norm_type`.

    Split over the model axis's heads (`heads_split`), qkv holds q, k and
    v of the rank's H/M heads and proj the same columns: the route is the
    model's, decided on its head count as JAX decides it, and the kernels
    run on the rank's heads (K1/K2 on my_vit_b's 6 of 12 at M = 2). An M
    that leaves an odd count of heads a rank (12 over 4) takes the same
    route: neither K1/K2 nor K4-K6 pairs heads. proj's partial products are
    summed over the ranks before its bias. Split over the tokens under sp
    (`seq_split`), the rank gathers the sequence, runs the unsplit route on
    it and keeps its own query rows for proj."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False, proj_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 norm_eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 use_pallas: bool = False, scale_norm: bool = False,
                 norm_type: str = "layernorm"):
        super().__init__()
        self.use_pallas = use_pallas
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qk_norm = qk_norm
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, param_dtype, device)
        if qk_norm:
            self.q_norm = make_norm(norm_type, self.head_dim, norm_eps, dtype,
                                    param_dtype, device)
            self.k_norm = make_norm(norm_type, self.head_dim, norm_eps, dtype,
                                    param_dtype, device)
        self.norm = make_norm(norm_type, dim, norm_eps, dtype, param_dtype,
                              device) if scale_norm else None
        self.proj = Dense(dim, dim, proj_bias, dtype, param_dtype, device)
        self.heads_split: Optional[ModelAxis] = None
        self.seq_split: Optional[ModelAxis] = None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        heads, tokens = self.heads_split, self.seq_split
        if tokens is not None:
            whole = gather_tokens(x, tokens)[:, :token_count()]
            o = token_slice(self._attend(whole, deterministic, generator),
                            tokens)
        else:
            if heads is not None:
                x = copy_in(x, heads)
            o = self._attend(x, deterministic, generator)
        if self.norm is not None:
            o = self.norm(o)
        if heads is None:
            y = self.proj(o)
        else:
            y = self.proj.add_bias(reduce_out(self.proj.product(o), heads))
        return dropout(y, self.proj_drop, deterministic, generator)

    def _attend(self, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """The merged heads (B, S, h·hd) of this rank's h heads (all of
        them unsplit), before the norm and proj."""
        b, s, _ = x.shape
        heads = self.heads_split
        h = self.num_heads // (heads.count if heads is not None else 1)
        hd = self.head_dim
        scale = hd ** -0.5
        attn_dropping = self.attn_drop > 0.0 and not deterministic
        route = attention_route(self.use_pallas, self.qk_norm, attn_dropping,
                                self.num_heads, hd, s)
        if route == "qkv_proj":
            o = qkv_proj_attention(x.to(self.dtype), self.qkv.weight.t(),
                                   self.qkv.bias, h, scale=scale)
        elif route == "qkv_cols":
            o = fused_attention_qkv_cols(self.qkv(x), h, scale=scale)
        else:
            qkv = self.qkv(x).reshape(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if self.qk_norm:
                # replicated norms inside the split: their gradient is the
                # ranks' sum
                through = None if heads is None else \
                    (lambda w: copy_in(w, heads))
                q, k = self.q_norm(q, through), self.k_norm(k, through)
            if attn_dropping:
                # dropout on the softmax probabilities (timm semantics)
                p = torch.softmax(
                    torch.matmul(q.float(), k.float().transpose(-1, -2))
                    * scale, dim=-1)
                keep = None if heads is None else _split_keep(
                    p.shape, 1, heads, self.attn_drop, generator, p.device)
                p = dropout(p, self.attn_drop, False, generator, keep)
                o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
            else:
                o = reference_attention(q, k, v, scale)
            o = o.transpose(1, 2).reshape(b, s, h * hd)
        return o


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
    (layers.py:402). Every norm takes `norm_type`; `glu`,
    `scale_attn_norm` and `scale_mlp_norm` go to the Mlp and the
    Attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_norm: bool = False,
                 proj_bias: bool = True, init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, act: str = "gelu",
                 norm_eps: float = 1e-6, mlp_hidden: Optional[int] = None,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, use_pallas_mlp: bool = False,
                 use_pallas_attn: bool = False, glu: bool = False,
                 norm_type: str = "layernorm", scale_attn_norm: bool = False,
                 scale_mlp_norm: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.drop_path_rate = drop_path_rate
        self.norm1 = make_norm(norm_type, dim, norm_eps, **kw)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_norm, proj_bias,
                              attn_drop, proj_drop, norm_eps,
                              use_pallas=use_pallas_attn,
                              scale_norm=scale_attn_norm,
                              norm_type=norm_type, **kw)
        self.ls1 = LayerScale(dim, init_values, param_dtype, device) \
            if init_values is not None else None
        self.norm2 = make_norm(norm_type, dim, norm_eps, **kw)
        self.mlp = Mlp(dim, mlp_hidden or int(dim * mlp_ratio), dim,
                       proj_bias, act, proj_drop, use_pallas=use_pallas_mlp,
                       glu=glu, use_norm=scale_mlp_norm, norm_type=norm_type,
                       norm_eps=norm_eps, **kw)
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


class AttentionPoolLatent(nn.Module):
    """The MAP head (layers.py:476-514): one learned latent query
    cross-attends over the tokens on the plain attention (JAX calls
    multi_head_attention at its default use_pallas=False), then proj, and
    an MLP residual behind a LayerNorm; returns the latent's row. Split
    over the model axis (`heads_split`), q, kv and proj hold the rank's
    heads as Attention's do, and the MLP its hidden columns."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_heads = num_heads
        self.latent = empty_param((1, 1, dim), param_dtype, device)
        self.q = Dense(dim, dim, True, **kw)
        self.kv = Dense(dim, 2 * dim, True, **kw)
        self.proj = Dense(dim, dim, True, **kw)
        self.norm = LayerNorm(dim, norm_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, **kw)
        self.heads_split: Optional[ModelAxis] = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.latent, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        heads = self.heads_split
        h = self.num_heads // (heads.count if heads is not None else 1)
        hd = d // self.num_heads
        latent = self.latent.to(x.dtype).expand(b, 1, d)
        if heads is not None:
            latent, x = copy_in(latent, heads), copy_in(x, heads)
        q = self.q(latent)
        k, v = self.kv(x).chunk(2, dim=-1)
        q = q.reshape(b, 1, h, hd).transpose(1, 2)
        k = k.reshape(b, s, h, hd).transpose(1, 2)
        v = v.reshape(b, s, h, hd).transpose(1, 2)
        o = reference_attention(q, k, v, hd ** -0.5)
        o = o.transpose(1, 2).reshape(b, 1, h * hd)
        if heads is None:
            o = self.proj(o)
        else:
            o = self.proj.add_bias(reduce_out(self.proj.product(o), heads))
        o = o + self.mlp(self.norm(o))
        return o[:, 0]


class ResPostBlock(nn.Module):
    """Residual post-norm block (layers.py:517-574): x + DP(LN(attn(x))),
    then x + DP(LN(mlp(x))). `init_values` is the post-norms' initial
    weight, not a LayerScale. Its Attention keeps the default norms and
    eps for q_norm/k_norm, and the Mlp its biases, as JAX builds them."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_norm: bool = False,
                 init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, act: str = "gelu",
                 norm_eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 use_pallas_mlp: bool = False, use_pallas_attn: bool = False,
                 glu: bool = False, norm_type: str = "layernorm"):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        w0 = init_values if init_values is not None else 1.0
        self.drop_path_rate = drop_path_rate
        self.attn = Attention(dim, num_heads, qkv_bias, qk_norm,
                              attn_drop=attn_drop, proj_drop=proj_drop,
                              use_pallas=use_pallas_attn, **kw)
        self.norm1 = LayerNorm(dim, norm_eps, weight_init=w0, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, True, act, proj_drop,
                       use_pallas=use_pallas_mlp, glu=glu, **kw)
        self.norm2 = LayerNorm(dim, norm_eps, weight_init=w0, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.norm1(self.attn(x, deterministic, generator))
        x = x + drop_path(y, self.drop_path_rate, deterministic, generator)
        y = self.norm2(self.mlp(x, deterministic, generator))
        return x + drop_path(y, self.drop_path_rate, deterministic, generator)


class ParallelScalingBlock(nn.Module):
    """ViT-22B's parallel block (layers.py:577-638): one in-projection of
    width 3·dim + mlp_hidden, **qkv first and the MLP second** as JAX
    slices it (timm's `in_split` puts the MLP first; ROADMAP §3), q_norm
    and k_norm, the plain attention (JAX passes use_pallas=False), the
    attention and MLP outputs summed, a LayerScale `ls`, one drop_path. No
    dropout; `glu` and the kernel switches are accepted and unused, as in
    JAX."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_norm: bool = True,
                 init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, act: str = "gelu",
                 norm_eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 use_pallas_mlp: bool = False, use_pallas_attn: bool = False,
                 glu: bool = False, norm_type: str = "layernorm"):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_heads = num_heads
        self.drop_path_rate = drop_path_rate
        self.act = act_fn(act)
        mlp_hidden = int(dim * mlp_ratio)
        self.in_norm = make_norm(norm_type, dim, norm_eps, **kw)
        self.in_proj = Dense(dim, 3 * dim + mlp_hidden, qkv_bias, **kw)
        if qk_norm:
            hd = dim // num_heads
            self.q_norm = make_norm(norm_type, hd, norm_eps, **kw)
            self.k_norm = make_norm(norm_type, hd, norm_eps, **kw)
        else:
            self.q_norm = self.k_norm = None
        self.attn_out_proj = Dense(dim, dim, True, **kw)
        self.mlp_out_proj = Dense(mlp_hidden, dim, True, **kw)
        self.ls = LayerScale(dim, init_values, param_dtype, device) \
            if init_values is not None else None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h
        fused = self.in_proj(self.in_norm(x))
        qkv, mlp_h = fused[..., :3 * d], fused[..., 3 * d:]
        qkv = qkv.reshape(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        o = reference_attention(q, k, v, hd ** -0.5)
        y = self.attn_out_proj(o.transpose(1, 2).reshape(b, s, d)) \
            + self.mlp_out_proj(self.act(mlp_h))
        if self.ls is not None:
            y = self.ls(y)
        return x + drop_path(y, self.drop_path_rate, deterministic, generator)


class _Branch(nn.Module):
    """One branch of ParallelThingsBlock under timm's names: `norm`, then
    `attn` or `mlp`, then the LayerScale `ls`."""

    def __init__(self, norm: nn.Module, name: str, fn: nn.Module,
                 ls: Optional[nn.Module]):
        super().__init__()
        self.norm = norm
        self.fn_name = name
        setattr(self, name, fn)
        self.ls = ls

    def forward(self, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        y = getattr(self, self.fn_name)(self.norm(x), deterministic,
                                        generator)
        return self.ls(y) if self.ls is not None else y


class ParallelThingsBlock(nn.Module):
    """"Three things everyone should know about ViTs" (layers.py:641-707):
    x + Σ DP(LS(attn_j(LN_j(x)))), then the same with `num_parallel` MLPs,
    each branch dropped on its own draw. timm's names: attns.{j} and
    ffns.{j}, each with norm, attn or mlp, and ls. The Attention keeps the
    default q_norm/k_norm, the Mlp its biases, as JAX builds them."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_norm: bool = False,
                 init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, act: str = "gelu",
                 norm_eps: float = 1e-6, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 use_pallas_mlp: bool = False, use_pallas_attn: bool = False,
                 glu: bool = False, norm_type: str = "layernorm",
                 num_parallel: int = 2):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.drop_path_rate = drop_path_rate

        def ls():
            return LayerScale(dim, init_values, param_dtype, device) \
                if init_values is not None else None

        self.attns = nn.ModuleList([_Branch(
            make_norm(norm_type, dim, norm_eps, **kw), "attn",
            Attention(dim, num_heads, qkv_bias, qk_norm, attn_drop=attn_drop,
                      proj_drop=proj_drop, use_pallas=use_pallas_attn, **kw),
            ls()) for _ in range(num_parallel)])
        self.ffns = nn.ModuleList([_Branch(
            make_norm(norm_type, dim, norm_eps, **kw), "mlp",
            Mlp(dim, int(dim * mlp_ratio), dim, True, act, proj_drop,
                use_pallas=use_pallas_mlp, glu=glu, **kw),
            ls()) for _ in range(num_parallel)])

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for branches in (self.attns, self.ffns):
            total = 0.0
            for branch in branches:
                total = total + drop_path(
                    branch(x, deterministic, generator), self.drop_path_rate,
                    deterministic, generator)
            x = x + total
        return x


BLOCK_TYPES = {
    "block": Block,
    "respost": ResPostBlock,
    "parallel_scaling": ParallelScalingBlock,
    "parallel_things": ParallelThingsBlock,
}


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `module` with the flax initializers, drawing
    from `generator` in module order."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
