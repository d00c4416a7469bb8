"""ConvNeXt and ConvNeXt-V2 with timm parameter names.

Counterpart of vision_transformers_torch_xla_tpu/models/convnext.py
(`ConvNeXtBlock` :42, `ConvNeXt` :111, `_cnx_norm` :32, `_convnext` :201,
`_reg` :210) and its 31 registered names. The model takes the port's
NHWC batch and keeps its activations channels-last; its
`forward(x, deterministic, generator)` is the port ViT's, so the train
step, the eval step, the KD teacher and the server run it unchanged.

Parameter names are timm's, as JAX ckpt/torch_export.py writes them
(:186-245): `stem.0/1`, `stages.S.downsample.0/1`,
`stages.S.blocks.B.{conv_dw, norm, mlp.fc1, mlp.grn, mlp.fc2, gamma}`,
`head.norm`, `head.fc`; where the JAX exporter has no name, timm's:
the overlap stems' `stem.0` (first conv), `stem.1` or, after the gelu of
`overlap_act`, `stem.2` (second conv) and the norm after them,
`head.pre_logits.fc` (`head_hidden_size`) and `norm_pre`
(`head_norm_first`).

* The patch stem (4 x 4, stride 4) and the downsamples (2 x 2, stride 2)
  are a space-to-depth and a matmul, as in JAX; the weight is kept as
  timm's stride-p conv weight (O, I, p, p). The downsample's norm comes
  before the space-to-depth.
* Every other conv is flax `nn.Conv` with padding "SAME" (`Conv2d`):
  stride-1 depthwise convs (groups = channels, a kernel size per stage)
  and the overlap stems' 3 x 3 stride-2 pair, which pad (0, 1) on an
  even side, not torch's (1, 1).
* Norms: `ln` is the port's LayerNorm, `rms` and `simple` both flax
  `nn.RMSNorm` with a scale (JAX `_cnx_norm`); both keep fp32 statistics.
* GRN (v2) computes in fp32 with JAX's 1e-12 inside the root.
* Activations: exact gelu, gelu_tanh or silu; the layer scale `gamma`
  multiplies in the compute dtype; drop-path rates rise linearly over all
  blocks and draw from the step's generator (models/layers.py::drop_path).
* Head: pool then norm (`head.norm`), or norm then pool under
  `head_norm_first`; `head_hidden_size` adds a dense and gelu_tanh;
  `num_classes=0` returns the pooled features; logits are fp32.

The stage taps that JAX sows for models/features.py are not here (ROADMAP
M7). Nothing in this model runs a hand-written kernel: its convs and
matmuls are cuDNN's and cuBLAS's.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_torch_xla_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    RMSNorm,
    act_fn,
    drop_path,
    empty_param,
    trunc_normal_,
)
from vision_transformers_torch_xla_tpu_torch.models.registry import (
    register_model,
)
from vision_transformers_torch_xla_tpu_torch.ops.bias_grad import bias_add

__all__ = []

#: the activations JAX's ConvNeXtBlock takes (:62-65)
ACTS = ("gelu", "gelu_tanh", "silu")


def _cnx_norm(kind: str, dim: int, eps: float, dtype, param_dtype,
              device) -> nn.Module:
    """LayerNorm, or for 'rms' and 'simple' flax's RMSNorm (JAX :32-39)."""
    if kind in ("rms", "simple"):
        return RMSNorm(dim, eps, dtype, param_dtype, device)
    return LayerNorm(dim, eps, dtype, param_dtype, device)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding of one side: the output has ceil(size /
    stride) rows, the extra row of padding going after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax nn.Conv (padding 'SAME') on NHWC, in the compute dtype, the
    bias added there; weight (O, I / groups, k, k) as torch keeps it."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 groups: int = 1, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.k, self.stride, self.groups, self.dtype = k, stride, groups, dtype
        self.weight = empty_param((out_ch, in_ch // groups, k, k),
                                  param_dtype, device)
        self.bias = empty_param((out_ch,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (lft, r) = (same_pads(x.shape[1], self.k, self.stride),
                            same_pads(x.shape[2], self.k, self.stride))
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW, channels-last
        if (t, lft) == (b, r):
            pad = (t, lft)
        else:
            x, pad = F.pad(x, (lft, r, t, b)), 0
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride, pad,
                     groups=self.groups)
        return bias_add(y.permute(0, 2, 3, 1), self.bias)


class PatchDense(nn.Module):
    """A p x p, stride-p conv as JAX computes it: space-to-depth, then a
    dense over the (p, p, C) patch; weight (O, C, p, p) as timm's conv."""

    def __init__(self, in_ch: int, out_ch: int, p: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.p, self.dtype = p, dtype
        self.weight = empty_param((out_ch, in_ch, p, p), param_dtype, device)
        self.bias = empty_param((out_ch,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, 0.02, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.p
        x = x.to(self.dtype).reshape(b, h // p, p, w // p, p, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, h // p, w // p, p * p * c)
        w2 = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return bias_add(torch.matmul(x, w2.to(self.dtype).t()), self.bias)


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-V2 GRN over NHWC (JAX :74-88): in fp32,
    nx = ‖x‖₂ over H, W (+1e-12 in the root) / (its channel mean + 1e-6),
    then x + (γ·(x·nx) + β) cast to x's dtype."""

    def __init__(self, dim: int, param_dtype=torch.float32, device=None):
        super().__init__()
        self.weight = empty_param((dim,), param_dtype, device)
        self.bias = empty_param((dim,), param_dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        gx = torch.sqrt(x32.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return x + (self.weight.float() * (x32 * nx)
                    + self.bias.float()).to(x.dtype)


class ConvMlp(nn.Module):
    """fc1, the activation, [GRN], fc2 over the channels (timm's `mlp`)."""

    def __init__(self, dim: int, hidden: int, act: str, use_grn: bool,
                 dtype, param_dtype, device):
        super().__init__()
        self.act = act_fn(act)
        self.fc1 = Dense(dim, hidden, True, dtype, param_dtype, device)
        self.grn = GlobalResponseNorm(hidden, param_dtype, device) \
            if use_grn else None
        self.fc2 = Dense(hidden, dim, True, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.fc1(x))
        if self.grn is not None:
            x = self.grn(x)
        return self.fc2(x)


class ConvNeXtBlock(nn.Module):
    """x + DP(γ · mlp(norm(dwconv(x)))) on NHWC (JAX :42-71)."""

    def __init__(self, dim: int, drop_path_rate: float = 0.0,
                 layer_scale_init: float = 1e-6, mlp_ratio: int = 4,
                 kernel_size: int = 7, use_grn: bool = False,
                 norm_kind: str = "ln", norm_eps: float = 1e-6,
                 act: str = "gelu", dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.layer_scale_init = layer_scale_init
        self.conv_dw = Conv2d(dim, dim, kernel_size, groups=dim, dtype=dtype,
                              param_dtype=param_dtype, device=device)
        self.norm = _cnx_norm(norm_kind, dim, norm_eps, dtype, param_dtype,
                              device)
        self.mlp = ConvMlp(dim, mlp_ratio * dim, act, use_grn, dtype,
                           param_dtype, device)
        self.gamma = empty_param((dim,), param_dtype, device) \
            if layer_scale_init > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.gamma is not None:
            nn.init.constant_(self.gamma, self.layer_scale_init)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv_dw(x)))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + drop_path(y, self.drop_path_rate, deterministic, generator)


class ConvNeXtStage(nn.Module):
    """[norm, 2 x 2 space-to-depth dense] (stages past the first), then
    the blocks."""

    def __init__(self, in_dim: int, dim: int, blocks: Sequence[nn.Module],
                 norm: Optional[nn.Module], dtype, param_dtype, device):
        super().__init__()
        self.downsample = nn.Sequential(
            norm, PatchDense(in_dim, dim, 2, dtype, param_dtype, device)) \
            if norm is not None else None
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x, deterministic, generator)
        return x


class _HeadDense(Dense):
    """The classifier: truncated normal 0.02 x head_init_scale."""

    def __init__(self, *args, std: float = 0.02, **kwargs):
        super().__init__(*args, **kwargs)
        self.std = std

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, self.std, generator)
        nn.init.zeros_(self.bias)


class ConvNeXtHead(nn.Module):
    """[norm] (pool-then-norm), [pre_logits.fc + gelu_tanh], [fc]."""

    def __init__(self, dim: int, num_classes: int, norm: Optional[nn.Module],
                 hidden: Optional[int], head_init_scale: float, dtype,
                 param_dtype, device):
        super().__init__()
        self.norm = norm
        self.pre_logits = None
        if hidden:
            self.pre_logits = nn.Module()
            self.pre_logits.fc = Dense(dim, hidden, True, dtype, param_dtype,
                                       device)
            dim = hidden
        self.fc = _HeadDense(dim, num_classes, True, dtype, param_dtype,
                             device, std=0.02 * head_init_scale) \
            if num_classes > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        if self.pre_logits is not None:
            x = F.gelu(self.pre_logits.fc(x), approximate="tanh")
        if self.fc is None:
            return x
        return self.fc(x).float()


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 1000, drop_path_rate: float = 0.0,
                 layer_scale_init: float = 1e-6, head_init_scale: float = 1.0,
                 use_grn: bool = False, stem_type: str = "patch",
                 kernel_sizes: Optional[Tuple[int, ...]] = None,
                 norm_kind: str = "ln", norm_eps: float = 1e-6,
                 act: str = "gelu", head_norm_first: bool = False,
                 head_hidden_size: Optional[int] = None, img_size: int = 224,
                 in_chans: int = 3, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if stem_type not in ("patch", "overlap", "overlap_tiered",
                             "overlap_act"):
            raise ValueError(f"unknown stem_type {stem_type!r}")
        if act not in ACTS:
            raise ValueError(f"unknown act {act!r}; known {sorted(ACTS)}")
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.num_classes = num_classes
        self.img_size = img_size   # fully convolutional: any multiple of 32
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        def norm(dim):
            return _cnx_norm(norm_kind, dim, norm_eps, dtype, param_dtype,
                             device)

        if stem_type == "patch":
            stem = [PatchDense(in_chans, dims[0], 4, **kw)]
        else:
            mid = dims[0] // 2 if "tiered" in stem_type else dims[0]
            mid = max(8, (mid + 4) // 8 * 8)
            stem = [Conv2d(in_chans, mid, 3, 2, **kw)] + \
                ([nn.GELU(approximate="tanh")] if "act" in stem_type
                 else []) + \
                [Conv2d(mid, dims[0], 3, 2, **kw)]
        self.stem = nn.Sequential(*stem, norm(dims[0]))

        rates = np.linspace(0, drop_path_rate, sum(depths))
        stages, cur = [], 0
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            ks = kernel_sizes[s] if kernel_sizes else 7
            blocks = [ConvNeXtBlock(
                dim, drop_path_rate=float(rates[cur + i]),
                layer_scale_init=layer_scale_init, kernel_size=ks,
                use_grn=use_grn, norm_kind=norm_kind, norm_eps=norm_eps,
                act=act, **kw) for i in range(depth)]
            stages.append(ConvNeXtStage(
                dims[s - 1] if s else dim, dim, blocks,
                norm(dims[s - 1]) if s else None, **kw))
            cur += depth
        self.stages = nn.ModuleList(stages)
        self.norm_pre = norm(dims[-1]) if head_norm_first else None
        self.head = ConvNeXtHead(
            dims[-1], num_classes, None if head_norm_first else norm(dims[-1]),
            head_hidden_size, head_init_scale, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, C) -> logits (B, classes) in fp32, or the pooled
        features when num_classes is 0."""
        x = self.forward_features(x, deterministic, generator)
        return self.forward_head(x)

    def forward_features(self, x: torch.Tensor, deterministic: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        x = self.stem(x.to(self.dtype))
        for stage in self.stages:
            x = stage(x, deterministic, generator)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        return self.head(x.mean(dim=(1, 2)))


def _convnext(depths, dims, **kwargs) -> ConvNeXt:
    """The JAX factory's keywords (:201-205): the tag, global_pool and
    remat are dropped, init_values is the layer scale's init."""
    for k in ("pretrained_tag", "global_pool", "remat"):
        kwargs.pop(k, None)
    if "init_values" in kwargs:
        kwargs["layer_scale_init"] = kwargs.pop("init_values") or 1e-6
    return ConvNeXt(depths=depths, dims=dims, **kwargs)


def _reg(name: str, depths, dims, **cfg) -> None:
    def build(**kw):
        merged = {**cfg, **kw}
        d = merged.pop("depths", depths)
        c = merged.pop("dims", dims)
        return _convnext(d, c, **merged)

    build.__name__ = build.__qualname__ = name
    build.__doc__ = f"ConvNeXt variant {name!r} (JAX models/convnext.py)."
    setattr(sys.modules[__name__], name, register_model(build))


_V2 = dict(use_grn=True, layer_scale_init=0.0)
_TEST = dict(norm_eps=1e-5)
for _name, _depths, _dims, _cfg in (
        # timm experimental stems / norms / heads
        ("convnext_zepto_rms", (2, 2, 4, 2), (32, 64, 128, 256),
         dict(norm_kind="simple")),
        ("convnext_zepto_rms_ols", (2, 2, 4, 2), (32, 64, 128, 256),
         dict(norm_kind="simple", stem_type="overlap_act")),
        ("convnext_atto_ols", (2, 2, 6, 2), (40, 80, 160, 320),
         dict(stem_type="overlap_tiered")),
        ("convnext_atto_rms", (2, 2, 6, 2), (40, 80, 160, 320),
         dict(norm_kind="rms")),
        ("convnext_femto_ols", (2, 2, 6, 2), (48, 96, 192, 384),
         dict(stem_type="overlap_tiered")),
        ("convnext_pico_ols", (2, 2, 6, 2), (64, 128, 256, 512),
         dict(stem_type="overlap_tiered")),
        ("convnext_nano_ols", (2, 2, 8, 2), (80, 160, 320, 640),
         dict(stem_type="overlap")),
        ("convnext_tiny_hnf", (3, 3, 9, 3), (96, 192, 384, 768),
         dict(head_norm_first=True)),
        ("convnext_large_mlp", (3, 3, 27, 3), (192, 384, 768, 1536),
         dict(head_hidden_size=1536)),
        ("convnext_xxlarge", (3, 4, 30, 3), (384, 768, 1536, 3072),
         dict(norm_eps=1e-5)),
        # ConvNeXt-V2: GRN in the MLP, no layer scale
        ("convnextv2_atto", (2, 2, 6, 2), (40, 80, 160, 320), _V2),
        ("convnextv2_femto", (2, 2, 6, 2), (48, 96, 192, 384), _V2),
        ("convnextv2_pico", (2, 2, 6, 2), (64, 128, 256, 512), _V2),
        ("convnextv2_nano", (2, 2, 8, 2), (80, 160, 320, 640), _V2),
        ("convnextv2_tiny", (3, 3, 9, 3), (96, 192, 384, 768), _V2),
        ("convnextv2_small", (3, 3, 27, 3), (96, 192, 384, 768), _V2),
        ("convnextv2_base", (3, 3, 27, 3), (128, 256, 512, 1024), _V2),
        ("convnextv2_large", (3, 3, 27, 3), (192, 384, 768, 1536), _V2),
        ("convnextv2_huge", (3, 3, 27, 3), (352, 704, 1408, 2816), _V2),
        ("test_convnext", (1, 2, 4, 2), (24, 32, 48, 64),
         dict(_TEST, act="gelu_tanh")),
        ("test_convnext2", (1, 1, 1, 1), (32, 64, 96, 128),
         dict(_TEST, act="gelu_tanh")),
        ("test_convnext3", (1, 1, 1, 1), (32, 64, 96, 128),
         dict(_TEST, kernel_sizes=(7, 5, 5, 3), act="silu")),
        # the plain widths
        ("convnext_atto", (2, 2, 6, 2), (40, 80, 160, 320), {}),
        ("convnext_femto", (2, 2, 6, 2), (48, 96, 192, 384), {}),
        ("convnext_pico", (2, 2, 6, 2), (64, 128, 256, 512), {}),
        ("convnext_nano", (2, 2, 8, 2), (80, 160, 320, 640), {}),
        ("convnext_tiny", (3, 3, 9, 3), (96, 192, 384, 768), {}),
        ("convnext_small", (3, 3, 27, 3), (96, 192, 384, 768), {}),
        ("convnext_base", (3, 3, 27, 3), (128, 256, 512, 1024), {}),
        ("convnext_large", (3, 3, 27, 3), (192, 384, 768, 1536), {}),
        ("convnext_xlarge", (3, 3, 27, 3), (256, 512, 1024, 2048), {})):
    _reg(_name, _depths, _dims, **_cfg)
