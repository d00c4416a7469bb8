"""PyTorch VisionTransformer with timm parameter names.

Counterpart of vision_transformers_torch_xla_tpu/models/vit.py
::VisionTransformer (:72) for block_type='block': patch embed, class token,
learned position embedding, pre-norm blocks with LayerScale and stochastic
depth, the token / avg / avgmax / max pools, and the trunk norm or the
post-pool fc_norm (never both, :292-303, :331-334). Input is NHWC
(B, H, W, 3), as in the JAX model; logits are fp32.

Options outside this slice raise NotImplementedError naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.models.layers import (
    Block,
    Dense,
    LayerNorm,
    PatchEmbed,
    dropout,
    empty_param,
    trunc_normal_,
)


def _not_ported(what: str, item: str = "M2") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP {item})")


# Param name fragments excluded from weight decay, as the JAX model's
# (vit.py:350); with the ndim > 1 rule of train/optim.py::wd_mask.
NO_WEIGHT_DECAY_KEYWORDS = ("pos_embed", "cls_token", "reg_token", "latent",
                            "dist_token", "gamma", "bias", "scale")


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_norm: bool = False, proj_bias: bool = True,
                 init_values: Optional[float] = None,
                 class_token: bool = True, reg_tokens: int = 0,
                 global_pool: str = "token",
                 pool_include_prefix: bool = False,
                 fc_norm: Optional[bool] = None, drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 pre_norm: bool = False, no_embed_class: bool = False,
                 act_layer: str = "gelu", norm_eps: float = 1e-6,
                 final_norm: bool = True,
                 mlp_hidden: Optional[Sequence[int]] = None,
                 block_type: str = "block", patch_drop_rate: float = 0.0,
                 dynamic_img_size: bool = False, scan_blocks: bool = False,
                 remat: bool = False, swiglu_mlp: bool = False,
                 norm_type: str = "layernorm", embed_norm: bool = False,
                 scale_attn_norm: bool = False, scale_mlp_norm: bool = False,
                 use_pallas_mlp: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        unported = [
            (global_pool == "map", "global_pool='map'"),
            (reg_tokens > 0, "reg_tokens"),
            (dynamic_img_size, "dynamic_img_size"),
            (scan_blocks, "scan_blocks"),
            (remat, "remat"),
            (patch_drop_rate > 0, "patch dropout"),
            (block_type != "block", f"block_type={block_type!r}"),
            (swiglu_mlp, "swiglu_mlp"),
            (norm_type != "layernorm", f"norm_type={norm_type!r}"),
            (embed_norm, "embed_norm"),
            (scale_attn_norm, "scale_attn_norm"),
            (scale_mlp_norm, "scale_mlp_norm"),
        ]
        for bad, what in unported:
            if bad:
                raise _not_ported(what)
        if global_pool not in ("", "token", "avg", "avgmax", "max"):
            raise ValueError(f"unknown global_pool {global_pool!r}")
        self.num_classes = num_classes
        self.global_pool = global_pool
        self.pool_include_prefix = pool_include_prefix
        self.class_token = class_token
        self.no_embed_class = no_embed_class
        self.drop_rate = drop_rate
        self.pos_drop_rate = pos_drop_rate
        self.grid = img_size // patch_size
        self.use_fc_norm = fc_norm if fc_norm is not None else \
            global_pool in ("avg", "avgmax", "max")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        # CLIP towers drop the embed bias under pre-norm (vit.py:177-179)
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      bias=not pre_norm, **kw)
        self.cls_token = empty_param((1, 1, embed_dim), param_dtype, device) \
            if class_token else None
        pos_prefix = 0 if no_embed_class else self.num_prefix_tokens
        self.pos_embed = empty_param(
            (1, self.grid ** 2 + pos_prefix, embed_dim), param_dtype, device)
        self.norm_pre = LayerNorm(embed_dim, norm_eps, **kw) \
            if pre_norm else None
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_norm,
                  proj_bias, init_values,
                  drop_path_rate * i / max(depth - 1, 1), proj_drop_rate,
                  attn_drop_rate, act_layer, norm_eps,
                  int(mlp_hidden[i]) if mlp_hidden is not None else None,
                  use_pallas_mlp=use_pallas_mlp, **kw)
            for i in range(depth)])
        self.norm = LayerNorm(embed_dim, norm_eps, **kw) \
            if final_norm and not self.use_fc_norm else None
        self.fc_norm = LayerNorm(embed_dim, norm_eps, **kw) \
            if final_norm and self.use_fc_norm else None
        self.head = Dense(embed_dim, num_classes, True, **kw) \
            if num_classes > 0 else None

    @property
    def num_prefix_tokens(self) -> int:
        return 1 if self.class_token else 0

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.cls_token is not None:
            trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.forward_features(x, deterministic, generator)
        return self.forward_head(x, deterministic, generator)

    def forward_features(self, x: torch.Tensor, deterministic: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """vit.py:173; x: (B, H, W, C) -> tokens (B, N, D)."""
        x = self.patch_embed(x)
        if x.shape[1] != self.grid ** 2:
            raise ValueError(
                f"input grid {x.shape[1]} patches != configured "
                f"{self.grid ** 2}; dynamic_img_size is not in the port yet "
                f"(ROADMAP M2)")
        prefix = [self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)] \
            if self.cls_token is not None else []
        pos = self.pos_embed.to(x.dtype)
        if self.no_embed_class:
            x = torch.cat(prefix + [x + pos], dim=1)
        else:
            x = torch.cat(prefix + [x], dim=1) + pos
        x = dropout(x, self.pos_drop_rate, deterministic, generator)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x, deterministic, generator)
        if self.norm is not None:
            x = self.norm(x)
        return x

    def forward_head(self, x: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None,
                     pre_logits: bool = False) -> torch.Tensor:
        """vit.py:305: pool, fc_norm, head."""
        npt = 0 if self.pool_include_prefix else self.num_prefix_tokens
        if self.global_pool == "token":
            pooled = x[:, 0]
        elif self.global_pool in ("avg", "avgmax", "max"):
            tokens = x[:, npt:]
            if self.global_pool == "avg":
                pooled = tokens.mean(dim=1)
            elif self.global_pool == "max":
                pooled = tokens.amax(dim=1)
            else:
                pooled = 0.5 * (tokens.amax(dim=1) + tokens.mean(dim=1))
        else:
            pooled = x  # no pooling: token features
        if self.fc_norm is not None:
            pooled = self.fc_norm(pooled)
        pooled = dropout(pooled, self.drop_rate, deterministic, generator)
        if pre_logits or self.head is None:
            return pooled
        return self.head(pooled).float()
