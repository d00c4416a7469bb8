"""PyTorch VisionTransformer with timm parameter names.

Counterpart of vision_transformers_torch_xla_tpu/models/vit.py
::VisionTransformer (:72): patch embed (with aimv2's norm), class and
register tokens, a learned position embedding (resampled at run time with
`dynamic_img_size`), patch dropout, the four block types of
models/layers.py::BLOCK_TYPES, the token / avg / avgmax / max / map pools,
and the trunk norm or the post-pool fc_norm (never both, :292-303,
:331-334); every norm takes `norm_type`. Input is NHWC (B, H, W, 3), as in
the JAX model; logits are fp32.

`remat` checkpoints each block (`remat_block`), with JAX's 'nothing' and
'dots' policies. `scan_blocks` keeps the `blocks.{i}` modules and timm
names (eager PyTorch has no compile time to save) and takes the JAX scan
path's semantics (:49-70, :261-275): every block is a `Block`, whatever
`block_type` says (ROADMAP F10), and remat recomputes everything.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from vision_transformers_torch_xla_tpu_torch.models.layers import (
    BLOCK_TYPES,
    AttentionPoolLatent,
    Block,
    Dense,
    PatchEmbed,
    dropout,
    empty_param,
    make_norm,
    trunc_normal_,
)
from vision_transformers_torch_xla_tpu_torch.models.pretrained import (
    resample_pos_embed,
)

# Param name fragments excluded from weight decay, as the JAX model's
# (vit.py:350); with the ndim > 1 rule of train/optim.py::wd_mask.
NO_WEIGHT_DECAY_KEYWORDS = ("pos_embed", "cls_token", "reg_token", "latent",
                            "dist_token", "gamma", "bias", "scale")
REMAT_POLICIES = ("nothing", "dots")
# the products without batch dims: the Dense projections (JAX
# dots_with_no_batch_dims_saveable); attention's products are bmm
_DENSE_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dense(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DENSE_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(block: nn.Module, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator],
                policy: str = "nothing") -> torch.Tensor:
    """`block(x, deterministic, generator)` under
    torch.utils.checkpoint (non-reentrant): the backward runs the block
    again. 'nothing' keeps only its input; 'dots' also keeps the Dense
    products (aten.mm / addmm).

    The block's dropout, attention-dropout and drop_path masks come from the
    passed `generator`, which checkpoint's preserve_rng_state does not
    save. So the generator's state is taken before the block, the recompute
    runs from it, and the generator is then put back where the recompute
    found it: the backward sees the forward's masks, as JAX's functional
    keys give them under remat."""
    context_fn = ckpt.noop_context_fn
    if policy == "dots":
        def context_fn():
            return ckpt.create_selective_checkpoint_contexts(_save_dense)
    replay = None if deterministic or generator is None \
        else generator.get_state()
    calls = [0]

    def run(x):
        calls[0] += 1
        if replay is None or calls[0] == 1:
            return block(x, deterministic, generator)
        now = generator.get_state()
        generator.set_state(replay)
        try:
            return block(x, deterministic, generator)
        finally:
            generator.set_state(now)

    return ckpt.checkpoint(run, x, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context_fn)


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_norm: bool = False, scale_attn_norm: bool = False,
                 scale_mlp_norm: bool = False, proj_bias: bool = True,
                 init_values: Optional[float] = None,
                 class_token: bool = True, reg_tokens: int = 0,
                 global_pool: str = "token",
                 pool_include_prefix: bool = False,
                 fc_norm: Optional[bool] = None, drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 pre_norm: bool = False, no_embed_class: bool = False,
                 act_layer: str = "gelu", swiglu_mlp: bool = False,
                 norm_type: str = "layernorm", norm_eps: float = 1e-6,
                 embed_norm: bool = False, final_norm: bool = True,
                 block_type: str = "block", patch_drop_rate: float = 0.0,
                 dynamic_img_size: bool = False,
                 pos_grid: Optional[int] = None,
                 mlp_hidden: Optional[Sequence[int]] = None,
                 use_pallas_attn: bool = False,
                 use_pallas_mlp: bool = False, remat: bool = False,
                 remat_policy: str = "nothing", scan_blocks: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if global_pool not in ("", "token", "avg", "avgmax", "max", "map"):
            raise ValueError(f"unknown global_pool {global_pool!r}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; known "
                             f"{REMAT_POLICIES}")
        block_cls = BLOCK_TYPES[block_type]
        if mlp_hidden is not None and (scan_blocks or block_type != "block"):
            raise ValueError("mlp_hidden (pruned per-block widths) requires "
                             "loop mode with block_type='block'")
        self.num_classes = num_classes
        self.global_pool = global_pool
        self.pool_include_prefix = pool_include_prefix
        self.class_token = class_token
        self.reg_tokens = reg_tokens
        self.no_embed_class = no_embed_class
        self.drop_rate = drop_rate
        self.pos_drop_rate = pos_drop_rate
        self.patch_drop_rate = patch_drop_rate
        self.img_size = img_size
        self.dynamic_img_size = dynamic_img_size
        # the grid the pos_embed parameter is sized for
        self.pos_grid = pos_grid or img_size // patch_size
        self.remat = remat
        # under scan, JAX's remat is always nothing_saveable (:63-65)
        self.remat_policy = "nothing" if scan_blocks else remat_policy
        self.scan_blocks = scan_blocks
        self.use_fc_norm = fc_norm if fc_norm is not None else \
            global_pool in ("avg", "avgmax", "max")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)

        # CLIP towers drop the embed bias under pre-norm (vit.py:177-179)
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      bias=not pre_norm, use_norm=embed_norm,
                                      norm_type=norm_type, norm_eps=norm_eps,
                                      **kw)
        self.cls_token = empty_param((1, 1, embed_dim), param_dtype, device) \
            if class_token else None
        self.reg_token = empty_param((1, reg_tokens, embed_dim), param_dtype,
                                     device) if reg_tokens else None
        self.pos_prefix = 0 if no_embed_class else self.num_prefix_tokens
        self.pos_embed = empty_param(
            (1, self.pos_grid ** 2 + self.pos_prefix, embed_dim), param_dtype,
            device)
        self.norm_pre = make_norm(norm_type, embed_dim, norm_eps, **kw) \
            if pre_norm else None
        block_kwargs = dict(
            num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
            qk_norm=qk_norm, init_values=init_values,
            proj_drop=proj_drop_rate, attn_drop=attn_drop_rate,
            act=act_layer, glu=swiglu_mlp, norm_type=norm_type,
            norm_eps=norm_eps, use_pallas_attn=use_pallas_attn,
            use_pallas_mlp=use_pallas_mlp, **kw)
        if block_type == "block":
            # only the plain Block takes the beit3/aimv2 extras (:244-249)
            block_kwargs.update(scale_attn_norm=scale_attn_norm,
                                scale_mlp_norm=scale_mlp_norm,
                                proj_bias=proj_bias)
        if scan_blocks:
            # the JAX scan body builds Block whatever block_type says (:62)
            block_cls = Block
        self.blocks = nn.ModuleList([
            block_cls(embed_dim, drop_path_rate=drop_path_rate * i
                      / max(depth - 1, 1), **block_kwargs,
                      **({} if mlp_hidden is None
                         else {"mlp_hidden": int(mlp_hidden[i])}))
            for i in range(depth)])
        self.norm = make_norm(norm_type, embed_dim, norm_eps, **kw) \
            if final_norm and not self.use_fc_norm else None
        self.attn_pool = AttentionPoolLatent(
            embed_dim, num_heads, mlp_ratio, norm_eps, **kw) \
            if global_pool == "map" else None
        self.fc_norm = make_norm(norm_type, embed_dim, norm_eps, **kw) \
            if final_norm and self.use_fc_norm else None
        self.head = Dense(embed_dim, num_classes, True, **kw) \
            if num_classes > 0 else None

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.reg_tokens

    def set_input_size(self, img_size: int) -> "VisionTransformer":
        """Take `img_size` inputs with the same parameters (vit.py:147-153):
        the position embedding keeps its grid and is resampled in the
        forward. Changes this module in place and returns it."""
        self.img_size = img_size
        self.dynamic_img_size = True
        return self

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.cls_token is not None:
            trunc_normal_(self.cls_token, 0.02, generator)
        if self.reg_token is not None:
            trunc_normal_(self.reg_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.forward_features(x, deterministic, generator)
        return self.forward_head(x, deterministic, generator)

    def _patch_dropout(self, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """Keep the prefix tokens and a random `max(1, int(n · (1 -
        rate)))` of the n patch tokens (vit.py:155-166)."""
        if generator is None:
            raise ValueError("patch dropout needs an explicit "
                             "torch.Generator")
        npt = self.num_prefix_tokens
        prefix, patches = x[:, :npt], x[:, npt:]
        b, n, d = patches.shape
        keep = max(1, int(n * (1.0 - self.patch_drop_rate)))
        scores = torch.rand((b, n), generator=generator, device=x.device)
        idx = scores.argsort(dim=-1)[:, :keep]
        kept = patches.gather(1, idx[..., None].expand(b, keep, d))
        return torch.cat([prefix, kept], dim=1) if npt else kept

    def forward_features(self, x: torch.Tensor, deterministic: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """vit.py:173; x: (B, H, W, C) -> tokens (B, N, D)."""
        b = x.shape[0]
        x = self.patch_embed(x)
        n = x.shape[1]
        prefix = [t.to(x.dtype).expand(b, -1, -1)
                  for t in (self.cls_token, self.reg_token) if t is not None]
        g = self.pos_grid
        pos = self.pos_embed
        if n != g * g:
            if not self.dynamic_img_size:
                raise ValueError(
                    f"input grid {n} patches != configured {g * g}; set "
                    f"dynamic_img_size=True or img_size to match")
            side = int(n ** 0.5)
            pos = resample_pos_embed(pos, (side, side), (g, g),
                                     self.pos_prefix)
        pos = pos.to(x.dtype)
        if self.no_embed_class:
            x = torch.cat(prefix + [x + pos], dim=1)
        else:
            x = torch.cat(prefix + [x], dim=1) + pos
        x = dropout(x, self.pos_drop_rate, deterministic, generator)
        if self.patch_drop_rate > 0 and not deterministic:
            x = self._patch_dropout(x, generator)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = remat_block(blk, x, deterministic, generator,
                            self.remat_policy) if remat \
                else blk(x, deterministic, generator)
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
        elif self.global_pool == "map":
            pooled = self.attn_pool(x[:, npt:])
        else:
            pooled = x  # no pooling: token features
        if self.fc_norm is not None:
            pooled = self.fc_norm(pooled)
        pooled = dropout(pooled, self.drop_rate, deterministic, generator)
        if pre_logits or self.head is None:
            return pooled
        return self.head(pooled).float()
