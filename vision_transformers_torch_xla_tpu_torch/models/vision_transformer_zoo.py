"""Registered ViT variants: the JAX zoo's names and configs.

Counterpart of vision_transformers_torch_xla_tpu/models/
vision_transformer_zoo.py: the same width presets `_W`, the same
`VARIANTS` table (name -> width preset, patch, image size, extra kwargs)
and the same entrypoint per name over the port's VisionTransformer (:1-340),
then the same extra names the JAX zoo registers through `_vit_extra`
(:347-416): FlexiViT, AIMv2, the BEiT-3 remaps, the EVA-large resolutions
and test_vit1-4. The NaFlexVit delegation of `_build_vit` raises naming
ROADMAP M8. Like the JAX table this one keeps `vit_tiny_patch32_224`,
which the original registry lacks (ROADMAP F4), and the JAX package's
configs where they diverge from the original (F2: aimv2's mlp_ratio 5.5
and the SigLIP towers' exact GELU).
"""
from __future__ import annotations

import os
import sys

from vision_transformers_torch_xla_tpu_torch.models.registry import (
    register_model,
)
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)

__all__ = []

# width presets: name -> (embed_dim, depth, num_heads)
_W = {
    "wee": (256, 14, 4),
    "pwee": (256, 16, 4),
    "little": (320, 14, 5),
    "tiny": (192, 12, 3),
    "xsmall": (256, 10, 4),
    "small": (384, 12, 6),
    "medium": (512, 12, 8),
    "mediumd": (512, 20, 8),
    "betwixt": (640, 12, 10),
    "base": (768, 12, 12),
    "plus": (896, 12, 14),
    "large": (1024, 24, 16),
    "so150m": (896, 18, 14),
    "so150m2": (832, 21, 13),
    "huge": (1280, 32, 16),
    "so400m": (1152, 27, 16),
    "giant": (1408, 40, 16),
    "giantopt": (1536, 40, 16),
    "gigantic": (1664, 48, 16),
}

_GAP = dict(class_token=False, global_pool="avg", fc_norm=False)
_CLIP = dict(pre_norm=True, norm_eps=1e-5)
_QUICK = dict(pre_norm=True, act_layer="quick_gelu", norm_eps=1e-5)
# siglip towers use the default exact GELU (reference vision_transformer.py
# :3562-3568 sets no act_layer)
_SIGLIP = dict(class_token=False, global_pool="map")
_SIGLIP_GAP = dict(class_token=False, global_pool="avg", fc_norm=False)
_XP = dict(pre_norm=True, no_embed_class=True, norm_type="rmsnorm",
           block_type="parallel_scaling", qkv_bias=False, qk_norm=True)

# name -> (width_key, patch, img, extra kwargs). Sizes/flags mirror the
# reference entrypoint bodies (vision_transformer.py:2691+).
VARIANTS = {
    # ----- classic supervised (augreg) -----
    "vit_tiny_patch16_224": ("tiny", 16, 224, {}),
    "vit_tiny_patch16_384": ("tiny", 16, 384, {}),
    "vit_small_patch32_224": ("small", 32, 224, {}),
    "vit_small_patch32_384": ("small", 32, 384, {}),
    "vit_small_patch16_224": ("small", 16, 224, {}),
    "vit_small_patch16_384": ("small", 16, 384, {}),
    "vit_small_patch8_224": ("small", 8, 224, {}),
    "vit_base_patch32_224": ("base", 32, 224, {}),
    "vit_base_patch32_384": ("base", 32, 384, {}),
    "vit_base_patch16_224": ("base", 16, 224, {}),
    "vit_base_patch16_384": ("base", 16, 384, {}),
    "vit_base_patch8_224": ("base", 8, 224, {}),
    "vit_large_patch32_224": ("large", 32, 224, {}),
    "vit_large_patch32_384": ("large", 32, 384, {}),
    "vit_large_patch16_224": ("large", 16, 224, {}),
    "vit_large_patch16_384": ("large", 16, 384, {}),
    "vit_large_patch14_224": ("large", 14, 224, {}),
    "vit_huge_patch14_224": ("huge", 14, 224, {}),
    "vit_giant_patch14_224": ("giant", 14, 224, dict(mlp_ratio=48 / 11)),
    "vit_gigantic_patch14_224": ("gigantic", 14, 224, dict(mlp_ratio=64 / 13)),
    "vit_base_patch16_224_miil": ("base", 16, 224, dict(qkv_bias=False)),
    # ----- GAP (no class token) -----
    "vit_medium_patch16_gap_240": ("medium", 16, 240,
                                   dict(qkv_bias=False, init_values=1e-6, **_GAP)),
    "vit_medium_patch16_gap_256": ("medium", 16, 256,
                                   dict(qkv_bias=False, init_values=1e-6, **_GAP)),
    "vit_medium_patch16_gap_384": ("medium", 16, 384,
                                   dict(qkv_bias=False, init_values=1e-6, **_GAP)),
    "vit_betwixt_patch16_gap_256": ("betwixt", 16, 256,
                                    dict(qkv_bias=False, init_values=1e-6, **_GAP)),
    "vit_base_patch16_gap_224": ("base", 16, 224, dict(num_heads=16, **_GAP)),
    "vit_huge_patch14_gap_224": ("huge", 14, 224, dict(**_GAP)),
    "vit_huge_patch16_gap_448": ("huge", 16, 448, dict(**_GAP)),
    "vit_giant_patch16_gap_224": ("giant", 16, 224,
                                  dict(mlp_ratio=48 / 11, **_GAP)),
    # ----- CLIP towers (pre-norm) -----
    "vit_xsmall_patch16_clip_224": ("xsmall", 16, 224, dict(**_CLIP)),
    "vit_medium_patch32_clip_224": ("medium", 32, 224, dict(**_CLIP)),
    "vit_medium_patch16_clip_224": ("medium", 16, 224, dict(**_CLIP)),
    "vit_betwixt_patch32_clip_224": ("betwixt", 32, 224, dict(**_CLIP)),
    "vit_base_patch32_clip_224": ("base", 32, 224, dict(**_CLIP)),
    "vit_base_patch32_clip_256": ("base", 32, 256, dict(**_CLIP)),
    "vit_base_patch32_clip_384": ("base", 32, 384, dict(**_CLIP)),
    "vit_base_patch32_clip_448": ("base", 32, 448, dict(**_CLIP)),
    "vit_base_patch16_clip_224": ("base", 16, 224, dict(**_CLIP)),
    "vit_base_patch16_clip_384": ("base", 16, 384, dict(**_CLIP)),
    "vit_base_patch16_plus_clip_240": ("plus", 16, 240, dict(**_CLIP)),
    "vit_large_patch14_clip_224": ("large", 14, 224, dict(**_CLIP)),
    "vit_large_patch14_clip_336": ("large", 14, 336, dict(**_CLIP)),
    "vit_huge_patch14_clip_224": ("huge", 14, 224, dict(**_CLIP)),
    "vit_huge_patch14_clip_336": ("huge", 14, 336, dict(**_CLIP)),
    "vit_huge_patch14_clip_378": ("huge", 14, 378, dict(**_CLIP)),
    "vit_giant_patch14_clip_224": ("giant", 14, 224,
                                   dict(mlp_ratio=48 / 11, **_CLIP)),
    "vit_gigantic_patch14_clip_224": ("gigantic", 14, 224,
                                      dict(mlp_ratio=64 / 13, **_CLIP)),
    "vit_base_patch32_clip_quickgelu_224": ("base", 32, 224, dict(**_QUICK)),
    "vit_base_patch16_clip_quickgelu_224": ("base", 16, 224, dict(**_QUICK)),
    "vit_large_patch14_clip_quickgelu_224": ("large", 14, 224, dict(**_QUICK)),
    "vit_large_patch14_clip_quickgelu_336": ("large", 14, 336, dict(**_QUICK)),
    "vit_huge_patch14_clip_quickgelu_224": ("huge", 14, 224, dict(**_QUICK)),
    "vit_huge_patch14_clip_quickgelu_378": ("huge", 14, 378, dict(**_QUICK)),
    "vit_gigantic_patch14_clip_quickgelu_224": (
        "gigantic", 14, 224, dict(mlp_ratio=64 / 13, **_QUICK)),
    # ----- plus / layer-scale -----
    "vit_base_patch32_plus_256": ("plus", 32, 256, dict(init_values=1e-5)),
    "vit_base_patch16_plus_240": ("plus", 16, 240, dict(init_values=1e-5)),
    # ----- alternative blocks -----
    "vit_base_patch16_rpn_224": ("base", 16, 224,
                                 dict(qkv_bias=False, init_values=1e-5,
                                      class_token=False, global_pool="avg",
                                      block_type="respost")),
    "vit_small_patch16_36x1_224": ("small", 16, 224,
                                   dict(depth=36, init_values=1e-5)),
    "vit_small_patch16_18x2_224": ("small", 16, 224,
                                   dict(depth=18, init_values=1e-5,
                                        block_type="parallel_things")),
    "vit_base_patch16_18x2_224": ("base", 16, 224,
                                  dict(depth=18, init_values=1e-5,
                                       block_type="parallel_things")),
    "vit_base_patch16_xp_224": ("base", 16, 224, dict(**_XP)),
    "vit_large_patch14_xp_224": ("large", 14, 224, dict(**_XP)),
    "vit_huge_patch14_xp_224": ("huge", 14, 224, dict(**_XP)),
    # ----- dinov2 -----
    "vit_small_patch14_dinov2": ("small", 14, 518, dict(init_values=1e-5)),
    "vit_base_patch14_dinov2": ("base", 14, 518, dict(init_values=1e-5)),
    "vit_large_patch14_dinov2": ("large", 14, 518, dict(init_values=1e-5)),
    "vit_giant_patch14_dinov2": ("giant", 14, 518,
                                 dict(embed_dim=1536, num_heads=24,
                                      init_values=1e-5,
                                      mlp_ratio=2 * 2.66667, swiglu_mlp=True,
                                      act_layer="silu")),
    "vit_small_patch14_reg4_dinov2": (
        "small", 14, 518, dict(init_values=1e-5, reg_tokens=4,
                               no_embed_class=True)),
    "vit_base_patch14_reg4_dinov2": (
        "base", 14, 518, dict(init_values=1e-5, reg_tokens=4,
                              no_embed_class=True)),
    "vit_large_patch14_reg4_dinov2": (
        "large", 14, 518, dict(init_values=1e-5, reg_tokens=4,
                               no_embed_class=True)),
    "vit_giant_patch14_reg4_dinov2": (
        "giant", 14, 518, dict(embed_dim=1536, num_heads=24, init_values=1e-5,
                               mlp_ratio=2 * 2.66667, swiglu_mlp=True,
                               act_layer="silu", reg_tokens=4,
                               no_embed_class=True)),
    # ----- siglip (MAP pooled) -----
    "vit_base_patch32_siglip_256": ("base", 32, 256, dict(**_SIGLIP)),
    "vit_base_patch16_siglip_224": ("base", 16, 224, dict(**_SIGLIP)),
    "vit_base_patch16_siglip_256": ("base", 16, 256, dict(**_SIGLIP)),
    "vit_base_patch16_siglip_384": ("base", 16, 384, dict(**_SIGLIP)),
    "vit_base_patch16_siglip_512": ("base", 16, 512, dict(**_SIGLIP)),
    "vit_large_patch16_siglip_256": ("large", 16, 256, dict(**_SIGLIP)),
    "vit_large_patch16_siglip_384": ("large", 16, 384, dict(**_SIGLIP)),
    "vit_large_patch16_siglip_512": ("large", 16, 512, dict(**_SIGLIP)),
    "vit_so400m_patch14_siglip_224": ("so400m", 14, 224,
                                      dict(mlp_ratio=3.7362, **_SIGLIP)),
    "vit_so400m_patch14_siglip_378": ("so400m", 14, 378,
                                      dict(mlp_ratio=3.7362, **_SIGLIP)),
    "vit_so400m_patch14_siglip_384": ("so400m", 14, 384,
                                      dict(mlp_ratio=3.7362, **_SIGLIP)),
    "vit_so400m_patch16_siglip_256": ("so400m", 16, 256,
                                      dict(mlp_ratio=3.7362, **_SIGLIP)),
    "vit_so400m_patch16_siglip_384": ("so400m", 16, 384,
                                      dict(mlp_ratio=3.7362, **_SIGLIP)),
    "vit_so400m_patch16_siglip_512": ("so400m", 16, 512,
                                      dict(mlp_ratio=3.7362, **_SIGLIP)),
    "vit_giantopt_patch16_siglip_256": ("giantopt", 16, 256, dict(**_SIGLIP)),
    "vit_giantopt_patch16_siglip_384": ("giantopt", 16, 384, dict(**_SIGLIP)),
    "vit_base_patch32_siglip_gap_256": ("base", 32, 256, dict(**_SIGLIP_GAP)),
    "vit_base_patch16_siglip_gap_224": ("base", 16, 224, dict(**_SIGLIP_GAP)),
    "vit_base_patch16_siglip_gap_256": ("base", 16, 256, dict(**_SIGLIP_GAP)),
    "vit_base_patch16_siglip_gap_384": ("base", 16, 384, dict(**_SIGLIP_GAP)),
    "vit_base_patch16_siglip_gap_512": ("base", 16, 512, dict(**_SIGLIP_GAP)),
    "vit_large_patch16_siglip_gap_256": ("large", 16, 256, dict(**_SIGLIP_GAP)),
    "vit_large_patch16_siglip_gap_384": ("large", 16, 384, dict(**_SIGLIP_GAP)),
    "vit_large_patch16_siglip_gap_512": ("large", 16, 512, dict(**_SIGLIP_GAP)),
    "vit_so400m_patch14_siglip_gap_224": (
        "so400m", 14, 224, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch14_siglip_gap_378": (
        "so400m", 14, 378, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch14_siglip_gap_384": (
        "so400m", 14, 384, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch14_siglip_gap_448": (
        "so400m", 14, 448, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch14_siglip_gap_896": (
        "so400m", 14, 896, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch16_siglip_gap_256": (
        "so400m", 16, 256, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch16_siglip_gap_384": (
        "so400m", 16, 384, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_so400m_patch16_siglip_gap_512": (
        "so400m", 16, 512, dict(mlp_ratio=3.7362, **_SIGLIP_GAP)),
    "vit_giantopt_patch16_siglip_gap_256": ("giantopt", 16, 256,
                                            dict(**_SIGLIP_GAP)),
    "vit_giantopt_patch16_siglip_gap_384": ("giantopt", 16, 384,
                                            dict(**_SIGLIP_GAP)),
    # ----- reg-token GAP ("searching for better baselines") -----
    "vit_wee_patch16_reg1_gap_256": (
        "wee", 16, 256, dict(init_values=1e-5, mlp_ratio=5, class_token=False,
                             no_embed_class=True, reg_tokens=1,
                             global_pool="avg")),
    "vit_pwee_patch16_reg1_gap_256": (
        "pwee", 16, 256, dict(init_values=1e-5, mlp_ratio=5, class_token=False,
                              no_embed_class=True, reg_tokens=1,
                              global_pool="avg",
                              block_type="parallel_scaling")),
    "vit_little_patch16_reg1_gap_256": (
        "little", 16, 256, dict(init_values=1e-5, mlp_ratio=5.6,
                                class_token=False, no_embed_class=True,
                                reg_tokens=1, global_pool="avg")),
    "vit_little_patch16_reg4_gap_256": (
        "little", 16, 256, dict(init_values=1e-5, mlp_ratio=5.6,
                                class_token=False, no_embed_class=True,
                                reg_tokens=4, global_pool="avg")),
    "vit_medium_patch16_reg1_gap_256": (
        "medium", 16, 256, dict(init_values=1e-5, class_token=False,
                                no_embed_class=True, reg_tokens=1,
                                global_pool="avg")),
    "vit_medium_patch16_reg4_gap_256": (
        "medium", 16, 256, dict(init_values=1e-5, class_token=False,
                                no_embed_class=True, reg_tokens=4,
                                global_pool="avg")),
    "vit_mediumd_patch16_reg4_gap_256": (
        "mediumd", 16, 256, dict(init_values=1e-5, class_token=False,
                                 no_embed_class=True, reg_tokens=4,
                                 global_pool="avg")),
    "vit_mediumd_patch16_reg4_gap_384": (
        "mediumd", 16, 384, dict(init_values=1e-5, class_token=False,
                                 no_embed_class=True, reg_tokens=4,
                                 global_pool="avg")),
    "vit_betwixt_patch16_reg1_gap_256": (
        "betwixt", 16, 256, dict(init_values=1e-5, class_token=False,
                                 no_embed_class=True, reg_tokens=1,
                                 global_pool="avg")),
    "vit_betwixt_patch16_reg4_gap_256": (
        "betwixt", 16, 256, dict(init_values=1e-5, class_token=False,
                                 no_embed_class=True, reg_tokens=4,
                                 global_pool="avg")),
    "vit_betwixt_patch16_reg4_gap_384": (
        "betwixt", 16, 384, dict(init_values=1e-5, class_token=False,
                                 no_embed_class=True, reg_tokens=4,
                                 global_pool="avg")),
    "vit_base_patch16_reg4_gap_256": (
        "base", 16, 256, dict(class_token=False, no_embed_class=True,
                              reg_tokens=4, global_pool="avg")),
    "vit_so150m_patch16_reg4_map_256": (
        "so150m", 16, 256, dict(mlp_ratio=2.572, class_token=False,
                                reg_tokens=4, global_pool="map")),
    "vit_so150m_patch16_reg4_gap_256": (
        "so150m", 16, 256, dict(mlp_ratio=2.572, class_token=False,
                                reg_tokens=4, global_pool="avg",
                                fc_norm=False)),
    "vit_so150m_patch16_reg4_gap_384": (
        "so150m", 16, 384, dict(mlp_ratio=2.572, class_token=False,
                                reg_tokens=4, global_pool="avg",
                                fc_norm=False)),
    "vit_so150m2_patch16_reg1_gap_256": (
        "so150m2", 16, 256, dict(mlp_ratio=34 / 13, init_values=1e-5,
                                 qkv_bias=False, class_token=False,
                                 reg_tokens=1, global_pool="avg")),
    "vit_so150m2_patch16_reg1_gap_384": (
        "so150m2", 16, 384, dict(mlp_ratio=34 / 13, init_values=1e-5,
                                 qkv_bias=False, class_token=False,
                                 reg_tokens=1, global_pool="avg")),
    "vit_so150m2_patch16_reg1_gap_448": (
        "so150m2", 16, 448, dict(mlp_ratio=34 / 13, init_values=1e-5,
                                 qkv_bias=False, class_token=False,
                                 reg_tokens=1, global_pool="avg")),
    # ----- misc -----
    "vit_intern300m_patch14_448": (
        "large", 14, 448, dict(init_values=0.1, final_norm=False,
                               dynamic_img_size=True)),
    # patch32 tiny is a this-repo convenience (reference lacks it)
    "vit_tiny_patch32_224": ("tiny", 32, 224, {}),
}


def _build_vit(cfg):
    """The classic ViT; `use_naflex` (or VTX_USE_NAFLEXVIT /
    TIMM_USE_NAFLEXVIT = true, as the JAX hook reads them) asks for the
    NaFlexVit delegation, which is not ported."""
    use_naflex = cfg.pop("use_naflex", None)
    if use_naflex is None:
        use_naflex = (
            os.environ.get("VTX_USE_NAFLEXVIT",
                           os.environ.get("TIMM_USE_NAFLEXVIT", "false"))
            .lower() == "true")
    if use_naflex:
        raise NotImplementedError(
            "the NaFlexVit delegation (use_naflex) is not in the port yet "
            "(ROADMAP M8)")
    return VisionTransformer(**cfg)


def _make_entrypoint(name, width_key, patch, img, extra):
    base_dim, base_depth, base_heads = _W[width_key]

    def entrypoint(**kw):
        kw.pop("pretrained_tag", None)
        cfg = dict(img_size=img, patch_size=patch, embed_dim=base_dim,
                   depth=base_depth, num_heads=base_heads)
        cfg.update(extra)
        cfg.update(kw)
        return _build_vit(cfg)

    entrypoint.__name__ = name
    entrypoint.__qualname__ = name
    entrypoint.__doc__ = f"ViT variant {name!r} (the JAX zoo's config)."
    return entrypoint


_mod = sys.modules[__name__]
for _name, (_wk, _patch, _img, _extra) in VARIANTS.items():
    setattr(_mod, _name, register_model(
        _make_entrypoint(_name, _wk, _patch, _img, _extra)))


# ---------------------------------------------------------------------------
# the JAX zoo's extra names (:347-416): FlexiViT, AIMv2, BEiT-3 remaps,
# EVA-large fine-tune resolutions, test_vit1-4
# ---------------------------------------------------------------------------

def _vit_extra(name, **cfg):
    def build(**kw):
        kw.pop("pretrained_tag", None)
        return _build_vit(dict(cfg, **{k: v for k, v in kw.items()
                                       if v is not None}))

    build.__name__ = name
    build.__qualname__ = name
    build.__doc__ = f"ViT variant {name!r} (the JAX zoo's config)."
    setattr(_mod, name, register_model(build))


for _n, _d, _h in (("flexivit_small", 384, 6), ("flexivit_base", 768, 12),
                   ("flexivit_large", 1024, 16)):
    _vit_extra(_n, patch_size=16, img_size=240, embed_dim=_d,
               depth=24 if _d == 1024 else 12, num_heads=_h,
               no_embed_class=True, global_pool="token", fc_norm=False)

# AIMv2 as the JAX zoo has it (ROADMAP F2): the packed SwiGLU at mlp_ratio
# 5.5 for the original's unpacked 2.75
_AIMV2 = dict(patch_size=14, class_token=False, fc_norm=False,
              mlp_ratio=5.5, global_pool="avg", qkv_bias=False,
              proj_bias=False, act_layer="silu", norm_type="rmsnorm",
              norm_eps=1e-5, embed_norm=True, swiglu_mlp=True)
for _sz, (_d, _dep, _h) in {"large": (1024, 24, 8),
                            "huge": (1536, 24, 12),
                            "1b": (2048, 24, 16),
                            "3b": (3072, 24, 24)}.items():
    for _res in (224, 336, 448):
        _vit_extra(f"aimv2_{_sz}_patch14_{_res}", img_size=_res,
                   embed_dim=_d, depth=_dep, num_heads=_h, **_AIMV2)

# BEiT-3 remaps: cls token, avg pool, the scale norms, eps 1e-5
for _n, (_p, _d, _dep, _h, _res) in {
        "beit3_base_patch16_224": (16, 768, 12, 12, 224),
        "beit3_large_patch16_224": (16, 1024, 24, 16, 224),
        "beit3_giant_patch14_224": (14, 1408, 40, 16, 224),
        "beit3_giant_patch14_336": (14, 1408, 40, 16, 336)}.items():
    _vit_extra(_n, patch_size=_p, img_size=_res, embed_dim=_d, depth=_dep,
               num_heads=_h, global_pool="avg", norm_eps=1e-5,
               scale_attn_norm=True, scale_mlp_norm=True, mlp_ratio=4.0
               if "giant" not in _n else 6144 / 1408)

for _res in (196, 336):
    _vit_extra(f"eva_large_patch14_{_res}", patch_size=14, img_size=_res,
               embed_dim=1024, depth=24, num_heads=16, global_pool="avg")

_vit_extra("test_vit", patch_size=16, img_size=160, embed_dim=64, depth=6,
           num_heads=2, mlp_ratio=3.0, dynamic_img_size=True)
_vit_extra("test_vit2", patch_size=16, img_size=160, embed_dim=64,
           depth=8, num_heads=2, mlp_ratio=3.0, class_token=False,
           reg_tokens=1, global_pool="avg", init_values=1e-5,
           dynamic_img_size=True)
_vit_extra("test_vit3", patch_size=16, img_size=160, embed_dim=96,
           depth=9, num_heads=3, mlp_ratio=2.0, class_token=False,
           reg_tokens=1, global_pool="map", init_values=1e-5)
_vit_extra("test_vit4", patch_size=16, img_size=160, embed_dim=96,
           depth=9, num_heads=3, mlp_ratio=3.0, class_token=False,
           reg_tokens=1, global_pool="avg", init_values=1e-5,
           dynamic_img_size=True, norm_type="rmsnorm")
