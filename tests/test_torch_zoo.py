"""The port's model registry against the JAX zoo and tests/golden_params.json.

Every name the port registers is a name of the JAX package's
models/vision_transformer_zoo.py (its `VARIANTS` and the 25 `_vit_extra`
names) or a `my_vit_*` name, and every such JAX name is registered in the
port. Each builds with the parameter count of tests/golden_params.json
(built on the meta device, so nothing is allocated).
`vit_tiny_patch32_224` is kept as the JAX package keeps it, an extra that
the original registry lacks (ROADMAP F4), and the aimv2 names and the
SigLIP-2-era towers keep the JAX configs where they diverge from the
original (ROADMAP F2; `DIVERGENT_*`). Then the converter against the JAX exporter on the dinov2
tree (LayerScale gammas, a 1370-row pos_embed) and on its reg4 tree.
"""
import json
import os

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu.models import (
    vision_transformer_zoo as jax_zoo,
)
from vision_transformers_torch_xla_tpu.models.vision_transformer_zoo import (
    VARIANTS as JAX_VARIANTS,
)
from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models import (
    create_model,
    list_models,
)
from vision_transformers_torch_xla_tpu_torch.models.vision_transformer_zoo import (  # noqa: E501
    VARIANTS,
)

GOLDEN_PARAMS = os.path.join(os.path.dirname(__file__), "golden_params.json")
MY_VIT = tuple(f"my_vit_{s}" for s in ("b", "l", "m", "mini", "s", "ti",
                                        "xs"))
# names of the JAX registry that the original registry lacks (ROADMAP F4)
JAX_ONLY_EXTRAS = ("vit_tiny_patch32_224",)
# the names the JAX zoo registers after its VARIANTS table (`_vit_extra`)
JAX_EXTRA = tuple(sorted(set(jax_zoo.__all__) - set(JAX_VARIANTS)))
# names whose JAX config diverges from the original registry's (ROADMAP
# F2), ported as JAX has them: aimv2's packed SwiGLU at mlp_ratio 5.5 (the
# original has the unpacked one at 2.75; for aimv2_huge and _3b the
# original's 2 x 2.6667), and the SigLIP-2-era towers, which the original
# builds with act_layer='gelu_tanh' and JAX with the exact GELU
DIVERGENT_AIMV2 = tuple(n for n in JAX_EXTRA if n.startswith("aimv2_"))
DIVERGENT_SIGLIP2 = tuple(
    f"vit_{w}_siglip{gap}_{img}" for w, imgs in (
        ("base_patch32", (256,)), ("large_patch16", (512,)),
        ("so400m_patch16", (256, 384, 512)),
        ("giantopt_patch16", (256, 384)))
    for img in imgs for gap in ("", "_gap"))


def _golden():
    with open(GOLDEN_PARAMS) as f:
        return json.load(f)


def test_registry_is_the_jax_zoo_plus_my_vit():
    assert VARIANTS == JAX_VARIANTS
    assert set(list_models()) == set(jax_zoo.__all__) | set(MY_VIT)
    assert set(JAX_ONLY_EXTRAS) <= set(list_models())
    # 125 zoo names + 25 extra names + 7 my_vit names
    assert len(JAX_VARIANTS) == 125 and len(JAX_EXTRA) == 25
    assert len(list_models()) == 157
    assert len(DIVERGENT_AIMV2) == 12 and len(DIVERGENT_SIGLIP2) == 14
    assert set(DIVERGENT_SIGLIP2) <= set(JAX_VARIANTS)


@pytest.mark.parametrize("name", sorted(set(jax_zoo.__all__) | set(MY_VIT)))
def test_name_builds_with_golden_count_or_raises_m2(name):
    # every name builds: none raises naming ROADMAP M2 any more
    img, count = _golden()[name]
    model = create_model(name, img_size=img, device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("name", DIVERGENT_AIMV2 + DIVERGENT_SIGLIP2)
def test_divergent_names_keep_the_jax_config(name):
    # F2: JAX's config, not the original's
    model = create_model(name, depth=1, device=torch.device("meta"))
    mlp = model.blocks[0].mlp
    if name in DIVERGENT_SIGLIP2:
        assert mlp.act_name == "gelu" and model.global_pool in ("map",
                                                                 "avg")
        return
    # the packed SwiGLU's fc1 is 2 x 2.75 x dim wide
    d = model.patch_embed.proj.weight.shape[0]
    assert mlp.fc1.weight.shape == (int(d * 5.5) // 2 * 2, d)
    assert mlp.glu and mlp.fc1.bias is None


def test_naflex_delegation_raises_m8(monkeypatch):
    with pytest.raises(NotImplementedError, match="M8"):
        create_model("vit_base_patch16_224", use_naflex=True,
                     device=torch.device("meta"))
    monkeypatch.setenv("VTX_USE_NAFLEXVIT", "true")
    with pytest.raises(NotImplementedError, match="M8"):
        create_model("vit_small_patch16_224", device=torch.device("meta"))


def test_dinov2_is_the_long_sequence_model():
    model = create_model("vit_base_patch14_dinov2",
                         device=torch.device("meta"))
    sd = model.state_dict()
    assert sd["pos_embed"].shape == (1, 37 * 37 + 1, 768)
    assert sd["blocks.0.ls1.gamma"].shape == (768,)
    assert len(model.blocks) == 12 and model.blocks[0].attn.num_heads == 12


def test_convert_matches_torch_export_on_dinov2():
    # the dinov2 tree at depth 1: LayerScale gammas and the 518-px pos_embed
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        export_vit_state_dict,
    )
    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )

    model = jax_create("vit_base_patch14_dinov2", depth=1,
                       global_pool="token")
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0),
                           jnp.zeros((1, 518, 518, 3))))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    from flax import linen as nn

    params = nn.meta.unbox(params)
    ours = flax_to_state_dict(params)
    theirs = export_vit_state_dict({"params": params})
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours["pos_embed"].shape == (1, 1370, 768)
    port = create_model("vit_base_patch14_dinov2", depth=1,
                        global_pool="token", device=torch.device("meta"))
    port.load_state_dict(ours, strict=True, assign=True)


@pytest.mark.parametrize("name,img", [
    ("vit_base_patch14_reg4_dinov2", 518),
    ("vit_base_patch16_siglip_224", 224), ("beit3_base_patch16_224", 224),
    ("aimv2_large_patch14_224", 224)])
def test_convert_matches_torch_export_on_the_new_leaves(name, img):
    # reg_token, the MAP head, the scale norms, embed_norm and RMSNorm
    # scales, at depth 1: the converter writes the exporter's names
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        export_vit_state_dict,
    )
    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )

    model = jax_create(name, depth=1)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, img, img, 3))))
    rng = np.random.default_rng(1)
    params = nn.meta.unbox(jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes["params"]))
    ours = flax_to_state_dict(params)
    theirs = export_vit_state_dict({"params": params})
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    port = create_model(name, depth=1, device=torch.device("meta"))
    port.load_state_dict(ours, strict=True, assign=True)
