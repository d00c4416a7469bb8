"""The port's model registry against the JAX zoo and tests/golden_params.json.

Every name the port registers is a `VARIANTS` key of the JAX package's
models/vision_transformer_zoo.py or a `my_vit_*` name, and every JAX
`VARIANTS` key is registered in the port. A name the port can build has the
parameter count of tests/golden_params.json (built on the meta device, so
nothing is allocated); a name whose options are not ported raises
NotImplementedError naming ROADMAP M2, and those names are listed here.
`vit_tiny_patch32_224` is kept as the JAX package keeps it, an extra that
the original registry lacks (ROADMAP F4). Then the converter against the
JAX exporter on the dinov2 tree (LayerScale gammas, a 1370-row pos_embed).
"""
import json
import os

import numpy as np
import pytest
import torch

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
# names whose options the port lacks: each raises naming ROADMAP M2
NOT_PORTED = {
    "global_pool='map'": (
        "vit_base_patch16_siglip_224", "vit_base_patch16_siglip_256",
        "vit_base_patch16_siglip_384", "vit_base_patch16_siglip_512",
        "vit_base_patch32_siglip_256", "vit_giantopt_patch16_siglip_256",
        "vit_giantopt_patch16_siglip_384", "vit_large_patch16_siglip_256",
        "vit_large_patch16_siglip_384", "vit_large_patch16_siglip_512",
        "vit_so150m_patch16_reg4_map_256", "vit_so400m_patch14_siglip_224",
        "vit_so400m_patch14_siglip_378", "vit_so400m_patch14_siglip_384",
        "vit_so400m_patch16_siglip_256", "vit_so400m_patch16_siglip_384",
        "vit_so400m_patch16_siglip_512"),
    "reg_tokens": (
        "vit_base_patch14_reg4_dinov2", "vit_base_patch16_reg4_gap_256",
        "vit_betwixt_patch16_reg1_gap_256",
        "vit_betwixt_patch16_reg4_gap_256",
        "vit_betwixt_patch16_reg4_gap_384", "vit_giant_patch14_reg4_dinov2",
        "vit_large_patch14_reg4_dinov2", "vit_little_patch16_reg1_gap_256",
        "vit_little_patch16_reg4_gap_256", "vit_medium_patch16_reg1_gap_256",
        "vit_medium_patch16_reg4_gap_256",
        "vit_mediumd_patch16_reg4_gap_256",
        "vit_mediumd_patch16_reg4_gap_384", "vit_pwee_patch16_reg1_gap_256",
        "vit_small_patch14_reg4_dinov2", "vit_so150m2_patch16_reg1_gap_256",
        "vit_so150m2_patch16_reg1_gap_384",
        "vit_so150m2_patch16_reg1_gap_448",
        "vit_so150m_patch16_reg4_gap_256", "vit_so150m_patch16_reg4_gap_384",
        "vit_wee_patch16_reg1_gap_256"),
    "block_type=": (
        "vit_base_patch16_18x2_224", "vit_base_patch16_rpn_224",
        "vit_base_patch16_xp_224", "vit_huge_patch14_xp_224",
        "vit_large_patch14_xp_224", "vit_small_patch16_18x2_224"),
    "swiglu_mlp": ("vit_giant_patch14_dinov2",),
    "dynamic_img_size": ("vit_intern300m_patch14_448",),
}
RAISES = {n: what for what, names in NOT_PORTED.items() for n in names}


def _golden():
    with open(GOLDEN_PARAMS) as f:
        return json.load(f)


def test_registry_is_the_jax_zoo_plus_my_vit():
    assert VARIANTS == JAX_VARIANTS
    assert set(list_models()) == set(JAX_VARIANTS) | set(MY_VIT)
    assert set(JAX_ONLY_EXTRAS) <= set(list_models())
    # 125 zoo names + 7 my_vit names; 46 raise naming M2, 86 build
    assert len(list_models()) == 132
    assert len(RAISES) == 46 and set(RAISES) <= set(JAX_VARIANTS)


@pytest.mark.parametrize("name", sorted(set(JAX_VARIANTS) | set(MY_VIT)))
def test_name_builds_with_golden_count_or_raises_m2(name):
    img, count = _golden()[name]
    if name in RAISES:
        with pytest.raises(NotImplementedError, match="ROADMAP M2") as e:
            create_model(name, img_size=img, device=torch.device("meta"))
        assert RAISES[name] in str(e.value)
        return
    model = create_model(name, img_size=img, device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == count


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
