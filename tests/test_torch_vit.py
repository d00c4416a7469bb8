"""The port's VisionTransformer against the JAX model on the same weights.

The JAX model is initialized, its params go through the port's
ckpt/convert.py and load with strict=True, and both run the same seeded
NHWC batch. In fp32 the logits agree to 1e-4, the logits tolerance of
tests/test_reference_execution.py. Both models run with use_pallas_attn
(the JAX Pallas attention in interpret mode on the CPU, the port's kernel
route with its plain versions) and without it.
"""
import json
import os

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
    load_checkpoint,
)
from vision_transformers_torch_xla_tpu_torch.models import create_model
from vision_transformers_torch_xla_tpu_torch.models.layers import (
    drop_path,
    init_weights,
)
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)

CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
           num_classes=10)
GOLDEN_PARAMS = os.path.join(os.path.dirname(__file__), "golden_params.json")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _images(n=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _jax_model_and_params(pallas: bool, dtype: str = "float32", hw=32,
                          **kw):
    """The JAX ViT (Pallas attention in interpret mode when `pallas`) and its
    params, initialized on `hw`-pixel images, as a nested dict of numpy
    arrays."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )

    model = JaxViT(**{**CFG, **kw}, dtype=getattr(jnp, dtype),
                   use_pallas_attn=pallas)
    with pltpu.force_tpu_interpret_mode():
        variables = model.init(jax.random.key(0),
                               jnp.asarray(_images(size=hw)))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables)["params"])
    return model, params


def _jax_logits(model, params, images):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out = model.apply({"params": params}, jnp.asarray(images))
    return np.asarray(out.astype(jnp.float32))


def _port(params, dtype=torch.float32, pallas=False, **kw):
    model = VisionTransformer(**{**CFG, **kw}, dtype=dtype,
                              use_pallas_attn=pallas)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
@pytest.mark.parametrize("pool", ["token", "avg"])
def test_vit_matches_jax_fp32(pool, act, pallas):
    kw = dict(global_pool=pool, act_layer=act)
    jax_model, params = _jax_model_and_params(pallas, **kw)
    images = _images()
    want = _jax_logits(jax_model, params, images)
    with torch.no_grad():
        got = _port(params, pallas=pallas, **kw)(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pallas", [False, True])
def test_vit_matches_jax_bf16_policy(pallas):
    # bf16 compute over fp32 params in both, each with use_pallas_attn =
    # pallas, so both take one attention route and share every rounding
    # point; matmul summation orders differ, which can flip a bf16
    # rounding: the bf16 logits (|logit| < 0.5 here, ulp 2^-9) differ by
    # up to one ulp on the CPU (1.95e-3 at seeds 1-3): atol 5e-3
    kw = dict(global_pool="avg", act_layer="gelu_tanh")
    jax_model, params = _jax_model_and_params(pallas, "bfloat16", **kw)
    images = _images(seed=1)
    want = _jax_logits(jax_model, params, images)
    with torch.no_grad():
        got = _port(params, torch.bfloat16, pallas,
                    **kw)(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


def test_convert_matches_torch_export():
    # the port's converter and the JAX package's exporter agree key for key
    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        export_vit_state_dict,
    )

    _, params = _jax_model_and_params(False, init_values=1e-5,
                                      global_pool="avg")
    ours = flax_to_state_dict(params)
    theirs = export_vit_state_dict({"params": params})
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


def test_loads_save_torch_checkpoint(tmp_path):
    # the .pth the JAX package writes loads strict into the port
    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        save_torch_checkpoint,
    )

    jax_model, params = _jax_model_and_params(False)
    path = str(tmp_path / "model.pth")
    save_torch_checkpoint(path, {"params": params}, arch="vit",
                          extra={"epoch": 3})
    model = VisionTransformer(**CFG, dtype=torch.float32)
    model.load_state_dict(load_checkpoint(path), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(_images()))
    np.testing.assert_allclose(got.numpy(),
                               _jax_logits(jax_model, params, _images()),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["my_vit_mini", "my_vit_ti", "my_vit_xs",
                                  "my_vit_s", "my_vit_b", "my_vit_m",
                                  "my_vit_l"])
def test_param_count_matches_golden(name):
    with open(GOLDEN_PARAMS) as f:
        img, count = json.load(f)[name]
    model = create_model(name, img_size=img, device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("pool,has_fc_norm", [("token", False), ("avg", True),
                                              ("max", True), ("avgmax", True)])
def test_norm_and_fc_norm_are_exclusive(pool, has_fc_norm):
    model = create_model("my_vit_mini", global_pool=pool,
                         device=torch.device("meta"))
    keys = set(model.state_dict())
    assert ("fc_norm.weight" in keys) == has_fc_norm
    assert ("norm.weight" in keys) != has_fc_norm


@pytest.mark.parametrize("kw", [
    dict(global_pool="max", qk_norm=True),
    dict(global_pool="avgmax", pre_norm=True, norm_eps=1e-5),
    dict(global_pool="avg", class_token=False, init_values=1e-5),
    dict(global_pool="token", no_embed_class=True, qkv_bias=False),
    dict(global_pool="avg", pool_include_prefix=True, proj_bias=False),
    dict(global_pool="token", final_norm=False, mlp_hidden=(96, 160)),
    # the MAP head, with and without register tokens (SigLIP, so150m)
    dict(global_pool="map", class_token=False),
    dict(global_pool="map", class_token=False, reg_tokens=2),
    # register tokens: dinov2's (no_embed_class) and the reg-GAP towers'
    dict(reg_tokens=4, no_embed_class=True, init_values=1e-5),
    dict(reg_tokens=1, class_token=False, global_pool="avg",
         init_values=1e-5),
    # patch dropout is off in eval
    dict(patch_drop_rate=0.5, reg_tokens=1),
    # dynamic_img_size: the grid grown (4 -> 6) and shrunk (4 -> 2, 4 -> 3;
    # jax.image.resize antialiases when it shrinks)
    dict(dynamic_img_size=True, reg_tokens=1, image_hw=48),
    dict(dynamic_img_size=True, image_hw=16),
    dict(dynamic_img_size=True, no_embed_class=True, reg_tokens=2,
         class_token=False, global_pool="avg", image_hw=24),
    # the other block types: rpn's ResPost, ParallelThings (18x2), xp's
    # parallel scaling (RMSNorm, qk_norm, no qkv bias) and pwee's
    dict(block_type="respost", qkv_bias=False, init_values=1e-5,
         class_token=False, global_pool="avg"),
    dict(block_type="parallel_things", init_values=1e-5),
    dict(block_type="parallel_scaling", pre_norm=True, no_embed_class=True,
         norm_type="rmsnorm", qkv_bias=False, qk_norm=True),
    dict(block_type="parallel_scaling", init_values=1e-5, mlp_ratio=5,
         class_token=False, no_embed_class=True, reg_tokens=1,
         global_pool="avg"),
    # SwiGLU (dinov2 giant), aimv2's RMSNorm + embed_norm + SwiGLU, beit3's
    # scale norms, RMSNorm with qk_norm
    dict(swiglu_mlp=True, act_layer="silu", mlp_ratio=2 * 2.66667,
         init_values=1e-5),
    dict(class_token=False, fc_norm=False, mlp_ratio=5.5, global_pool="avg",
         qkv_bias=False, proj_bias=False, act_layer="silu",
         norm_type="rmsnorm", norm_eps=1e-5, embed_norm=True,
         swiglu_mlp=True),
    dict(global_pool="avg", norm_eps=1e-5, scale_attn_norm=True,
         scale_mlp_norm=True),
    dict(global_pool="max", norm_type="rmsnorm", qk_norm=True,
         pre_norm=True),
    # so400m at 384 px floors its patch-14 grid to 27: 36 px at patch 8
    # floors to 4
    dict(img_size=36, class_token=False, global_pool="map", image_hw=36)])
def test_vit_options_match_jax_fp32(kw):
    kw = dict(kw)
    hw = kw.pop("image_hw", 32)
    # params made on the configured size; dynamic_img_size cases then run
    # on another
    jax_model, params = _jax_model_and_params(
        False, hw=kw.get("img_size", CFG["img_size"]), **kw)
    images = _images(seed=2, size=hw)
    with torch.no_grad():
        got = _port(params, **kw)(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(),
                               _jax_logits(jax_model, params, images),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", [
    # beit3: the scale norm between K1 and the projection
    dict(global_pool="avg", norm_eps=1e-5, scale_attn_norm=True,
         scale_mlp_norm=True),
    # rpn: ResPost with no qkv bias (K2 writes no bias partials)
    dict(block_type="respost", qkv_bias=False, init_values=1e-5,
         class_token=False, global_pool="avg"),
    # ParallelThings: two attention branches a block
    dict(block_type="parallel_things", init_values=1e-5)],
    ids=["beit3", "rpn", "parallel_things"])
def test_new_blocks_on_the_kernel_route_match_jax(kw):
    # use_pallas_attn on both: JAX's Pallas kernels in interpret mode, the
    # port's kernel route with the plain versions of K1/K2 on the CPU
    jax_model, params = _jax_model_and_params(True, **kw)
    images = _images(seed=3)
    with torch.no_grad():
        got = _port(params, pallas=True, **kw)(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(),
                               _jax_logits(jax_model, params, images),
                               atol=1e-4, rtol=1e-4)


def test_grid_mismatch_raises_without_dynamic_img_size():
    model = VisionTransformer(**CFG, device=torch.device("meta"))
    with pytest.raises(ValueError, match="dynamic_img_size"):
        model(torch.zeros(1, 48, 48, 3, device="meta"))
    # set_input_size keeps the parameters and turns the resampling on
    model.set_input_size(48)
    assert model.dynamic_img_size and model.pos_grid == 4
    assert model(torch.zeros(1, 48, 48, 3, device="meta")).shape == (1, 10)


def test_seeded_init_is_reproducible():
    a = VisionTransformer(**CFG)
    b = VisionTransformer(**CFG)
    init_weights(a, torch.Generator().manual_seed(0))
    init_weights(b, torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.blocks[0].attn.qkv.weight.detach()
    # flax truncated_normal(0.02): std 0.02, cut at 2 x 0.02 / 0.8796
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert float(w.abs().max()) <= 0.04 / 0.8796


def test_drop_path_takes_a_generator():
    x = torch.ones(64, 3, 4)
    assert drop_path(x, 0.5, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.5, False, None)
    y1 = drop_path(x, 0.5, False, torch.Generator().manual_seed(1))
    y2 = drop_path(x, 0.5, False, torch.Generator().manual_seed(1))
    assert torch.equal(y1, y2)
    kept = y1[:, 0, 0]
    assert set(kept.tolist()) <= {0.0, 2.0} and 0 < int((kept > 0).sum()) < 64


@pytest.mark.cuda
def test_vit_on_cuda_matches_cpu(cuda_device):
    # the kernel path (bf16, CUDA) against the plain path (bf16, CPU)
    model = VisionTransformer(**{**CFG, "embed_dim": 768, "num_heads": 12,
                                 "img_size": 224, "patch_size": 16},
                              global_pool="avg", act_layer="gelu_tanh")
    init_weights(model, torch.Generator().manual_seed(0))
    images = torch.from_numpy(_images(2, 224))
    with torch.inference_mode():
        want = model.eval()(images)
        got = model.to(cuda_device)(images.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, atol=5e-2, rtol=0)
