"""A long-sequence ViT in the port against the JAX model, on the CPU.

A tiny ViT with S = 1025 tokens (32 px at patch 1, plus the class token;
width 128, 2 heads of 64, depth 2, LayerScale 0.5 so that attention moves
the output) takes the long route in both packages, both built with
use_pallas_attn=True: the JAX model runs `fused_attention_qkv_cols` -> the
blocked Pallas kernels (interpret mode), and the port's Attention runs its
`fused_attention_qkv_cols` -> ops/flash_blocked.py (the plain versions on
the CPU). Wrappers count both calls; the JAX one is a monkeypatched module
attribute, the JAX package itself is unchanged.

fp32 end to end: logits to 1e-4, the tolerance of
tests/test_reference_execution.py. Grads to 1e-4 of each parameter's
largest |grad|: the two attentions sum their 1025 keys in other orders and
blocks (256 on the TPU side, one pass in the plain version).
The JAX side takes ~25 s in interpret mode, so one module fixture runs it
once for every case.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models import layers
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)

CFG = dict(img_size=32, patch_size=1, embed_dim=128, depth=2, num_heads=2,
           num_classes=10, init_values=0.5, global_pool="token")
SEQ = 32 * 32 + 1


def _counting(fn, calls):
    def wrapped(*args, **kwargs):
        calls.append(args[0].shape)
        return fn(*args, **kwargs)

    return wrapped


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's params, logits and grads of sum(logits * w), and the
    sequence lengths its blocked kernel saw."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )
    from vision_transformers_torch_xla_tpu.ops import flash_blocked

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((2, 10)).astype(np.float32)
    model = JaxViT(**CFG, dtype=jnp.float32, use_pallas_attn=True)
    calls = []
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(flash_blocked, "flash_attention_blocked",
                   _counting(flash_blocked.flash_attention_blocked, calls))
        variables = model.init(jax.random.key(0), jnp.asarray(images))
        params = nn.meta.unbox(variables)["params"]
        del calls[:]

        def loss(p):
            logits = model.apply({"params": p}, jnp.asarray(images))
            return (logits * w).sum(), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return dict(params=jax.tree.map(np.asarray, params), images=images, w=w,
                logits=np.asarray(logits), calls=list(calls),
                grads=flax_to_state_dict(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def port_run(jax_run):
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "fused_attention_qkv_cols",
                   _counting(layers.fused_attention_qkv_cols, calls))
        model = VisionTransformer(**CFG, dtype=torch.float32,
                                  use_pallas_attn=True)
        model.load_state_dict(flax_to_state_dict(jax_run["params"]),
                              strict=True)
        logits = model(torch.from_numpy(jax_run["images"]))
        (logits * torch.from_numpy(jax_run["w"])).sum().backward()
    return dict(logits=logits.detach().numpy(), calls=calls,
                grads={k: p.grad.numpy() for k, p in model.named_parameters()})


def test_jax_side_took_the_blocked_route(jax_run):
    # one blocked call per block: (B, H, S, D) = (2, 2, 1025, 64)
    assert jax_run["calls"] == [(2, 2, SEQ, 64)] * CFG["depth"]


def test_port_took_the_long_route(port_run):
    assert port_run["calls"] == [(2, SEQ, 3 * 128)] * CFG["depth"]


def test_logits_match_jax_fp32(jax_run, port_run):
    assert port_run["logits"].shape == (2, 10)
    np.testing.assert_allclose(port_run["logits"], jax_run["logits"],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("part", ["attn.qkv", "attn.proj", "ls1", "mlp",
                                  "norm1", "patch_embed", "pos_embed"])
def test_grads_match_jax_fp32(jax_run, port_run, part):
    names = [k for k in jax_run["grads"] if part in k]
    assert names and set(jax_run["grads"]) == set(port_run["grads"])
    for k in names:
        want = jax_run["grads"][k].numpy()
        got = port_run["grads"][k]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
