"""The rest of the ViT trunk in the port: remat, scan_blocks, patch dropout,
layer decay on both trees, and the 8 models of
tests/test_reference_execution.py, each held against the JAX package.

* remat: with drop_path, dropout and attention dropout on, one generator
  seed gives the same gradients with `remat=True` (both policies) as
  without it, because `models/vit.py::remat_block` replays the generator
  in the recompute (a naive wrap does not); and the port's remat gradients
  match the JAX model's remat gradients (deterministic, fp32) at 1e-4.
* scan: a JAX `scan_blocks=True` model's params (`blocks_stacked`, depth on
  the leading axis) go through the converter and the port's logits match
  at 1e-4; under scan `block_type` is ignored, as in JAX (ROADMAP F10), the
  drop-path rates are the loop's and remat recomputes everything.
* the layer-decay scales equal JAX `scale_by_layer_decay`'s on a loop tree
  and on a scan tree (per-layer vectors there).

Models are tiny (depth 2, width 128, 32-px images) but for
test_vit2, which runs at its own 160 px as the reference test runs it.
"""
import os
import sys

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models import create_model, vit
from vision_transformers_torch_xla_tpu_torch.models.layers import (
    Block,
    init_weights,
)
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)
from vision_transformers_torch_xla_tpu_torch.train.optim import (
    scale_by_layer_decay,
)

sys.path.insert(0, os.path.dirname(__file__))

CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
           num_classes=10)


def _images(n=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _jax_params(model, hw=32):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    variables = model.init(jax.random.key(0), jnp.asarray(_images(size=hw)))
    return jax.tree.map(np.asarray, nn.meta.unbox(variables)["params"])


def _port_grads(model, images, deterministic, seed=7):
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(seed)
    logits = model(torch.from_numpy(images), deterministic=deterministic,
                   generator=gen)
    (logits.square().mean() + logits[:, 0].sum()).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


STOCHASTIC = dict(drop_path_rate=0.5, proj_drop_rate=0.2, attn_drop_rate=0.2,
                  pos_drop_rate=0.1, patch_drop_rate=0.25, reg_tokens=1)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("kw", [
    STOCHASTIC,
    # the kernel route (no attention dropout, so the route holds), ResPost
    dict(STOCHASTIC, attn_drop_rate=0.0, use_pallas_attn=True,
         block_type="respost", init_values=1e-5),
    dict(STOCHASTIC, block_type="parallel_things", init_values=1e-5)],
    ids=["block", "respost_kernel_route", "parallel_things"])
def test_remat_gradients_equal_plain_with_stochastic_layers(kw, policy):
    images = _images(seed=1)
    plain = VisionTransformer(**CFG, **kw, dtype=torch.float32)
    init_weights(plain, torch.Generator().manual_seed(0))
    remat = VisionTransformer(**CFG, **kw, dtype=torch.float32, remat=True,
                              remat_policy=policy)
    remat.load_state_dict(plain.state_dict())
    want = _port_grads(plain, images, deterministic=False)
    got = _port_grads(remat, images, deterministic=False)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the masks were on: a deterministic pass gives other gradients
    quiet = _port_grads(plain, images, deterministic=True)
    assert not torch.equal(quiet["patch_embed.proj.weight"],
                           want["patch_embed.proj.weight"])


def test_a_naive_checkpoint_would_draw_other_masks(monkeypatch):
    # the replay is what keeps the recompute's masks: without it the
    # gradients differ (this test's witness that the one above can fail)
    from torch.utils import checkpoint as ckpt

    images = _images(seed=1)
    plain = VisionTransformer(**CFG, **STOCHASTIC, dtype=torch.float32)
    init_weights(plain, torch.Generator().manual_seed(0))
    remat = VisionTransformer(**CFG, **STOCHASTIC, dtype=torch.float32,
                              remat=True)
    remat.load_state_dict(plain.state_dict())
    want = _port_grads(plain, images, deterministic=False)

    def naive(block, x, deterministic, generator, policy="nothing"):
        return ckpt.checkpoint(block, x, deterministic, generator,
                               use_reentrant=False)

    monkeypatch.setattr(vit, "remat_block", naive)
    got = _port_grads(remat, images, deterministic=False)
    assert any(not torch.equal(got[k], want[k]) for k in want)


def test_dots_keeps_the_dense_products_and_nothing_recomputes_them():
    # 'dots' (JAX dots_with_no_batch_dims_saveable) keeps aten.mm / addmm:
    # its backward runs as many of them as the plain backward; 'nothing'
    # runs the forward's again
    from torch.utils._python_dispatch import TorchDispatchMode

    dense = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    class CountDense(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in dense
            return func(*args, **(kwargs or {}))

    images = torch.from_numpy(_images(seed=1))
    counts = {}
    for policy in (None, "nothing", "dots"):
        model = VisionTransformer(**CFG, dtype=torch.float32,
                                  remat=policy is not None,
                                  remat_policy=policy or "nothing")
        init_weights(model, torch.Generator().manual_seed(0))
        loss = model(images).square().mean()
        with CountDense() as mode:
            loss.backward()
        counts[policy] = mode.n
    assert counts["dots"] == counts[None] < counts["nothing"]


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gradients_match_jax_remat(policy):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )

    kw = dict(CFG, reg_tokens=2, init_values=1e-5, global_pool="map",
              class_token=False)
    jmodel = JaxViT(**kw, dtype=jnp.float32, remat=True, remat_policy=policy)
    params = _jax_params(jmodel)
    images = _images(seed=2)

    def loss(p):
        y = jmodel.apply({"params": p}, jnp.asarray(images), True)
        return jnp.mean(y ** 2) + jnp.sum(y[:, 0])

    want = flax_to_state_dict(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    model = VisionTransformer(**kw, dtype=torch.float32, remat=True,
                              remat_policy=policy)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    got = _port_grads(model, images, deterministic=True)
    assert set(got) == set(want)
    for k, g in got.items():
        scale = float(want[k].abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   atol=1e-4 * scale, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("block_type", ["block", "respost",
                                        "parallel_things"])
def test_scan_tree_through_the_converter_matches_jax(block_type):
    # a JAX scan model's stacked params unstack into blocks.{i}; under scan
    # JAX builds Block whatever block_type says (F10), and so does the port
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )

    kw = dict(CFG, block_type=block_type, init_values=1e-5,
              drop_path_rate=0.3, scan_blocks=True)
    jmodel = JaxViT(**kw, dtype=jnp.float32)
    params = _jax_params(jmodel)
    assert set(params) >= {"blocks_stacked"}
    images = _images(seed=3)
    want, inter = jmodel.apply({"params": params}, jnp.asarray(images),
                               mutable=["intermediates"])
    model = VisionTransformer(**kw, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    assert all(type(b) is Block for b in model.blocks)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the per-layer drop-path rates are the loop's
    rates = np.asarray(inter["intermediates"]["blocks_stacked"]["dp_rate"][0])
    np.testing.assert_allclose([b.drop_path_rate for b in model.blocks],
                               rates, rtol=1e-6)


def test_scan_ignores_block_type_and_remats_everything():
    # F10: the scan model of any block_type is the plain-block model
    scan = VisionTransformer(**CFG, block_type="parallel_scaling",
                             scan_blocks=True, remat=True,
                             remat_policy="dots", device=torch.device("meta"))
    loop = VisionTransformer(**CFG, device=torch.device("meta"))
    assert {k: v.shape for k, v in scan.state_dict().items()} == \
        {k: v.shape for k, v in loop.state_dict().items()}
    assert scan.remat_policy == "nothing"


@pytest.mark.parametrize("kw", [dict(scan_blocks=True),
                                dict(block_type="respost")])
def test_mlp_hidden_needs_loop_mode_and_plain_blocks(kw):
    with pytest.raises(ValueError, match="mlp_hidden"):
        VisionTransformer(**CFG, **kw, mlp_hidden=(96, 160),
                          device=torch.device("meta"))


@pytest.mark.parametrize("scan", [False, True])
def test_layer_decay_scales_match_jax(scan):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )
    from vision_transformers_torch_xla_tpu.train.optim import (
        scale_by_layer_decay as jax_layer_decay,
    )

    kw = dict(CFG, reg_tokens=2, global_pool="map", init_values=1e-5,
              scan_blocks=scan)
    params = _jax_params(JaxViT(**kw, dtype=jnp.float32))
    scales = jax_layer_decay(0.75, CFG["depth"]).init(params)
    # each scale broadcast over its leaf, then named as the port names it
    named = flax_to_state_dict(jax.tree.map(
        lambda s, p: np.broadcast_to(np.asarray(s, np.float32), p.shape),
        scales, params))
    model = VisionTransformer(**kw, device=torch.device("meta"))
    ours = scale_by_layer_decay(dict(model.named_parameters()), 0.75,
                                CFG["depth"])
    assert set(ours) == set(named)
    for k, v in named.items():
        np.testing.assert_allclose(v.numpy(), np.float32(ours[k]), rtol=1e-6,
                                   err_msg=k)
    assert ours["attn_pool.latent"] == 1.0 and ours["reg_token"] == \
        0.75 ** (CFG["depth"] + 1)


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.99])
@pytest.mark.parametrize("prefix", [dict(class_token=False),
                                    dict(class_token=True),
                                    dict(reg_tokens=4)])
def test_patch_dropout_keeps_the_prefix_and_a_gather(rate, prefix):
    model = VisionTransformer(**CFG, **prefix, patch_drop_rate=rate,
                              device=torch.device("meta"))
    npt, n, b = model.num_prefix_tokens, 16, 3
    x = torch.arange(b * (npt + n) * 4, dtype=torch.float32).reshape(
        b, npt + n, 4)
    gen = torch.Generator().manual_seed(5)
    y = model._patch_dropout(x, gen)
    keep = max(1, int(n * (1.0 - rate)))
    assert y.shape == (b, npt + keep, 4)
    assert torch.equal(y[:, :npt], x[:, :npt])
    for i in range(b):
        rows = {tuple(r) for r in x[i, npt:].tolist()}
        kept = [tuple(r) for r in y[i, npt:].tolist()]
        assert len(set(kept)) == keep and set(kept) <= rows
    again = model._patch_dropout(x, torch.Generator().manual_seed(5))
    assert torch.equal(again, y)


def test_patch_dropout_runs_in_train_mode_only():
    model = VisionTransformer(**dict(CFG, num_classes=0), global_pool="",
                              patch_drop_rate=0.5, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images())
    with torch.no_grad():
        assert model(x).shape == (2, 17, 128)
        train = model(x, deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    assert train.shape == (2, 1 + 8, 128)


def _reference_cases():
    import test_reference_execution as ref

    return ref.CASES, ref.SHRINK, ref._healthy_params


CASES, SHRINK, _healthy_params = _reference_cases()


@pytest.mark.parametrize("name,extra,hw", CASES, ids=[c[0] for c in CASES])
def test_reference_cases_match_jax(name, extra, hw):
    # tests/test_reference_execution.py's models and weights, the port in
    # place of the reference's torch model
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_transformers_torch_xla_tpu.models.factory import (
        create_model as jax_create,
    )

    kwargs = dict(SHRINK, **extra)
    if name == "test_vit2":
        kwargs = dict(extra, num_classes=10)
    mod = jax_create(name, dtype=jnp.float32, img_size=hw, **kwargs)
    x = np.random.default_rng(0).normal(
        size=(2, hw, hw, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: mod.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    params = _healthy_params(nn.meta.unbox(shapes["params"]))
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    model = create_model(name, img_size=hw, dtype=torch.float32, **kwargs)
    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4)
