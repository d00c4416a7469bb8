"""The port's training pieces against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both. Where the JAX
code draws random numbers (mixup, drop_path), the test makes the same
`jax.random` calls and feeds the draws to the port: threefry and Philox
never agree bit for bit. The JAX ViT runs its Pallas attention (K1, K2) in
interpret mode; the port runs its autograd Function with the kernels' plain
versions.

Tolerances: the losses, schedules, masks and the AdamW update compute the
same fp32 expressions and agree to 1e-6 relative. The 3-step train check
is fp32 end to end: loss, grad norm and grads to 1e-5 relative to their
largest value (two attention implementations sum in different orders).
Params and EMA after 3 AdamW steps (lr 1e-3) to 1e-6 absolute. Adam
divides each grad by its own magnitude, so a grad near zero whose last
digits differ moves its param by up to ~lr. The key part of each qkv bias
has a zero gradient in exact arithmetic (softmax ignores a constant shift of
the keys): its computed gradient is rounding noise (~1e-13) in both, and
those H·D entries per block are held only to 2·lr. Of the others, at most 5
entries (grads near zero) may exceed 1e-6, and none 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models.layers import drop_path
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)
from vision_transformers_torch_xla_tpu_torch.train import losses, mixup
from vision_transformers_torch_xla_tpu_torch.train import optim as port_optim
from vision_transformers_torch_xla_tpu_torch.train import schedules
from vision_transformers_torch_xla_tpu_torch.train.fused import FusedAdamW
from vision_transformers_torch_xla_tpu_torch.train.state import (
    create_train_state,
)
from vision_transformers_torch_xla_tpu_torch.train.steps import (
    StepConfig,
    make_eval_step,
    make_train_step,
)

CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
           num_classes=10)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np(x):
    return np.asarray(x, np.float64) if not isinstance(x, torch.Tensor) \
        else x.detach().double().numpy()


def _rel_err(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- losses ---------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_jax(smoothing):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train import losses as jl

    logits = _normal((8, 10), 1, 3.0)
    teacher = _normal((8, 10), 2, 3.0)
    labels = np.random.default_rng(3).integers(0, 10, 8).astype(np.int32)
    soft = np.random.default_rng(4).dirichlet(np.ones(10), 8).astype(
        np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(teacher)
    yt = torch.from_numpy(labels)
    lj, tj, yj = jnp.asarray(logits), jnp.asarray(teacher), jnp.asarray(labels)
    ce = losses.cross_entropy(lt, yt, smoothing)
    np.testing.assert_allclose(ce.item(), float(jl.cross_entropy(
        lj, yj, smoothing)), rtol=1e-6)
    stce = losses.soft_target_cross_entropy(lt, torch.from_numpy(soft))
    np.testing.assert_allclose(stce.item(), float(
        jl.soft_target_cross_entropy(lj, jnp.asarray(soft))), rtol=1e-6)
    kd = losses.distillation_loss(lt, tt, ce, 0.5, 4.0)
    np.testing.assert_allclose(kd.item(), float(jl.distillation_loss(
        lj, tj, jl.cross_entropy(lj, yj, smoothing), 0.5, 4.0)), rtol=1e-6)
    got = losses.topk_correct(lt, yt)
    want = jl.topk_correct(lj, yj)
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}


def test_smoothed_one_hot_matches_jax():
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train import mixup as jm

    labels = np.arange(7, dtype=np.int32) % 5
    got = mixup.smoothed_one_hot(torch.from_numpy(labels), 5, 0.1)
    want = jm.smoothed_one_hot(jnp.asarray(labels), 5, 0.1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- mixup / cutmix with the JAX draws ------------------------------------

def _jax_draw(rng, h, w, cfg) -> mixup.MixupDraw:
    """The draws of JAX mixup_cutmix (mixup.py:66-78), made by the same
    jax.random calls."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train.mixup import _rand_bbox

    k_gate, k_switch, k_lam, k_box = jax.random.split(rng, 4)
    apply = bool(jax.random.bernoulli(k_gate, cfg.prob))
    if cfg.mixup_alpha > 0.0 and cfg.cutmix_alpha > 0.0:
        cut = bool(jax.random.bernoulli(k_switch, cfg.switch_prob))
    else:
        cut = cfg.cutmix_alpha > 0.0
    am, ac = max(cfg.mixup_alpha, 1e-8), max(cfg.cutmix_alpha, 1e-8)
    lam_mix = jax.random.beta(k_lam, am, am)
    lam_cut = jax.random.beta(k_lam, ac, ac)
    box = tuple(int(v) for v in _rand_bbox(k_box, h, w, lam_cut))
    lam = float(jnp.asarray(lam_cut if cut else lam_mix, jnp.float32))
    return mixup.MixupDraw(apply, cut, lam, box)


@pytest.mark.parametrize("kind,seed", [("mixup", 0), ("cutmix", 1),
                                       ("both", 2), ("both", 5),
                                       ("gate_off", 3)])
def test_mixup_cutmix_matches_jax_with_fed_draws(kind, seed):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train import mixup as jm

    kw = {"mixup": dict(cutmix_alpha=0.0), "cutmix": dict(mixup_alpha=0.0),
          "both": {}, "gate_off": dict(prob=0.0)}[kind]
    cfg = jm.MixupConfig(num_classes=10, **kw)
    pcfg = mixup.MixupConfig(num_classes=10, **kw)
    images = _normal((6, 16, 12, 3), seed)
    labels = np.random.default_rng(seed).integers(0, 10, 6).astype(np.int32)
    rng = jax.random.key(seed)
    want_x, want_t = jm.mixup_cutmix(rng, jnp.asarray(images),
                                     jnp.asarray(labels), cfg)
    draw = _jax_draw(rng, 16, 12, cfg)
    assert draw.apply == (kind != "gate_off")
    targets = mixup.smoothed_one_hot(torch.from_numpy(labels), 10, 0.1)
    got_x, got_t = mixup.apply_mixup(torch.from_numpy(images), targets, draw)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6,
                               atol=1e-7)
    assert pcfg.enabled


def test_sample_mixup_draws_follow_the_config():
    rng = np.random.default_rng(0)
    cfg = mixup.MixupConfig(num_classes=10)
    draws = [mixup.sample_mixup(rng, 32, 24, cfg) for _ in range(200)]
    assert all(d.apply for d in draws)
    n_cut = sum(d.cutmix for d in draws)
    assert 60 < n_cut < 140                     # switch_prob 0.5
    for d in draws:
        assert 0.0 <= d.lam <= 1.0
        y0, y1, x0, x1 = d.box
        assert 0 <= y0 <= y1 <= 32 and 0 <= x0 <= x1 <= 24
    off = mixup.MixupConfig(num_classes=10, prob=0.0)
    assert not mixup.sample_mixup(rng, 8, 8, off).apply
    assert not mixup.MixupConfig(mixup_alpha=0.0, cutmix_alpha=0.0).enabled


def test_drop_path_with_a_fed_mask_matches_jax():
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.layers import (
        drop_path as jax_drop_path,
    )

    x = _normal((8, 5, 4), 7)
    rng = jax.random.key(7)
    want = jax_drop_path(jnp.asarray(x), 0.3, False, rng)
    keep = np.asarray(jax.random.bernoulli(rng, p=0.7, shape=(8, 1, 1)))
    got = drop_path(torch.from_numpy(x), 0.3, False, None,
                    keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert 0 < keep.sum() < 8


# ---- schedules -------------------------------------------------------------

SCHEDULES = [dict(base_value=4e-3, final_value=1e-6, epochs=5,
                  niter_per_ep=7, warmup_epochs=2, start_warmup_value=1e-6),
             dict(base_value=0.05, final_value=0.2, epochs=3, niter_per_ep=4),
             dict(base_value=1e-3, final_value=0.0, epochs=2, niter_per_ep=5,
                  warmup_steps=3)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_cosine_schedules_match_jax(kw):
    from vision_transformers_torch_xla_tpu.train import schedules as js

    np.testing.assert_array_equal(schedules.cosine_scheduler(**kw),
                                  js.cosine_scheduler(**kw))
    fn, jfn = schedules.cosine_schedule_fn(**kw), js.cosine_schedule_fn(**kw)
    steps = range(kw["epochs"] * kw["niter_per_ep"] + 2)
    np.testing.assert_allclose([fn(i) for i in steps],
                               [float(jfn(i)) for i in steps], rtol=1e-6)


# ---- wd mask and layer decay over timm names -------------------------------

def _jax_tiny_vit(pallas: bool):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )

    model = JaxViT(**CFG, dtype=jnp.float32, use_pallas_attn=pallas)
    with pltpu.force_tpu_interpret_mode():
        variables = model.init(jax.random.key(0),
                               jnp.zeros((2, 32, 32, 3), jnp.float32))
    return model, jax.tree.map(np.asarray, nn.meta.unbox(variables)["params"])


def _by_timm_name(tree, params):
    """A tree of per-leaf scalars, keyed like `params`, -> {timm name:
    scalar} through the port's converter."""
    import jax

    full = jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32), tree,
                        params)
    out = {}
    for k, v in flax_to_state_dict(full).items():
        assert v.min() == v.max(), k
        out[k] = float(v.flatten()[0])
    return out


def test_wd_mask_and_layer_decay_match_jax():
    from vision_transformers_torch_xla_tpu.train import optim as jo

    _, params = _jax_tiny_vit(pallas=False)
    port_params = dict(VisionTransformer(**CFG, device="meta")
                       .named_parameters())
    want_mask = _by_timm_name(jo.wd_mask(params), params)
    got_mask = port_optim.wd_mask(port_params)
    assert set(got_mask) == set(want_mask)
    assert {k: float(v) for k, v in got_mask.items()} == want_mask
    assert got_mask["blocks.0.attn.qkv.weight"]
    assert not got_mask["pos_embed"] and not got_mask["head.bias"]
    want_scale = _by_timm_name(
        jo.scale_by_layer_decay(0.75, 2, kind="vit").init(params), params)
    got_scale = port_optim.scale_by_layer_decay(port_params, 0.75, 2)
    assert set(got_scale) == set(want_scale)
    for k, v in got_scale.items():
        np.testing.assert_allclose(v, want_scale[k], rtol=1e-6, err_msg=k)


def test_only_adamw_is_ported():
    params = {"w": torch.zeros(2, 2)}
    for opt in ("sgd", "lamb", "lookahead_adamw"):
        with pytest.raises(NotImplementedError, match="M7"):
            port_optim.create_optimizer(opt, 1e-3, params)
    with pytest.raises(NotImplementedError, match="M7"):
        port_optim.create_optimizer("adamw", 1e-3, params, update_freq=2)
    assert isinstance(port_optim.create_optimizer("fusedadamw", 1e-3, params),
                      FusedAdamW)
    assert port_optim.maybe_fused_optimizer("sgd", 1e-3, params) is None


# ---- the AdamW + EMA update -----------------------------------------------

def _flat_params(seed=0):
    return {"blocks.0.attn.qkv.weight": _normal((16, 8), seed),
            "blocks.0.attn.qkv.bias": _normal((16,), seed + 1),
            "pos_embed": _normal((1, 5, 8), seed + 2),
            "head.weight": _normal((4, 8), seed + 3)}


@pytest.mark.parametrize("ema,clip", [(None, None), (0.99, None),
                                      (0.99, 0.5)])
def test_fused_adamw_matches_jax(ema, clip):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train.fused import (
        make_fused_adamw,
    )
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn as jax_schedule,
    )

    kw = dict(base_value=1e-2, final_value=1e-4, epochs=1, niter_per_ep=4,
              warmup_steps=1, start_warmup_value=1e-3)
    flat = _flat_params()
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    jtx = make_fused_adamw(jax_schedule(**kw), weight_decay=0.05,
                           ema_decay=ema, clip_grad=clip,
                           mask=jo.wd_mask(jparams))
    jstate = jtx.init(jparams)
    jema = dict(jparams) if ema else None
    params = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    tx = FusedAdamW(schedules.cosine_schedule_fn(**kw), weight_decay=0.05,
                    ema_decay=ema, clip_grad=clip,
                    mask=port_optim.wd_mask(params))
    state = tx.init(params)
    pema = {k: v.clone() for k, v in params.items()} if ema else None
    for step in range(3):
        grads = {k: _normal(v.shape, 10 * step + i)
                 for i, (k, v) in enumerate(flat.items())}
        jparams, jstate, jema, jnorm = jtx.fused_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams,
            jema)
        norm = tx.fused_update({k: torch.from_numpy(g)
                                for k, g in grads.items()}, state, params,
                               pema)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    assert state["count"] == int(jstate.count) == 3
    for k in flat:
        for got, want in ((params, jparams), (state["mu"], jstate.mu),
                          (state["nu"], jstate.nu)) + \
                (((pema, jema),) if ema else ()):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# ---- three train steps and the eval step against the JAX trainer ----------

@pytest.fixture(scope="module")
def three_steps():
    """3 train steps of the tiny ViT in both packages at fp32: identical
    weights and batches, drop_path 0, the JAX mixup draws fed to the port,
    AdamW (wd 0.05, warmup + cosine lr) with EMA."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train import steps as jsteps
    from vision_transformers_torch_xla_tpu.train.losses import (
        soft_target_cross_entropy,
    )
    from vision_transformers_torch_xla_tpu.train.mixup import (
        MixupConfig as JaxMixupConfig,
        mixup_cutmix,
    )
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn as jax_schedule,
    )
    from vision_transformers_torch_xla_tpu.train.state import (
        create_train_state as jax_train_state,
    )

    jmodel, params = _jax_tiny_vit(pallas=True)
    sched = dict(base_value=1e-3, final_value=1e-5, epochs=1, niter_per_ep=3,
                 warmup_steps=1, start_warmup_value=1e-4)
    jtx = jo.maybe_fused_optimizer("adamw", jax_schedule(**sched), params,
                                   weight_decay=0.05, ema_decay=0.9)
    jcfg = jsteps.StepConfig(mixup=JaxMixupConfig(num_classes=10),
                             num_classes=10, ema_decay=0.9,
                             lr_schedule=jax_schedule(**sched))
    # eager: the Pallas calls' custom partitioning does not lower under jit
    # in interpret mode
    jstep = jsteps.make_train_step(jmodel.apply, jtx, jcfg)
    jstate = jax_train_state(params, jtx, with_ema=True)

    model = VisionTransformer(**CFG, dtype=torch.float32,
                              use_pallas_attn=True)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    pparams = dict(model.named_parameters())
    tx = port_optim.maybe_fused_optimizer(
        "adamw", schedules.cosine_schedule_fn(**sched), pparams,
        weight_decay=0.05, ema_decay=0.9)
    pcfg = StepConfig(mixup=mixup.MixupConfig(num_classes=10), num_classes=10,
                      ema_decay=0.9,
                      lr_schedule=schedules.cosine_schedule_fn(**sched))
    pstep = make_train_step(model, tx, pcfg)
    pstate = create_train_state(model, tx, with_ema=True)

    rng = jax.random.key(0)
    out = {"jax": [], "port": []}
    for s in range(3):
        images = _normal((4, 32, 32, 3), 100 + s)
        labels = np.random.default_rng(200 + s).integers(0, 10, 4).astype(
            np.int32)
        mix_rng = jax.random.split(jax.random.fold_in(rng, s), 5)[0]
        draw = _jax_draw(mix_rng, 32, 32, jcfg.mixup)
        if s == 0:
            x, t = mixup_cutmix(mix_rng, jnp.asarray(images),
                                jnp.asarray(labels), jcfg.mixup)

            def loss_fn(p):
                return soft_target_cross_entropy(
                    jmodel.apply({"params": p}, x, True), t)

            with pltpu.force_tpu_interpret_mode():
                out["jax_grads"] = flax_to_state_dict(jax.tree.map(
                    np.asarray, jax.grad(loss_fn)(jstate.params)))
        with pltpu.force_tpu_interpret_mode():
            jstate, jm = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(images),
                           torch.from_numpy(labels), 0, mixup_draw=draw)
        if s == 0:
            out["port_grads"] = {k: p.grad.clone()
                                 for k, p in pstate.params.items()}
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
    out.update(jmodel=jmodel, jstate=jstate, model=model, pstate=pstate)
    return out


def test_three_train_steps_loss_and_grad_norm_match_jax(three_steps):
    for s, (got, want) in enumerate(zip(three_steps["port"],
                                        three_steps["jax"])):
        assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"step {s} {k}")


def test_first_step_grads_match_jax_key_for_key(three_steps):
    want, got = three_steps["jax_grads"], three_steps["port_grads"]
    assert set(got) == set(want)
    for k in want:
        assert _rel_err(got[k], want[k]) <= 1e-5, k


def test_params_and_ema_after_three_steps_match_jax(three_steps):
    jstate, pstate = three_steps["jstate"], three_steps["pstate"]
    lr = 1e-3
    assert pstate.step == int(jstate.step) == 3
    for which, jtree, ptree in (("params", jstate.params, pstate.params),
                                ("ema", jstate.ema_params,
                                 pstate.ema_params)):
        want = flax_to_state_dict(jtree)
        assert set(want) == set(ptree)
        n_far = 0
        for k, w in want.items():
            diff = np.abs(ptree[k].detach().numpy() - w.numpy())
            if k.endswith("attn.qkv.bias"):
                hd = diff.size // 3
                assert diff[hd:2 * hd].max() <= 2 * lr, (which, k)
                diff = np.concatenate([diff[:hd], diff[2 * hd:]])
            assert diff.max() <= 1e-4, (which, k)
            n_far += int((diff > 1e-6).sum())
        assert n_far <= 5, (which, n_far)


@pytest.mark.parametrize("use_ema", [False, True])
def test_eval_step_matches_jax(three_steps, use_ema):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.train.steps import (
        make_eval_step as jax_eval_step,
    )

    jstate, pstate = three_steps["jstate"], three_steps["pstate"]
    images = _normal((6, 32, 32, 3), 300)
    labels = np.random.default_rng(301).integers(0, 10, 6).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_eval_step(three_steps["jmodel"].apply)(
            jstate.ema_params if use_ema else jstate.params,
            jnp.asarray(images), jnp.asarray(labels))
    got = make_eval_step(three_steps["model"])(
        pstate.ema_params if use_ema else pstate.params,
        torch.from_numpy(images), torch.from_numpy(labels))
    assert set(got) == set(want) == {"top1", "top5", "count", "loss_sum"}
    for k in ("top1", "top5", "count"):
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]),
                               rtol=1e-5)


def test_train_step_draws_its_own_mixup_and_reports_device_scalars():
    """The step samples its own mixup and drop_path; with an optimizer that
    carries no EMA, StepConfig.ema_decay blends the EMA after the update
    (the JAX step's non-fused path, steps.py:126-129)."""
    from vision_transformers_torch_xla_tpu_torch.models.layers import (
        init_weights,
    )

    model = VisionTransformer(**CFG, dtype=torch.float32, drop_path_rate=0.1)
    init_weights(model, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    tx = port_optim.create_optimizer("adamw", 1e-3, params, clip_grad=1.0)
    state = create_train_state(model, tx, with_ema=True)
    before = {k: p.detach().clone() for k, p in params.items()}
    step = make_train_step(model, tx, dataclasses.replace(
        StepConfig(), mixup=mixup.MixupConfig(num_classes=10),
        num_classes=10, ema_decay=0.5))
    images = torch.from_numpy(_normal((4, 32, 32, 3), 9))
    labels = torch.arange(4)
    state, m = step(state, images, labels, 0)
    assert set(m) == {"loss", "grad_norm"}
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0
               for v in m.values())
    assert np.isfinite(m["loss"].item()) and state.step == 1
    for k, p in params.items():
        torch.testing.assert_close(state.ema_params[k],
                                   0.5 * before[k] + 0.5 * p.detach())
    with pytest.raises(NotImplementedError, match="M7"):
        make_train_step(model, tx, StepConfig(), second_order=True)
