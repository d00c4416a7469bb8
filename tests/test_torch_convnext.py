"""The port's ConvNeXt against the JAX package's, on the CPU, in fp32.

* Forward parity at 64 px: `test_convnext`, `test_convnext2`,
  `test_convnext3` and narrow configurations that cover every branch (v2
  GRN; the overlap, overlap_tiered and overlap_act stems, also at an odd
  input size, 63, where SAME pads (1, 1) and then (0, 1); rms and simple
  norms; head_norm_first and head_hidden_size; num_classes=0). The JAX
  params are made by `init` and then redrawn from a numpy seed, so the
  layer scales and GRN weights are not their zero or 1e-6 starts, and go
  across through the port's converter: logits within 1e-4 of the largest.
* The registry: all 31 names build on the meta device with
  tests/golden_params.json's counts; the factory's keywords.
* The converter: JAX's exporter where it maps, timm's names where it
  refuses, and every `*_ols` tree sent to ConvNeXt (JAX's detection calls
  it resnetv2); a .pth loads with strict=True.
* ConvNeXt layer decay: each parameter's scale equals JAX's, through the
  converter's name map.
* Three train steps of `test_convnext` under `update_freq` 2 and layer
  decay 0.8, with JAX's mixup draws and drop-path masks fed: loss, grad
  norm and lr each step and the first step's gradients to 1e-5 of their
  largest; params and EMA after the three micro-steps (one update and one
  half-accumulated) to 1e-5 absolute.
* AdaHessian: one step with JAX's Rademacher probes fed; its refusal on a
  kernel route.
* The fp32 forward of `convnext_tiny` against the committed golden
  (tools/make_torch_port_golden.py), within 1e-4 of the largest logit.
* The server and a KD teacher on a ConvNeXt name.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_train import _jax_draw, _normal
from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
    is_convnext_tree,
    load_checkpoint,
    save_checkpoint,
)
from vision_transformers_torch_xla_tpu_torch.core.seeded import (
    seeded_images,
    seeded_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models import (
    convnext,
    create_model,
    list_models,
)
from vision_transformers_torch_xla_tpu_torch.train import mixup
from vision_transformers_torch_xla_tpu_torch.train import optim as port_optim
from vision_transformers_torch_xla_tpu_torch.train import schedules
from vision_transformers_torch_xla_tpu_torch.train.state import (
    create_train_state,
)
from vision_transformers_torch_xla_tpu_torch.train.steps import (
    StepConfig,
    make_train_step,
)

DATA = os.path.join(os.path.dirname(__file__), "data")
NAMES = sorted(n for n in list_models() if "convnext" in n)
NARROW = dict(depths=(1, 1, 2, 1), dims=(16, 24, 32, 40))
# (id, model name, kwargs, input size, converter flags)
FORWARD = [
    ("test_convnext", "test_convnext", {}, 64, {}),
    ("test_convnext2", "test_convnext2", {}, 64, {}),
    ("test_convnext3", "test_convnext3", {}, 64, {}),
    ("v2_grn", "convnextv2_atto", dict(NARROW), 64, {}),
    ("overlap", "convnext_nano_ols", dict(NARROW), 64, {}),
    ("overlap_tiered", "convnext_atto_ols", dict(NARROW), 64, {}),
    ("overlap_act", "convnext_zepto_rms_ols", dict(NARROW), 64,
     dict(overlap_act=True)),
    ("overlap_odd", "convnext_atto_ols", dict(NARROW), 63, {}),
    ("overlap_act_odd", "convnext_zepto_rms_ols", dict(NARROW), 63,
     dict(overlap_act=True)),
    ("rms", "convnext_atto_rms", dict(NARROW), 64, {}),
    ("simple", "convnext_zepto_rms", dict(NARROW), 64, {}),
    ("head_norm_first", "convnext_tiny_hnf", dict(NARROW), 64,
     dict(head_norm_first=True)),
    ("head_hidden", "convnext_large_mlp",
     dict(NARROW, head_hidden_size=48), 64, {}),
    ("num_classes_0", "test_convnext2", dict(num_classes=0), 64, {}),
]


def _jax_model(name, **kw):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )

    return jax_create(name, dtype=jnp.float32, **kw)


def _jax_params(model, size, seed=1):
    """The model's params, each leaf drawn from default_rng(seed): N(0,
    0.1), plus 1 for 1-D leaves (scales, gammas, biases alike), so the
    layer scales and GRN weights are not their zero or 1e-6 starts. Only
    the shapes come from JAX (eval_shape: nothing is compiled)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    shapes = jax.eval_shape(lambda k: nn.meta.unbox(model.init(
        k, jnp.zeros((1, size, size, 3))))["params"], jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1
                                   + (len(a.shape) == 1)).astype(np.float32),
                        shapes)


def _jax_apply(model, params, x):
    import jax

    return np.asarray(jax.jit(lambda p, x: model.apply({"params": p}, x))(
        params, x))


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", FORWARD, ids=[c[0] for c in FORWARD])
def test_forward_matches_jax(case):
    _, name, kw, size, conv = case
    jm = _jax_model(name, **kw)
    params = _jax_params(jm, size)
    x = _normal((2, size, size, 3), 2)
    want = _jax_apply(jm, params, x)
    model = create_model(name, dtype=torch.float32, **kw)
    model.load_state_dict(flax_to_state_dict(params, **conv), strict=True)
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert got.shape[1] == kw.get("num_classes", 1000) or \
        kw.get("num_classes") == 0
    assert _rel_err(got, want) <= 1e-4


def test_overlap_stem_pads_as_same():
    """3 x 3 stride 2 on an even side pads (0, 1), on an odd one (1, 1):
    torch's padding=1 would be another function."""
    assert convnext.same_pads(64, 3, 2) == (0, 1)
    assert convnext.same_pads(63, 3, 2) == (1, 1)
    assert convnext.same_pads(32, 7, 1) == (3, 3)
    m = create_model("convnext_nano_ols", dtype=torch.float32, **NARROW)
    torch.manual_seed(0)
    conv = m.stem[0]
    for p in conv.parameters():
        torch.nn.init.normal_(p)
    x = torch.randn(1, 8, 8, 3)
    same = conv(x)
    sym = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight,
                                     conv.bias, 2, 1).permute(0, 2, 3, 1)
    assert same.shape == sym.shape
    assert (same - sym).abs().max() > 1e-2


def test_the_31_names_build_with_golden_counts():
    assert len(NAMES) == 31
    with open(os.path.join(os.path.dirname(__file__),
                           "golden_params.json")) as f:
        golden = json.load(f)
    assert set(NAMES) == {n for n in golden if "convnext" in n}
    for name in NAMES:
        img, count = golden[name]
        model = create_model(name, img_size=img, device="meta")
        assert sum(p.numel() for p in model.parameters()) == count, name


def test_factory_keywords_follow_jax():
    m = create_model("convnext_atto", init_values=0.5, global_pool="avg",
                     remat=True, device="meta")
    assert m.stages[0].blocks[0].layer_scale_init == 0.5
    for bad in ("scan_blocks", "act_layer"):
        with pytest.raises(TypeError):
            create_model("convnext_atto", device="meta", **{bad: True})
    rates = [b.drop_path_rate for s in create_model(
        "test_convnext", drop_path_rate=0.3, device="meta").stages
        for b in s.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 9))
    assert not hasattr(m, "use_pallas_attn") and not hasattr(m, "depth")


@pytest.mark.parametrize("name", ["test_convnext", "convnextv2_atto"])
def test_convert_matches_the_jax_exporter(name, tmp_path):
    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        export_convnext_state_dict,
    )

    params = _jax_params(_jax_model(name), 64, seed=3)
    want = export_convnext_state_dict({"params": params})
    got = flax_to_state_dict(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    path = str(tmp_path / "w.pth")
    save_checkpoint(path, want)
    create_model(name, device="meta").load_state_dict(
        load_checkpoint(path), strict=True, assign=True)


@pytest.mark.parametrize("name", ["convnext_atto_ols", "convnext_nano_ols",
                                  "convnext_zepto_rms_ols"])
def test_ols_trees_go_to_convnext(name):
    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        detect_flax_architecture,
    )

    params = _jax_params(_jax_model(name, **NARROW), 64)
    assert detect_flax_architecture(params) == "resnetv2"  # JAX's rule
    assert is_convnext_tree(params)
    sd = flax_to_state_dict(params, overlap_act=name.endswith("rms_ols"))
    model = create_model(name, device="meta", **NARROW)
    assert set(sd) == set(model.state_dict())


def test_convnext_layer_decay_matches_jax():
    import jax

    from vision_transformers_torch_xla_tpu.train import optim as jo

    params = _jax_params(_jax_model("test_convnext",
                                    head_hidden_size=16), 64)
    want_tree = jo.scale_by_layer_decay(0.8, 12).init(params)
    full = jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32),
                        want_tree, params)
    want = {k: float(v.flatten()[0])
            for k, v in flax_to_state_dict(full).items()}
    port = dict(create_model("test_convnext", head_hidden_size=16,
                             device="meta").named_parameters())
    got = port_optim.scale_by_layer_decay(port, 0.8, 12)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert port_optim.detect_layer_id_kind(port) == "convnext"
    ids = {port_optim.convnext_layer_id(k) for k in port}
    assert ids == {0, 1, 2, 3, 4, 12, 13}


# ---- the train step ---------------------------------------------------------

def _record_jax_drop_path(monkeypatch, masks):
    """JAX's drop_path, each mask it draws appended to `masks` (under jit
    too, through an ordered callback)."""
    import jax

    from vision_transformers_torch_xla_tpu.models import convnext as jc

    orig = jc.drop_path

    def recording(x, rate, deterministic, rng):
        if not (deterministic or rate == 0.0):
            keep = jax.random.bernoulli(rng, 1.0 - rate,
                                        (x.shape[0],) + (1,) * (x.ndim - 1))
            jax.debug.callback(lambda k: masks.append(np.asarray(k)), keep,
                               ordered=True)
        return orig(x, rate, deterministic, rng)

    monkeypatch.setattr(jc, "drop_path", recording)


def _feed_port_drop_path(monkeypatch, masks):
    """The port's drop_path, taking the next of `masks` for each draw."""
    orig = convnext.drop_path

    def fed(x, rate, deterministic, generator):
        if deterministic or rate == 0.0:
            return x
        return orig(x, rate, deterministic, generator,
                    keep=torch.from_numpy(masks.pop(0).copy()))

    monkeypatch.setattr(convnext, "drop_path", fed)


SCHED = dict(base_value=1e-3, final_value=1e-5, epochs=1, niter_per_ep=4,
             warmup_steps=1, start_warmup_value=1e-4)


def _steps(opt, n, drop_path, size, **opt_kw):
    """n steps of test_convnext (layer scale 1, 10 classes) in both
    packages at `size` px, JAX's mixup draws, drop-path masks and (for
    AdaHessian) Rademacher probes fed to the port; and the first step's
    JAX gradients, from jax.grad of its loss with the step's rngs."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train import steps as jsteps
    from vision_transformers_torch_xla_tpu.train.adahessian import (
        rademacher_like,
    )
    from vision_transformers_torch_xla_tpu.train.losses import (
        soft_target_cross_entropy,
    )
    from vision_transformers_torch_xla_tpu.train.mixup import (
        MixupConfig as JaxMixup,
        mixup_cutmix,
    )
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn as jax_schedule,
    )
    from vision_transformers_torch_xla_tpu.train.state import (
        create_train_state as jax_train_state,
    )

    kw = dict(num_classes=10, drop_path_rate=drop_path, layer_scale_init=1.0)
    jmodel = _jax_model("test_convnext", **kw)
    params = _jax_params(jmodel, size)
    second = port_optim.is_second_order(opt)
    jtx = jo.create_optimizer(opt, jax_schedule(**SCHED), params,
                              weight_decay=0.05, **opt_kw)
    jcfg = jsteps.StepConfig(mixup=JaxMixup(num_classes=10), num_classes=10,
                             ema_decay=0.9, lr_schedule=jax_schedule(**SCHED))
    jstate = jax_train_state(params, jtx, with_ema=True)

    model = create_model("test_convnext", dtype=torch.float32, **kw)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    pparams = dict(model.named_parameters())
    tx = port_optim.create_optimizer(
        opt, schedules.cosine_schedule_fn(**SCHED), pparams,
        weight_decay=0.05, ema_decay=0.9, **opt_kw)
    pcfg = StepConfig(mixup=mixup.MixupConfig(num_classes=10), num_classes=10,
                      ema_decay=0.9,
                      lr_schedule=schedules.cosine_schedule_fn(**SCHED))
    pstep = make_train_step(model, tx, pcfg, second_order=second)
    pstate = create_train_state(model, tx, with_ema=True)

    rng = jax.random.key(0)
    out = {"jax": [], "port": []}
    masks = []
    with pytest.MonkeyPatch.context() as mp:
        _record_jax_drop_path(mp, masks)
        _feed_port_drop_path(mp, masks)
        jstep = jax.jit(jsteps.make_train_step(jmodel.apply, jtx, jcfg,
                                               second_order=second))
        for s in range(n):
            images = _normal((4, size, size, 3), 100 + s)
            labels = np.random.default_rng(200 + s).integers(
                0, 10, 4).astype(np.int32)
            keys = jax.random.split(jax.random.fold_in(rng, s), 5)
            draw = _jax_draw(keys[0], size, size, jcfg.mixup)
            z = flax_to_state_dict(rademacher_like(keys[4], jstate.params)) \
                if second else None
            if s == 0:
                x, t = mixup_cutmix(keys[0], jnp.asarray(images),
                                    jnp.asarray(labels), jcfg.mixup)

                def loss_fn(p):
                    return soft_target_cross_entropy(jmodel.apply(
                        {"params": p}, x, False,
                        rngs={"dropout": keys[1], "droppath": keys[2]}), t)

                grads = jax.jit(jax.grad(loss_fn))(jstate.params)
                out["jax_grads"] = flax_to_state_dict(
                    jax.tree.map(np.asarray, grads))
                jax.effects_barrier()
                del masks[:]     # the step draws them again
            jstate, jm = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels), rng)
            jax.effects_barrier()
            n_masks = len(masks)
            pstate, pm = pstep(pstate, torch.from_numpy(images),
                               torch.from_numpy(labels), 0, mixup_draw=draw,
                               hessian_z=z)
            assert not masks and (n_masks > 0) == (drop_path > 0)
            if s == 0 and not second:
                out["port_grads"] = {k: p.grad.clone()
                                     for k, p in pstate.params.items()}
            out["jax"].append({k: float(v) for k, v in jm.items()})
            out["port"].append({k: float(v) for k, v in pm.items()})
    out.update(jstate=jstate, pstate=pstate, params=params)
    return out


def _assert_trees_close(ptree, jtree, atol):
    want = flax_to_state_dict(jtree)
    assert set(want) == set(ptree)
    for k, w in want.items():
        diff = np.abs(ptree[k].detach().numpy() - w.numpy()).max()
        assert diff <= atol, (k, diff)


@pytest.fixture(scope="module")
def three_steps():
    """3 micro-steps of AdamW under update_freq 2 and layer decay 0.8,
    drop_path 0.3 and mixup/cutmix, at 64 px."""
    return _steps("adamw", 3, 0.3, 64, update_freq=2, layer_decay=0.8)


def test_three_update_freq_steps_with_layer_decay_match_jax(three_steps):
    out = three_steps
    for s, (got, want) in enumerate(zip(out["port"], out["jax"])):
        assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"step {s} {k}")
    pstate, jstate = out["pstate"], out["jstate"]
    assert pstate.step == int(jstate.step) == 3
    assert pstate.opt_state["gradient_step"] == 1
    assert pstate.opt_state["mini_step"] == 1
    _assert_trees_close(pstate.params, jstate.params, 1e-5)
    _assert_trees_close(pstate.ema_params, jstate.ema_params, 1e-5)
    start = flax_to_state_dict(out["params"])
    assert any((pstate.params[k] != start[k]).any() for k in start)


def test_first_step_grads_match_jax(three_steps):
    """The first micro-step's gradients (drop_path 0.3, mixup) against
    jax.grad of the JAX step's loss with its rngs."""
    want, got = three_steps["jax_grads"], three_steps["port_grads"]
    assert set(got) == set(want)
    for k in want:
        assert _rel_err(got[k].numpy(), want[k].numpy()) <= 1e-5, k


def test_adahessian_step_matches_jax():
    """One AdaHessian step at 32 px: loss, grad norm and lr to 1e-5. The
    step divides each gradient by |D|, the Hessian-diagonal estimate,
    which the port takes by a double backward and JAX by a jvp: where |D|
    is under a tenth of the gradient the step passes 10·lr and carries the
    rounding of D's small value. Params whose JAX step is within 10·lr
    (all but a few in a thousand) match to 1e-5; all are finite."""
    out = _steps("adahessian", 1, 0.0, 32)
    (got,), (want,) = out["port"], out["jax"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    lr = want["lr"]
    jparams = flax_to_state_dict(out["jstate"].params)
    start = flax_to_state_dict(out["params"])
    n_wild = n = 0
    for k, w in jparams.items():
        p = out["pstate"].params[k].detach()
        assert torch.isfinite(p).all(), k
        tame = (w - start[k]).abs() <= 10 * lr
        assert (p - w).abs()[tame].max() <= 1e-5, k
        n_wild += int((~tame).sum())
        n += w.numel()
    assert 0 < n_wild <= 0.005 * n


def test_adahessian_raises_on_a_kernel_route():
    from vision_transformers_torch_xla_tpu_torch.models.vit import (
        VisionTransformer,
    )

    model = VisionTransformer(img_size=32, patch_size=8, embed_dim=128,
                              depth=1, num_heads=2, num_classes=10,
                              use_pallas_attn=True, device="meta")
    tx = port_optim.create_optimizer("adahessian", 1e-3,
                                     dict(model.named_parameters()))
    with pytest.raises(NotImplementedError, match="use_pallas_attn"):
        make_train_step(model, tx, StepConfig(), second_order=True)


# ---- the golden, the server, the KD teacher ---------------------------------

def test_convnext_tiny_matches_the_golden():
    with open(os.path.join(DATA, "torch_port_golden_convnext_tiny.json")) \
            as f:
        golden = json.load(f)
    img = golden["img_size"]
    model = create_model("convnext_tiny", dtype=torch.float32)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           seeded_state_dict(shapes, seed=0,
                                             gamma=1.0).items()})
    with torch.inference_mode():
        got = model(torch.from_numpy(seeded_images(2, img, seed=0))).numpy()
    want = np.asarray(golden["logits"], np.float32)
    assert _rel_err(got, want) <= 1e-4


def test_the_server_takes_a_convnext_name():
    from vision_transformers_torch_xla_tpu_torch.launch.serve import (
        InferenceEngine,
    )

    engine = InferenceEngine("test_convnext", image_size=64, num_classes=10,
                             device="cpu")
    with open(os.path.join(DATA, "serve_0.jpg"), "rb") as f:
        out = engine.predict(f.read(), topk=3)
    assert len(out["top"] if isinstance(out, dict) else out) == 3


def test_kd_takes_a_convnext_teacher():
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        TrainConfig,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    cfg = TrainConfig(model="test_convnext", teacher_model="test_convnext2",
                      kd=True, input_size=64, nb_classes=10,
                      data_set="synthetic", batch_size=4, epochs=1,
                      limit_steps_per_epoch=1, disable_eval=True,
                      warmup_epochs=0, device="cpu",
                      synthetic_train_size=16, synthetic_val_size=8)
    stats = trainer.main(cfg)
    assert np.isfinite(stats["train_loss"])
