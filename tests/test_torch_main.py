"""The port's trainer entry point on the CPU, and its data and config.

`main` runs with `device="cpu"` passed explicitly, a small model
(my_vit_mini at 32 px, 10 classes), 2 steps and 2 eval batches. The
synthetic stream and `config_from_args` are held equal to the JAX
package's; every option outside the slice must raise NotImplementedError
naming its ROADMAP item.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.core.config import (
    TrainConfig,
    config_from_args,
)
from vision_transformers_torch_xla_tpu_torch.data import loader, native
from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

# the keys of the JAX trainer's returned dict (launch/main.py:490-509:
# "epoch", train_one_epoch's train_<meter> for loss, grad_norm and lr, and
# evaluate's acc1, acc5, loss, count, then max_accuracy; ema_* with EMA eval)
JAX_MAIN_KEYS = {"epoch", "train_loss", "train_grad_norm", "train_lr",
                 "acc1", "acc5", "loss", "count", "max_accuracy"}

# the recipe's flags (scripts/train_vit_b_v4_64.sh, bench.py:110-139)
RECIPE = ["--model", "my_vit_b", "--act_layer", "gelu_tanh",
          "--batch_size", "128", "--data_set", "synthetic", "--lr", "4e-3",
          "--min_lr", "1e-6", "--warmup_epochs", "20", "--warmup_lr", "1e-6",
          "--weight_decay", "0.05", "--mixup", "0.8", "--cutmix", "1.0",
          "--smoothing", "0.1", "--drop_path", "0.1", "--model_ema", "true",
          "--model_ema_decay", "0.9999", "--opt", "adamw", "--epochs", "300",
          "--use_amp", "true", "--dist_eval", "true", "--opt_betas", "0.9",
          "0.999"]


def _cfg(**kw):
    base = dict(model="my_vit_mini", input_size=32, nb_classes=10,
                data_set="synthetic", batch_size=4, epochs=1,
                limit_steps_per_epoch=2, limit_eval_batches=2,
                warmup_epochs=0, lr=1e-3, device="cpu", log_freq=1,
                synthetic_train_size=64, synthetic_val_size=32)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("ema_eval", [False, True])
def test_main_trains_and_evaluates_on_the_cpu(ema_eval, capsys):
    stats = trainer.main(_cfg(model_ema=ema_eval, model_ema_eval=ema_eval))
    want = JAX_MAIN_KEYS | ({"ema_acc1", "ema_acc5", "ema_loss", "ema_count"}
                            if ema_eval else set())
    assert set(stats) == want
    assert stats["epoch"] == 0 and stats["count"] == 12.0  # 2 batches of 6
    assert all(np.isfinite(v) for v in stats.values())
    out = capsys.readouterr().out
    assert "epoch 0 [1/2] loss" in out and "epoch 0: top-1" in out


def test_main_trains_with_pallas_mlp_on_the_cpu(monkeypatch):
    """--pallas_mlp on --device cpu: every MLP of a tiny model (widths 128
    and 512) takes the fused route, its backward once per block and step
    and never in eval."""
    from vision_transformers_torch_xla_tpu_torch.ops import mlp_fused

    create, calls = trainer.create_model, []

    def tiny(name, **kw):
        return create(name, embed_dim=128, depth=2, num_heads=2, **kw)

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return fc2_bwd(*args)

    fc2_bwd = mlp_fused.fc2_bwd
    monkeypatch.setattr(trainer, "create_model", tiny)
    monkeypatch.setattr(mlp_fused, "fc2_bwd", counting)
    cfg = config_from_args([
        "--pallas_mlp", "on", "--device", "cpu", "--model", "my_vit_mini",
        "--act_layer", "gelu_tanh", "--input_size", "32", "--nb_classes",
        "10", "--data_set", "synthetic", "--batch_size", "4", "--epochs",
        "1", "--limit_steps_per_epoch", "2", "--limit_eval_batches", "2",
        "--warmup_epochs", "0", "--synthetic_train_size", "64",
        "--synthetic_val_size", "32"])
    stats = trainer.main(cfg)
    assert set(stats) == JAX_MAIN_KEYS
    assert all(np.isfinite(v) for v in stats.values())
    # 2 steps x 2 blocks, (B, S, D) = (4, 2 x 2 patches + 1, 128)
    assert calls == [(4, 5, 128)] * 4


@pytest.mark.parametrize("flag", ["off", "on"])
def test_main_routes_attention_by_pallas_attn_on_the_cpu(monkeypatch, flag):
    """--pallas_attn off trains on plain attention, as the JAX trainer does
    (--device cpu); --pallas_attn on takes the kernel route (the plain
    versions on the CPU): the fused projection + attention once per block
    in each of the 2 steps and 2 eval batches. The model (widths 128, 2
    heads of 64) fits the JAX layer's rule."""
    from vision_transformers_torch_xla_tpu_torch.models import layers

    create, calls = trainer.create_model, []

    def tiny(name, **kw):
        return create(name, embed_dim=128, depth=2, num_heads=2, **kw)

    def counting(x, *args, **kw):
        calls.append(tuple(x.shape))
        return qkv_proj(x, *args, **kw)

    qkv_proj = layers.qkv_proj_attention
    monkeypatch.setattr(trainer, "create_model", tiny)
    monkeypatch.setattr(layers, "qkv_proj_attention", counting)
    stats = trainer.main(_cfg(pallas_attn=flag))
    assert set(stats) == JAX_MAIN_KEYS
    assert all(np.isfinite(v) for v in stats.values())
    # (B, S, D): 4 train images, 6 eval images, 2 x 2 patches + 1 token
    want = [(4, 5, 128)] * 4 + [(6, 5, 128)] * 4
    assert calls == (want if flag == "on" else [])


def test_main_eval_only_returns_the_eval_dict():
    stats = trainer.main(_cfg(eval_only=True, limit_eval_batches=1))
    assert set(stats) == {"acc1", "acc5", "loss", "count"}


@pytest.mark.parametrize("use_native", [True, False])
def test_synthetic_stream_equals_the_jax_one(use_native, monkeypatch):
    """Both sources take the native stream when native/libvtx_io.so loads,
    else the numpy one."""
    from vision_transformers_torch_xla_tpu.data import loader as jl
    from vision_transformers_torch_xla_tpu.data import native as jn

    if use_native and not native.available():
        pytest.skip("native/libvtx_io.so does not load here")
    if not use_native:
        monkeypatch.setattr(jn, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    kw = dict(batch_size=3, image_size=16, num_classes=10, seed=4)
    want, got = iter(jl.SyntheticDataset(**kw)), \
        iter(loader.SyntheticDataset(**kw))
    for _ in range(2):
        (wx, wy), (gx, gy) = next(want), next(got)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_device_prefetch_keeps_order_and_moves_to_the_device():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32))
               for i in range(5)]
    got = list(loader.device_prefetch(
        batches, lambda b: loader.to_device(b, torch.device("cpu"))))
    assert [int(x[0, 0]) for x, _ in got] == list(range(5))
    assert all(isinstance(x, torch.Tensor) and y.dtype == torch.int32
               for x, y in got)


def test_config_from_args_matches_jax():
    from vision_transformers_torch_xla_tpu.core.config import (
        config_from_args as jax_config_from_args,
    )

    with pytest.warns(UserWarning, match="dist_eval"):
        got = config_from_args(RECIPE)
    with pytest.warns(UserWarning, match="dist_eval"):
        want = jax_config_from_args(RECIPE)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.opt_betas == (0.9, 0.999) and got.model_ema
    assert dataclasses.asdict(config_from_args([])) == \
        dataclasses.asdict(jax_config_from_args([]))


# the model axis, sp and device subsets are in the port (ROADMAP M6,
# tests/test_torch_tp.py); what the mesh cannot hold still raises, with
# JAX's error for a mesh larger than the devices
UNPORTED = [
    (dict(mesh_shape="data:2,model:2"), ValueError,
     r"mesh \{'data': 2, 'model': 2\} != 1 devices"),
    (dict(param_sharding="zero"), ValueError, "param_sharding"),
    # every optimizer name and --update_freq are in the port
    # (tests/test_torch_optim.py); an unknown name raises, and
    # accumulation does not lift AdaHessian's refusal on the kernel route
    (dict(opt="bogus"), ValueError, "unsupported optimizer"),
    (dict(update_freq=2, opt="adahessian", pallas_attn="on"),
     NotImplementedError, "double backward"),
]


@pytest.mark.parametrize("kw,error,match", UNPORTED,
                         ids=[next(iter(kw)) for kw, _, _ in UNPORTED])
def test_options_outside_the_slice_raise(kw, error, match):
    with pytest.raises(error, match=match):
        trainer.setup(_cfg(**kw))


@pytest.mark.parametrize("flag", ["--grad_checkpointing", "--scan_blocks"])
def test_the_m2_trainer_flags_train_on_the_cpu(flag):
    # each flag reaches the model as the JAX trainer passes it
    # (launch/main.py:202-203), then main() trains and evaluates
    cfg = config_from_args([
        flag, "true", "--device", "cpu", "--model", "my_vit_mini",
        "--input_size", "32", "--nb_classes", "10", "--batch_size", "4",
        "--epochs", "1", "--limit_steps_per_epoch", "1",
        "--limit_eval_batches", "1", "--warmup_epochs", "0",
        "--data_set", "synthetic", "--drop_path", "0.1"])
    ctx = trainer.setup(cfg)
    if flag == "--grad_checkpointing":
        assert ctx.model.remat and not ctx.model.scan_blocks
    else:
        assert ctx.model.scan_blocks and not ctx.model.remat
    stats = trainer.main(cfg)
    assert set(stats) == JAX_MAIN_KEYS
    assert all(np.isfinite(v) for v in stats.values())


M4 = [dict(output_dir="out"), dict(resume="ckpt"), dict(finetune="w.pth"),
      dict(enable_wandb=True), dict(enable_tensorboard=True),
      dict(profile_steps=2), dict(kd=True)]


@pytest.mark.parametrize("kw", M4, ids=[next(iter(kw)) for kw in M4])
def test_the_trainer_state_options_are_in_the_slice(kw):
    trainer.check_slice(_cfg(**kw))


def _jpeg_tree(root, classes=5, per_class=4, seed=0):
    """A class-per-directory tree of small seeded JPEGs (40 x 48 px)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        (root / f"c{c}").mkdir(parents=True)
        for i in range(per_class):
            arr = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / f"c{c}" / f"{i}.jpg")
    return str(root)


def test_main_trains_with_device_augment_on_a_folder_on_the_cpu(tmp_path,
                                                                capsys):
    """--device_augment --data_set folder: 2 steps with RandAugment and
    random erasing on the CPU, then 2 eval batches of the eval tree."""
    tree = _jpeg_tree(tmp_path / "tree")
    cfg = config_from_args([
        "--device", "cpu", "--model", "my_vit_mini", "--input_size", "32",
        "--nb_classes", "5", "--data_set", "folder", "--data_path", tree,
        "--eval_data_path", tree, "--device_augment", "true",
        "--reprob", "0.25", "--batch_size", "4", "--epochs", "1",
        "--limit_steps_per_epoch", "2", "--limit_eval_batches", "2",
        "--warmup_epochs", "0", "--log_freq", "1"])
    stats = trainer.main(cfg)
    assert set(stats) == JAX_MAIN_KEYS
    assert stats["count"] == 12.0 and all(np.isfinite(v)
                                          for v in stats.values())
    assert "epoch 0 [1/2] loss" in capsys.readouterr().out


@pytest.mark.parametrize("data_set", ["synthetic", "folder"])
def test_device_augment_evaluates_on_raw_pixels_as_jax_does(tmp_path,
                                                            data_set):
    """Under --device_augment every source sends raw [0, 1] pixels, the eval
    set's too (JAX data/loader.py:37-43), but only the train step
    normalizes (JAX train/steps.py:71-74): the JAX trainer evaluates on raw
    pixels. The port mirrors it: its eval batches equal the JAX source's
    bit for bit, and only the train step carries the ImageNet stats."""
    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )

    kw = dict(data_set=data_set, input_size=32, nb_classes=5, batch_size=4,
              device_augment=True, synthetic_val_size=12)
    if data_set == "folder":
        kw["data_path"] = _jpeg_tree(tmp_path / "tree")
    ctx = trainer.setup(_cfg(**kw))
    jds, _ = jax_build_dataset(JaxTrainConfig(**kw), is_train=False)
    (x, y), (wx, wy) = next(iter(ctx.val_ds)), next(iter(jds))
    np.testing.assert_array_equal(x, wx)
    np.testing.assert_array_equal(y, wy)
    assert x.shape == (6, 32, 32, 3)
    if data_set == "folder":    # JPEG pixels over 255, not normalized
        assert x.min() >= 0.0 and x.max() <= 1.0
        np.testing.assert_array_equal(x * 255.0, np.round(x * 255.0))
    aug = trainer.device_aug_config(ctx.cfg)
    assert (aug.mean, aug.std) == ((0.485, 0.456, 0.406),
                                   (0.229, 0.224, 0.225))
    assert loader.norm_constants(ctx.cfg) == ((0.0,) * 3, (1.0,) * 3)


def test_device_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert TrainConfig().device == ""
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.resolve_device("")
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.setup(_cfg(device=""))
    assert trainer.resolve_device("cpu") == torch.device("cpu")


# ---- --finetune and the KD teacher, against the JAX package --------------

DEPTH = 2


@pytest.fixture
def shallow(monkeypatch):
    """The trainer's models (student and teacher) cut to DEPTH blocks."""
    create = trainer.create_model
    monkeypatch.setattr(trainer, "create_model",
                        lambda name, **kw: create(name, depth=DEPTH, **kw))


def _jax_vit(classes, pool, seed):
    """A JAX my_vit_mini at 32 px, DEPTH blocks, fp32, and its params."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )

    model = jax_create("my_vit_mini", num_classes=classes, img_size=32,
                       depth=DEPTH, global_pool=pool, dtype=jnp.float32)
    params = jax.jit(lambda k: nn.meta.unbox(model.init(
        k, jnp.zeros((1, 32, 32, 3)), True))["params"])(jax.random.key(seed))
    return model, params


def _export(params, path, wrap=None):
    """JAX params -> the .pth that ckpt/torch_export.py writes; `wrap`
    (key, prefix) re-saves its state dict as {key: {prefix + name: ...}}."""
    from vision_transformers_torch_xla_tpu.ckpt.torch_export import (
        save_torch_checkpoint,
    )

    save_torch_checkpoint(str(path), {"params": params}, arch="vit")
    if wrap is not None:
        key, prefix = wrap
        sd = torch.load(str(path), weights_only=True)["model"]
        torch.save({key: {prefix + k: v for k, v in sd.items()}}, str(path))
    return str(path)


def _images(n=4, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


FINETUNE = {"same_head": (10, None, {}),
            "other_head": (7, None, {}),
            "module_prefix": (10, ("module", "module.backbone."),
                              dict(model_key="module",
                                   model_prefix="backbone."))}


@pytest.mark.parametrize("case", list(FINETUNE))
def test_finetune_from_a_jax_export(tmp_path, shallow, case):
    """--finetune grafts what JAX exports: every tensor equal to
    flax_to_state_dict of the JAX params but a head of another class
    count, which keeps its init; fp32 eval logits within 1e-4 of JAX's on
    the same weights."""
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )

    classes, wrap, flags = FINETUNE[case]
    _, params = _jax_vit(10, "avg", seed=0)
    path = _export(params, tmp_path / "w.pth", wrap)
    cfg = _cfg(finetune=path, nb_classes=classes, precision="fp32", **flags)
    ctx = trainer.setup(cfg)
    init = trainer.setup(_cfg(nb_classes=classes, precision="fp32"))
    want = flax_to_state_dict(params)
    for k, p in ctx.state.params.items():
        if k.startswith("head.") and classes != 10:
            assert torch.equal(p, init.state.params[k]), k
        else:
            assert torch.equal(p, want[k]), k
    # the EMA starts from the fine-tuned weights
    ctx = trainer.setup(dataclasses.replace(cfg, model_ema=True))
    assert all(torch.equal(e, ctx.state.params[k])
               for k, e in ctx.state.ema_params.items())

    jparams = dict(params)
    if classes != 10:  # JAX with the port's untouched head
        jparams["head"] = {
            "kernel": jnp.asarray(ctx.state.params["head.weight"].detach().T.numpy()),
            "bias": jnp.asarray(ctx.state.params["head.bias"].detach().numpy())}
    jmodel, _ = _jax_vit(classes, "avg", seed=0)
    images = _images()
    expect = np.asarray(jmodel.apply({"params": jparams},
                                     jnp.asarray(images), True))
    with torch.no_grad():
        got = ctx.model(torch.from_numpy(images), True).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def _kd_cfg(**kw):
    return _cfg(kd=True, teacher_model="my_vit_mini", precision="fp32",
                mixup=0.0, cutmix=0.0, drop_path=0.0,
                limit_steps_per_epoch=1, disable_eval=True, **kw)


def test_kd_first_step_loss_matches_jax(tmp_path, shallow):
    """The first KD step's loss, the student from --finetune and the
    teacher from --teacher_path (both JAX exports), against the JAX step
    with teacher_apply on the same weights and batch, fp32: 1e-5."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train.mixup import (
        MixupConfig as JaxMixup,
    )
    from vision_transformers_torch_xla_tpu.train.optim import (
        create_optimizer as jax_optimizer,
    )
    from vision_transformers_torch_xla_tpu.train.state import (
        create_train_state as jax_state,
    )
    from vision_transformers_torch_xla_tpu.train.steps import (
        StepConfig as JaxStep,
        make_train_step as jax_step,
    )

    student, sparams = _jax_vit(10, "avg", seed=0)
    # the teacher as the JAX trainer builds it: the model's default pool
    teacher, tparams = _jax_vit(10, "token", seed=1)
    cfg = _kd_cfg(finetune=_export(sparams, tmp_path / "s.pth"),
                  teacher_path=_export(tparams, tmp_path / "t.pth"))
    stats = trainer.main(cfg)

    images, labels = next(iter(loader.build_dataset(cfg, True)[0]))
    tx = jax_optimizer("adamw", cfg.lr, sparams)
    step_cfg = JaxStep(
        mixup=JaxMixup(mixup_alpha=0.0, cutmix_alpha=0.0,
                       label_smoothing=cfg.smoothing, num_classes=10),
        label_smoothing=cfg.smoothing, num_classes=10,
        kd_alpha=cfg.kd_alpha, kd_temperature=cfg.kd_temperature)
    step = jax.jit(jax_step(student.apply, tx, step_cfg, teacher.apply))
    _, metrics = step(jax_state(sparams, tx), jnp.asarray(images),
                      jnp.asarray(labels), jax.random.key(0), tparams)
    want = float(metrics["loss"])
    assert abs(stats["train_loss"] - want) <= 1e-5 * abs(want)
    # the teacher's term is there: the same step without it differs
    plain = jax.jit(jax_step(student.apply, tx, step_cfg))
    _, no_kd = plain(jax_state(sparams, tx), jnp.asarray(images),
                     jnp.asarray(labels), jax.random.key(0))
    assert abs(float(no_kd["loss"]) - want) > 1e-3


def test_kd_without_teacher_path_warns_and_trains(shallow, caplog):
    import logging

    with caplog.at_level(logging.WARNING):
        stats = trainer.main(_kd_cfg())
    assert "teacher is random" in caplog.text
    assert np.isfinite(stats["train_loss"])


def test_kd_teacher_runs_plain_attention(monkeypatch):
    """--kd with --pallas_attn on: the student's blocks take the kernel
    route (the plain versions on the CPU), the teacher's none, as in JAX
    (the teacher is built without use_pallas_attn)."""
    from vision_transformers_torch_xla_tpu_torch.models import layers

    create, calls = trainer.create_model, []

    def tiny(name, **kw):
        return create(name, embed_dim=128, depth=2, num_heads=2, **kw)

    def counting(x, *args, **kw):
        calls.append(tuple(x.shape))
        return qkv_proj(x, *args, **kw)

    qkv_proj = layers.qkv_proj_attention
    monkeypatch.setattr(trainer, "create_model", tiny)
    monkeypatch.setattr(layers, "qkv_proj_attention", counting)
    ctx = trainer.setup(_cfg(pallas_attn="on", kd=True,
                             teacher_model="my_vit_mini"))
    assert not ctx.teacher.training
    assert not any(p.requires_grad for p in ctx.teacher.parameters())
    stats = trainer.main(_cfg(pallas_attn="on", kd=True,
                              teacher_model="my_vit_mini"))
    assert set(stats) == JAX_MAIN_KEYS
    # the student alone: 2 blocks x 2 steps, then 2 blocks x 2 eval batches
    assert calls == [(4, 5, 128)] * 4 + [(6, 5, 128)] * 4


def test_update_freq_schedules_count_updates_as_jax():
    """ROADMAP F11: the trainers' steps_per_epoch counts micro-batches
    (JAX launch/main.py:188-189), the schedules are built on it, and the
    optimizer reads them at its own count, which MultiSteps advances once
    per update. Under --update_freq k the cosine is then 1/k through its
    length when training ends. Pinned here on the port's trainer (test_convnext,
    k 2, 2 epochs of 8 micro-steps: 8 updates, the last at lr_fn(7) of 16)
    and on JAX's optimizer (the same count and lr after 16 micro-steps)."""
    import jax.numpy as jnp
    import optax

    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn,
    )

    cfg = _cfg(model="test_convnext", update_freq=2, epochs=2,
               limit_steps_per_epoch=None, disable_eval=True,
               synthetic_train_size=32, lr=4e-3, min_lr=0.0)
    ctx = trainer.setup(cfg)
    assert ctx.steps_per_epoch == 8
    for epoch in range(2):
        trainer.train_one_epoch(ctx, epoch)
    inner = ctx.state.opt_state["inner"]
    assert ctx.state.step == 16 and inner["count"] == 8
    lr_fn = cosine_schedule_fn(cfg.lr, cfg.min_lr, cfg.epochs, 8)
    assert float(lr_fn(7)) > 0.4 * cfg.lr     # mid-cosine, not its end

    params = {"w": jnp.ones((2, 2))}
    tx = jo.create_optimizer("adamw", lr_fn, params, update_freq=2)
    state = tx.init(params)
    for _ in range(16):
        upd, state = tx.update({"w": jnp.ones((2, 2))}, state, params)
        params = optax.apply_updates(params, upd)
    assert int(state.inner_opt_state.count) == 8
    np.testing.assert_allclose(
        float(state.inner_opt_state.hyperparams["learning_rate"]),
        float(lr_fn(7)), rtol=1e-6)


@pytest.mark.parametrize("opt", ["lamb", "lookahead_adamw", "adahessian"])
def test_main_trains_a_convnext_with_the_opt_names(opt):
    cfg = _cfg(model="test_convnext", opt=opt, update_freq=2,
               layer_decay=0.8, model_ema=True, drop_path=0.1)
    ctx = trainer.setup(cfg)
    assert not hasattr(ctx.model, "use_pallas_attn")
    stats = trainer.main(cfg)
    assert set(stats) == JAX_MAIN_KEYS
    assert all(np.isfinite(v) for v in stats.values())
