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


UNPORTED = [
    (dict(output_dir="out"), "M4"), (dict(resume="ckpt"), "M4"),
    (dict(finetune="w.pth"), "M4"), (dict(enable_wandb=True), "M4"),
    (dict(enable_tensorboard=True), "M4"), (dict(profile_steps=2), "M4"),
    (dict(kd=True), "M4"), (dict(device_augment=True), "M5"),
    (dict(data_set="tfds"), "M5"), (dict(mesh_shape="data:2,model:2"), "M6"),
    (dict(param_sharding="fsdp"), "M6"), (dict(grad_checkpointing=True), "M2"),
    (dict(scan_blocks=True), "M2"), (dict(opt="lamb"), "M7"),
    (dict(update_freq=2), "M7"),
]


@pytest.mark.parametrize("kw,item", UNPORTED,
                         ids=[next(iter(kw)) for kw, _ in UNPORTED])
def test_options_outside_the_slice_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        trainer.setup(_cfg(**kw))


def test_data_sets_other_than_synthetic_raise():
    with pytest.raises(NotImplementedError, match="M5"):
        loader.build_dataset(_cfg(data_set="folder"), is_train=True)


def test_device_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert TrainConfig().device == ""
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.resolve_device("")
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.setup(_cfg(device=""))
    assert trainer.resolve_device("cpu") == torch.device("cpu")
