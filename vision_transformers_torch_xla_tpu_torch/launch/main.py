"""Training CLI: the composition root.

Counterpart of vision_transformers_torch_xla_tpu/launch/main.py (`setup`,
`train_one_epoch`, `evaluate`, `main`; :162-521) on one device: the same
flags (core/config.py), the same prints and the same returned dicts. As
in the JAX trainer, `--pallas_attn on`, or `auto` (the default) on the
card, builds the model with `use_pallas_attn`, whatever the compute dtype
(`pallas_attn_switch`): the train step then runs the attention kernels
forward and backward (ops/flash_attention.py, ops/flash_blocked.py), in
bf16, fp16 or fp32, and `--pallas_attn off` and `auto` on the CPU run
plain attention. Host metrics are read only at log_freq.

    python -m vision_transformers_torch_xla_tpu_torch.launch.main \
        --model my_vit_b --act_layer gelu_tanh --data_set synthetic \
        --batch_size 128 --epochs 1 --limit_steps_per_epoch 3 \
        --limit_eval_batches 2

A model of more than 1024 tokens (`--model vit_base_patch14_dinov2
--input_size 518 --global_pool token`: 1,370) trains on the kernel route
with the blocked attention kernels (ops/flash_blocked.py) forward and
backward.
`--pallas_mlp on` routes the tanh-GELU MLPs whose widths are multiples of
128 through the fused MLP backward (ops/mlp_fused.py, one fc2-backward
kernel launch per block and step); the default is off, as in the JAX
trainer.

`--device` '' (the default) means cuda and raises when there is no card;
the CPU runs only with `--device cpu`. Options outside this slice raise
NotImplementedError naming their ROADMAP item: checkpoints, resume,
loggers, profiling and KD (M4; the JAX trainer's hang watchdog waits for
it too), device augmentation and other data sets (M5), the mesh (M6),
gradient checkpointing and scanned blocks (M2).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.core.config import (
    TrainConfig,
    config_from_args,
)
from vision_transformers_torch_xla_tpu_torch.core.dtypes import get_policy
from vision_transformers_torch_xla_tpu_torch.data.loader import (
    build_dataset,
    device_prefetch,
    to_device,
)
from vision_transformers_torch_xla_tpu_torch.models import create_model
from vision_transformers_torch_xla_tpu_torch.models.layers import init_weights
from vision_transformers_torch_xla_tpu_torch.obs.metrics import MetricLogger
from vision_transformers_torch_xla_tpu_torch.train.mixup import MixupConfig
from vision_transformers_torch_xla_tpu_torch.train.optim import (
    create_optimizer,
)
from vision_transformers_torch_xla_tpu_torch.train.schedules import (
    cosine_schedule_fn,
)
from vision_transformers_torch_xla_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from vision_transformers_torch_xla_tpu_torch.train.steps import (
    StepConfig,
    make_eval_step,
    make_train_step,
)


@dataclasses.dataclass
class TrainerContext:
    cfg: TrainConfig
    device: torch.device
    model: nn.Module
    state: TrainState
    train_step: Callable
    eval_step: Callable
    train_ds: Any
    val_ds: Any
    steps_per_epoch: int
    start_epoch: int = 0
    eval_batches: Optional[int] = None


def resolve_device(device: str) -> torch.device:
    """'' -> cuda; cuda raises without a card (pass --device cpu)."""
    dev = torch.device(device or "cuda")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {device!r}: the port trains on cuda or "
                         f"cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device or 'cuda'}: CUDA is not "
                           f"available; pass --device cpu to train on the CPU")
    return dev


def check_slice(cfg: TrainConfig) -> None:
    """Raise, naming the ROADMAP item, on every option this slice lacks."""
    unported = [
        (cfg.output_dir, "--output_dir (checkpoints and the jsonl log)", "M4"),
        (cfg.resume, "--resume", "M4"),
        (cfg.finetune, "--finetune", "M4"),
        (cfg.enable_wandb, "--enable_wandb", "M4"),
        (cfg.enable_tensorboard, "--enable_tensorboard", "M4"),
        (cfg.profile_steps > 0, "--profile_steps", "M4"),
        (cfg.kd, "--kd (the teacher wiring)", "M4"),
        (cfg.device_augment, "--device_augment", "M5"),
        (cfg.data_set != "synthetic", f"--data_set {cfg.data_set}", "M5"),
        (cfg.mesh_shape != "data" or cfg.param_sharding != "replicated",
         "a device mesh (--mesh_shape, --param_sharding)", "M6"),
        (cfg.grad_checkpointing, "--grad_checkpointing", "M2"),
        (cfg.scan_blocks, "--scan_blocks", "M2"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not in the port yet (ROADMAP {item})")


def pallas_attn_switch(pallas_attn: str, device: torch.device) -> bool:
    """`use_pallas_attn` for `--pallas_attn`, as the JAX trainer sets it
    (launch/main.py:207-211): `on`, or `auto` off the CPU, for every
    compute dtype: the port's kernels take bf16, fp16 and fp32 on the card,
    as the JAX kernels take any float dtype."""
    return pallas_attn == "on" or (pallas_attn == "auto"
                                   and device.type != "cpu")


def setup(cfg: TrainConfig) -> TrainerContext:
    check_slice(cfg)
    device = resolve_device(cfg.device)
    policy = get_policy(cfg.precision)
    want_pallas = pallas_attn_switch(cfg.pallas_attn, device)

    train_ds, info = build_dataset(cfg, is_train=True)
    val_ds, val_info = build_dataset(cfg, is_train=False) \
        if not cfg.disable_eval else (None, None)
    steps_per_epoch = max(info.num_examples // cfg.batch_size, 1)
    eval_batches = None
    if val_info is not None:
        eval_batches = max(val_info.num_examples // cfg.eval_batch_size(), 1)

    model = create_model(
        cfg.model, num_classes=cfg.nb_classes, img_size=cfg.input_size,
        drop_path_rate=cfg.drop_path, global_pool=cfg.global_pool,
        act_layer=cfg.act_layer or None,
        init_values=cfg.layer_scale_init_value or None,
        use_pallas_attn=want_pallas, use_pallas_mlp=cfg.pallas_mlp == "on",
        dtype=policy.compute_dtype, param_dtype=policy.param_dtype,
        device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(cfg.seed))

    lr_fn = cosine_schedule_fn(cfg.lr, cfg.min_lr, cfg.epochs,
                               steps_per_epoch,
                               warmup_epochs=cfg.warmup_epochs,
                               start_warmup_value=cfg.warmup_lr,
                               warmup_steps=cfg.warmup_steps)
    wd_fn = None
    if cfg.weight_decay_end is not None and \
            cfg.weight_decay_end != cfg.weight_decay:
        wd_fn = cosine_schedule_fn(cfg.weight_decay, cfg.weight_decay_end,
                                   cfg.epochs, steps_per_epoch)
    params = dict(model.named_parameters())
    tx = create_optimizer(
        cfg.opt, lr_fn, params, weight_decay=cfg.weight_decay,
        weight_decay_schedule=wd_fn, opt_eps=cfg.opt_eps,
        opt_betas=cfg.opt_betas, clip_grad=cfg.clip_grad, layer_decay=cfg.layer_decay,
        model_depth=len(model.blocks), update_freq=cfg.update_freq,
        ema_decay=cfg.model_ema_decay if cfg.model_ema else None)
    state = create_train_state(model, tx, with_ema=cfg.model_ema)

    mix = MixupConfig(
        mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix, prob=cfg.mixup_prob,
        switch_prob=cfg.mixup_switch_prob, label_smoothing=cfg.smoothing,
        num_classes=cfg.nb_classes)
    step_cfg = StepConfig(
        mixup=mix, label_smoothing=cfg.smoothing, num_classes=cfg.nb_classes,
        ema_decay=cfg.model_ema_decay if cfg.model_ema else None,
        kd_alpha=cfg.kd_alpha, kd_temperature=cfg.kd_temperature,
        lr_schedule=lr_fn)
    return TrainerContext(
        cfg=cfg, device=device, model=model, state=state,
        train_step=make_train_step(model, tx, step_cfg),
        eval_step=make_eval_step(model), train_ds=train_ds, val_ds=val_ds,
        steps_per_epoch=steps_per_epoch, start_epoch=cfg.start_epoch,
        eval_batches=eval_batches)


def train_one_epoch(ctx: TrainerContext, epoch: int,
                    max_steps: Optional[int] = None) -> dict:
    """Host loop for one epoch."""
    cfg = ctx.cfg
    logger = MetricLogger()
    n_steps = min(ctx.steps_per_epoch, max_steps or ctx.steps_per_epoch)
    t0 = time.time()
    batches = device_prefetch(ctx.train_ds,
                              lambda b: to_device(b, ctx.device))
    for i in range(n_steps):
        try:
            images, labels = next(batches)
        except StopIteration:
            break
        ctx.state, metrics = ctx.train_step(ctx.state, images, labels,
                                            cfg.seed)
        if i % cfg.log_freq == 0 or i == n_steps - 1:
            host = {k: float(v) for k, v in metrics.items()}
            logger.update(**host)
            ips = cfg.batch_size * (i + 1) / (time.time() - t0)
            print(f"epoch {epoch} [{i}/{n_steps}] "
                  f"loss {host['loss']:.4f} lr {host.get('lr', 0):.2e} "
                  f"grad_norm {host.get('grad_norm', 0):.2f} "
                  f"({ips:.0f} img/s)", flush=True)
    return {f"train_{k}": m.global_avg for k, m in logger.meters.items()}


def evaluate(ctx: TrainerContext, use_ema: bool = False,
             max_batches: Optional[int] = None) -> dict:
    """Eval pass: top-1/top-5/loss summed on the device, read once at the
    end."""
    params = ctx.state.ema_params if use_ema else ctx.state.params
    if max_batches is None:
        max_batches = ctx.eval_batches
    keys = ("top1", "top5", "count", "loss_sum")
    totals = {k: torch.zeros((), dtype=torch.float32, device=ctx.device)
              for k in keys}
    batches = device_prefetch(ctx.val_ds, lambda b: to_device(b, ctx.device))
    for bi, (images, labels) in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        m = ctx.eval_step(params, images, labels)
        for k in keys:
            totals[k] += m[k]
    totals = {k: float(v) for k, v in totals.items()}
    n = max(totals["count"], 1.0)
    prefix = "ema_" if use_ema else ""
    return {f"{prefix}acc1": 100.0 * totals["top1"] / n,
            f"{prefix}acc5": 100.0 * totals["top5"] / n,
            f"{prefix}loss": totals["loss_sum"] / n,
            f"{prefix}count": n}


def main(cfg: TrainConfig, max_steps_per_epoch: Optional[int] = None,
         max_eval_batches: Optional[int] = None) -> dict:
    if max_steps_per_epoch is None and cfg.limit_steps_per_epoch:
        max_steps_per_epoch = cfg.limit_steps_per_epoch
    if max_eval_batches is None and cfg.limit_eval_batches:
        max_eval_batches = cfg.limit_eval_batches
    print(f"config: {cfg}", flush=True)
    ctx = setup(cfg)
    print(f"devices: 1 (1 processes): {ctx.device}", flush=True)

    if cfg.eval_only:
        stats = evaluate(ctx, max_batches=max_eval_batches)
        print(f"eval: top-1 {stats['acc1']:.2f}% top-5 {stats['acc5']:.2f}%")
        return stats

    max_accuracy = 0.0
    last_stats: dict = {}
    for epoch in range(ctx.start_epoch, cfg.epochs):
        train_stats = train_one_epoch(ctx, epoch, max_steps_per_epoch)
        stats = {"epoch": epoch, **train_stats}
        if ctx.val_ds is not None:
            eval_stats = evaluate(ctx, max_batches=max_eval_batches)
            if cfg.model_ema and cfg.model_ema_eval:
                eval_stats.update(evaluate(ctx, use_ema=True,
                                           max_batches=max_eval_batches))
            max_accuracy = max(max_accuracy, eval_stats["acc1"])
            stats.update(eval_stats)
            stats["max_accuracy"] = max_accuracy
            print(f"epoch {epoch}: top-1 {eval_stats['acc1']:.2f}% "
                  f"(best {max_accuracy:.2f}%)", flush=True)
        last_stats = stats
    return last_stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(config_from_args())
