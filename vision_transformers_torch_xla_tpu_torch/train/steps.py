"""Train / eval steps.

Counterpart of vision_transformers_torch_xla_tpu/train/steps.py. One
train step: per-step generators (core/rng.py), with `device_aug` the
on-device crop, flip, RandAugment, normalization and erasing of the raw
[0, 1] batch (data/device_aug.py), mixup/cutmix or smoothed targets, the
forward with stochastic layers on, the soft-target loss (+ KD), the
backward, then the fused AdamW + EMA update. On the card the
attention forward and backward are the port's kernels
(ops/flash_attention.py). Metrics come back as device scalars; the caller
reads them only at log_freq (steps.py:11-13).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.core.rng import step_rngs
from vision_transformers_torch_xla_tpu_torch.data.device_aug import (
    AugDraw,
    DeviceAugConfig,
    apply_augment,
    sample_augment,
)
from vision_transformers_torch_xla_tpu_torch.train.losses import (
    cross_entropy,
    distillation_loss,
    soft_target_cross_entropy,
    topk_correct,
)
from vision_transformers_torch_xla_tpu_torch.train.mixup import (
    MixupConfig,
    MixupDraw,
    apply_mixup,
    mixup_cutmix,
    smoothed_one_hot,
)
from vision_transformers_torch_xla_tpu_torch.train.state import (
    TrainState,
    ema_update,
)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    mixup: MixupConfig = MixupConfig()
    label_smoothing: float = 0.1
    num_classes: int = 1000
    ema_decay: Optional[float] = None       # None disables EMA
    kd_alpha: float = 0.5                   # used when a teacher is given
    kd_temperature: float = 4.0
    lr_schedule: Optional[Callable] = None  # step -> lr, for metrics only
    device_aug: Optional[DeviceAugConfig] = None  # on-device augmentation;
    # images then arrive raw in [0, 1]


def make_train_step(model: nn.Module, tx, cfg: StepConfig,
                    teacher: Optional[nn.Module] = None,
                    second_order: bool = False) -> Callable:
    """Returns train_step(state, images, labels, seed, mixup_draw=None,
    aug_draw=None).

    images (B, H, W, 3) and int labels on the model's device. `seed` and
    the host step count give the step's random streams; `mixup_draw` and
    `aug_draw` replace the sampled mixup and augmentation draws (tests feed
    the JAX draws). With `cfg.device_aug` the batch is augmented before
    mixup, as in JAX (steps.py:71-77). With `teacher`, the KD loss mixes
    in its logits (launch/main.py::build_teacher builds the teacher from
    --teacher_model and --teacher_path)."""
    if second_order:
        raise NotImplementedError(
            "second-order optimizers (adahessian) are not in the port yet "
            "(ROADMAP M7)")

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor, seed: int,
                   mixup_draw: Optional[MixupDraw] = None,
                   aug_draw: Optional[AugDraw] = None):
        rngs = step_rngs(seed, state.step, images.device)
        if cfg.device_aug is not None:
            if aug_draw is None:
                aug_draw = sample_augment(rngs.aug, images.shape[0],
                                          cfg.device_aug)
            images = apply_augment(images, aug_draw, cfg.device_aug,
                                   rngs.aug_noise)
        if mixup_draw is not None:
            images, targets = apply_mixup(
                images, smoothed_one_hot(labels, cfg.mixup.num_classes,
                                         cfg.mixup.label_smoothing),
                mixup_draw)
        elif cfg.mixup.enabled:
            images, targets = mixup_cutmix(rngs.mixup, images, labels,
                                           cfg.mixup)
        else:
            targets = smoothed_one_hot(labels, cfg.num_classes,
                                       cfg.label_smoothing)
        for p in state.params.values():
            p.grad = None
        logits = model(images, deterministic=False, generator=rngs.model)
        loss = soft_target_cross_entropy(logits, targets)
        if teacher is not None:
            with torch.no_grad():
                t_logits = teacher(images, deterministic=True)
            loss = distillation_loss(logits, t_logits, loss, cfg.kd_alpha,
                                     cfg.kd_temperature)
        loss.backward()
        grads = {k: p.grad for k, p in state.params.items()}
        grad_norm = tx.fused_update(grads, state.opt_state, state.params,
                                    state.ema_params)
        if cfg.ema_decay is not None and state.ema_params is not None \
                and tx.ema_decay is None:
            ema_update(state.ema_params, state.params, cfg.ema_decay)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if cfg.lr_schedule is not None:
            metrics["lr"] = torch.full((), cfg.lr_schedule(state.step),
                                       dtype=torch.float32,
                                       device=images.device)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    """eval_step(params, images, labels) -> summable metric dict (top1,
    top5, count, loss_sum) for the given params, plain or EMA."""

    @torch.inference_mode()
    def eval_step(params: Dict[str, torch.Tensor], images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = torch.func.functional_call(model, params, (images, True))
        metrics = topk_correct(logits, labels, ks=(1, 5))
        metrics["loss_sum"] = cross_entropy(logits, labels) * labels.shape[0]
        return metrics

    return eval_step
