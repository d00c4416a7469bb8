"""Train / eval steps.

Counterpart of vision_transformers_torch_xla_tpu/train/steps.py. One
train step: per-step generators (core/rng.py), with `device_aug` the
on-device crop, flip, RandAugment, normalization and erasing of the raw
[0, 1] batch (data/device_aug.py), mixup/cutmix or smoothed targets, the
forward with stochastic layers on, the soft-target loss (+ KD), the
backward, then the optimizer's update (train/fused.py's AdamW + EMA, or
train/optim.py's other route, the EMA then the step's on every
micro-step). With a second-order optimizer (AdaHessian) the backward
keeps its graph and a second one gives the Hutchinson estimate
z ⊙ (H z) of the Hessian diagonal (train/adahessian.py). On the card the
attention forward and backward are the port's kernels
(ops/flash_attention.py). Metrics come back as device scalars; the caller
reads them only at log_freq (steps.py:11-13).

On a mesh (parallel/) the step takes `shard`, this rank's place in the
global batch (its data index): every per-sample draw is its rows of the
global batch's draw and mixup pairs across the data axis (core/rng.py,
parallel/sharding.py::global_flip), so the step is the JAX step on the
global batch. DDP or FSDP averages the gradients over the data axis (over
the whole mesh under sp), the model axis's split reduces its own inside
the backward, and the grad norm sums each tensor's squares over the axes
that split it (train/fused.py::global_norm); the metrics are this rank's,
and the caller reduces them over the data axis when it reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.core.rng import (
    BatchShard,
    sharded_draws,
    step_rngs,
)
from vision_transformers_torch_xla_tpu_torch.data.device_aug import (
    AugDraw,
    DeviceAugConfig,
    apply_augment,
    sample_augment,
)
from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
    global_flip,
    is_fsdp,
    params_swapped_in,
    unwrap,
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
from vision_transformers_torch_xla_tpu_torch.train.adahessian import (
    check_route,
    conv_kernel_names,
    hessian_diag,
    rademacher_like,
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
                    second_order: bool = False,
                    shard: BatchShard = BatchShard()) -> Callable:
    """Returns train_step(state, images, labels, seed, mixup_draw=None,
    aug_draw=None, hessian_z=None).

    images (B, H, W, 3) and int labels on the model's device. `seed` and
    the host step count give the step's random streams; `mixup_draw` and
    `aug_draw` replace the sampled mixup and augmentation draws (tests feed
    the JAX draws). With `cfg.device_aug` the batch is augmented before
    mixup, as in JAX (steps.py:71-77). With `teacher`, the KD loss mixes
    in its logits (launch/main.py::build_teacher builds the teacher from
    --teacher_model and --teacher_path). `shard` places the batch in the
    global batch by its data index; a fed `aug_draw` holds this rank's
    rows. `second_order` adds the Hessian diagonal for AdaHessian, from
    Rademacher probes drawn from the step's `hess` stream or fed as
    `hessian_z` (tests feed JAX's); it raises on the attention and MLP
    kernel routes (no double backward) and on a mesh."""
    conv_kernels = set()
    if second_order:
        check_route(model)
        if unwrap(model) is not model:
            raise NotImplementedError(
                "adahessian on DDP or FSDP (its second backward bypasses "
                "their gradient reduction) is not in the port yet "
                "(ROADMAP M7)")
        conv_kernels = conv_kernel_names(model)
    flip = global_flip(shard) if shard.count > 1 else None

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor, seed: int,
                   mixup_draw: Optional[MixupDraw] = None,
                   aug_draw: Optional[AugDraw] = None,
                   hessian_z: Optional[Dict[str, torch.Tensor]] = None):
        rngs = step_rngs(seed, state.step, images.device)
        b = images.shape[0]
        with sharded_draws(shard):
            if cfg.device_aug is not None:
                if aug_draw is None:
                    aug_draw = sample_augment(
                        rngs.aug, b * shard.count,
                        cfg.device_aug).rows(shard.rows(b))
                images = apply_augment(images, aug_draw, cfg.device_aug,
                                       rngs.aug_noise)
            if mixup_draw is not None:
                images, targets = apply_mixup(
                    images, smoothed_one_hot(labels, cfg.mixup.num_classes,
                                             cfg.mixup.label_smoothing),
                    mixup_draw, flip)
            elif cfg.mixup.enabled:
                images, targets = mixup_cutmix(rngs.mixup, images, labels,
                                               cfg.mixup, flip)
            else:
                targets = smoothed_one_hot(labels, cfg.num_classes,
                                           cfg.label_smoothing)
            for p in state.params.values():
                p.grad = None
            logits = model(images, deterministic=False,
                           generator=rngs.model)
            loss = soft_target_cross_entropy(logits, targets)
            if teacher is not None:
                with torch.no_grad():
                    t_logits = teacher(images, deterministic=True)
                loss = distillation_loss(logits, t_logits, loss,
                                         cfg.kd_alpha, cfg.kd_temperature)
            extra = {}
            if second_order:
                z = hessian_z or rademacher_like(state.params, rngs.hess)
                grads, extra["hessian_diag"] = hessian_diag(
                    loss, state.params, z, conv_kernels)
            else:
                loss.backward()
                grads = {k: p.grad for k, p in state.params.items()}
        grad_norm = tx.fused_update(grads, state.opt_state, state.params,
                                    state.ema_params, splits=state.splits,
                                    **extra)
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
    top5, count, loss_sum) for the given params, plain or EMA. Under DDP
    the model inside runs alone; under FSDP the params are swapped into
    the shards, the root's gathered params freed after the forward."""
    net, fsdp = unwrap(model), is_fsdp(model)

    @(torch.no_grad if fsdp else torch.inference_mode)()
    def eval_step(params: Dict[str, torch.Tensor], images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        if fsdp:
            with params_swapped_in(model, params):
                logits = model(images, True)
                model.reshard()
        else:
            logits = torch.func.functional_call(net, params, (images, True))
        metrics = topk_correct(logits, labels, ks=(1, 5))
        metrics["loss_sum"] = cross_entropy(logits, labels) * labels.shape[0]
        return metrics

    return eval_step
