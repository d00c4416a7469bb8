"""Training CLI: the composition root.

Counterpart of vision_transformers_torch_xla_tpu/launch/main.py (`setup`,
`train_one_epoch`, `evaluate`, `main`; :162-521): the same flags
(core/config.py), the same prints and the same returned dicts. As
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
the CPU runs only with `--device cpu`.

The trainer's state and observability are JAX's (launch/main.py:122-159,
:247-300, :347-417, :479-515): `--output_dir` saves the state each epoch
into `<output_dir>/checkpoints` (ckpt/checkpoint.py: `--save_ckpt_num`
kept, every `--save_ckpt_freq` epochs) and appends the epoch's stats to
`<output_dir>/log.txt`; a run whose output_dir holds checkpoints resumes
from the newest (`--auto_resume`, on by default). `--resume` takes a
checkpoints root, one epoch's directory in it, or a .pth (weights only);
`--finetune` a .pth (`--model_key`, `--model_prefix`) or a checkpoints
directory, grafted by name and shape with the position embedding
resampled (models/pretrained.py). `--kd true` adds a teacher
(`--teacher_model`, in the compute policy, initialised from seed + 1 or
loaded from `--teacher_path`), built without the attention kernels as
the JAX trainer builds it: only the student launches them.
`--enable_tensorboard true --log_dir DIR` writes scalars at log_freq,
`--enable_wandb true` a W&B run (off, with a warning, when wandb does not
import), `--profile_steps N` a torch.profiler trace of steps 2 to N + 1
of the first epoch into `<log_dir or output_dir>/profile`, and a
watchdog dumps the stacks when no step ends for 900 s.

`--data_set` takes every data set of the JAX trainer (data/loader.py):
`synthetic`; `folder`, a class-per-directory tree, and `wds` /
`IMNET_WDS`, webdataset tar shards (a glob or a {0000..0146} range), from
`--data_path` (`--eval_data_path` for eval), decoded on the host by the
native library or PIL; `tfrecord` (Example shards) and `tfds`
(`--tfds_name`) through the tf.data chain of `--pp_train` / `--pp_eval`,
which needs TensorFlow (and tensorflow_datasets for tfds) and raises
ImportError naming what is missing. `--device_augment true` crops, flips,
RandAugments (`--aa`), colour-jitters (`--color_jitter`, without
RandAugment), normalizes and erases (`--reprob`) each raw [0, 1] batch
inside the train step, on its device (data/device_aug.py), as the JAX
trainer does (launch/main.py:306-331); the eval batches then stay raw, as
there.

`--grad_checkpointing true` recomputes each block in the backward
(models/vit.py::remat_block) and `--scan_blocks true` builds the blocks
with the JAX scan path's semantics, as the JAX trainer passes them
(launch/main.py:202-203).

Under torchrun the trainer runs one process per GPU over the mesh of
`--mesh_shape` (parallel/; launch/runner.py starts torchrun on many
hosts). `data` carries the batch: `--param_sharding replicated` wraps
the model in DDP over it and `fsdp` in FSDP2. `model` carries the heads
and the MLP's hidden columns (tensor parallelism: each rank runs the
attention kernels on its heads and K3 on its columns), or under
`--param_sharding sp` each block's tokens. `--batch_size` is per process,
so the global batch, the steps per epoch and the eval batches count
batch_size x the mesh's processes, as JAX counts them
(launch/main.py:174-195); a data index holds global / D rows, and its
model peers the same rows. A step on the mesh is the one-process step on
the global batch: the draws are rows of the global batch's, the loss and
eval totals global. A mesh smaller than the world trains on its first
ranks, and the others return at once. Only rank 0 prints and writes logs
and checkpoints:

    torchrun --nproc_per_node 4 -m \
        vision_transformers_torch_xla_tpu_torch.launch.main --device cpu \
        --mesh_shape data:2,model:2 ...

Each data index's data set is that process's stream of the JAX source
(`build_dataset` gets the data index and the data axis's size). As in the
JAX trainer, a rank leaves the epoch when its own stream ends: a rank
whose shards (wds, tfrecord) hold fewer samples than its peers' leaves
them waiting in a collective it does not join, so give the ranks even
shards (ROADMAP §3).

A block the model axis cannot split raises NotImplementedError naming its
ROADMAP item (M6b), as does a ConvNeXt under tp or sp.

`--model` takes the ConvNeXt names too (models/convnext.py), built
without the kernel switches, which JAX passes only to a model that has
them; `--opt` every name of the JAX factory, with `lookahead_`;
`--update_freq k` updates once every k micro-steps on their mean
gradient, the EMA moving on each, as JAX's optax.MultiSteps
(train/optim.py):

    python -m vision_transformers_torch_xla_tpu_torch.launch.main \
        --model convnext_tiny --batch_size 128 --update_freq 4 \
        --drop_path 0.1 --layer_scale_init_value 1e-6 --model_ema true
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
    auto_resume,
)
from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    load_checkpoint,
)
from vision_transformers_torch_xla_tpu_torch.core.config import (
    TrainConfig,
    config_from_args,
)
from vision_transformers_torch_xla_tpu_torch.core.dtypes import get_policy
from vision_transformers_torch_xla_tpu_torch.core.rng import BatchShard
from vision_transformers_torch_xla_tpu_torch.data.device_aug import (
    DeviceAugConfig,
    parse_aa_spec,
)
from vision_transformers_torch_xla_tpu_torch.data.loader import (
    IMAGENET_INCEPTION_MEAN,
    IMAGENET_INCEPTION_STD,
    build_dataset,
    device_prefetch,
    to_device,
)
from vision_transformers_torch_xla_tpu_torch.data.transforms import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)
from vision_transformers_torch_xla_tpu_torch.models import create_model
from vision_transformers_torch_xla_tpu_torch.models.layers import init_weights
from vision_transformers_torch_xla_tpu_torch.models.pretrained import (
    merge_into_params,
)
from vision_transformers_torch_xla_tpu_torch.obs import profiler
from vision_transformers_torch_xla_tpu_torch.obs.loggers import (
    build_loggers,
    is_main_process,
)
from vision_transformers_torch_xla_tpu_torch.obs.metrics import MetricLogger
from vision_transformers_torch_xla_tpu_torch.obs.watchdog import StepWatchdog
from vision_transformers_torch_xla_tpu_torch.parallel.mesh import (
    ProcessMesh,
    check_axes,
    create_mesh,
    env_world,
    init_distributed,
    world,
)
from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
    all_reduce_sum,
    is_fsdp,
    unreached_parameters,
    unwrap,
    wrap_model,
)
from vision_transformers_torch_xla_tpu_torch.train.mixup import MixupConfig
from vision_transformers_torch_xla_tpu_torch.train.adahessian import (
    conv_kernel_names,
)
from vision_transformers_torch_xla_tpu_torch.train.optim import (
    create_optimizer,
    is_second_order,
)
from vision_transformers_torch_xla_tpu_torch.train.schedules import (
    cosine_schedule_fn,
)
from vision_transformers_torch_xla_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from vision_transformers_torch_xla_tpu_torch.train.transforms import (
    Optimizer,
)
from vision_transformers_torch_xla_tpu_torch.train.steps import (
    StepConfig,
    make_eval_step,
    make_train_step,
)

log = logging.getLogger(__name__)


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
    loggers: dict = dataclasses.field(default_factory=dict)
    ckpt: Optional[CheckpointManager] = None
    teacher: Optional[nn.Module] = None
    start_epoch: int = 0
    watchdog: Optional[StepWatchdog] = None
    eval_batches: Optional[int] = None
    shard: BatchShard = BatchShard()
    mesh: Optional[ProcessMesh] = None

    @property
    def processes(self) -> int:
        """The mesh's processes: the global batch is batch_size times it."""
        return len(self.mesh.ranks) if self.mesh is not None else 1


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
    """Raise on a mesh the rules cannot place (parallel/mesh.py::check_axes):
    an unknown --param_sharding, an axis other than data and model."""
    check_axes(cfg.parse_mesh_shape(), cfg.param_sharding)


def check_batches(cfg: TrainConfig, process_count: int,
                  data_size: int) -> None:
    """JAX's batch checks against the data axis (launch/main.py:175-184),
    with its texts; --batch_size is per process."""
    if (cfg.batch_size * process_count) % data_size:
        raise ValueError(
            f"global batch {cfg.batch_size * process_count} must divide "
            f"the data mesh axis ({data_size}); adjust --batch_size")
    if cfg.eval_batch_size() % data_size and not cfg.disable_eval:
        raise ValueError(
            f"eval batch {cfg.eval_batch_size()} (= batch_size x "
            f"{cfg.eval_batch_mult}) must divide the data mesh axis "
            f"({data_size}); adjust --eval_batch_mult")


def device_aug_config(cfg: TrainConfig) -> DeviceAugConfig:
    """--device_augment's DeviceAugConfig from --aa, --reprob,
    --color_jitter, --input_size and --imagenet_default_mean_and_std (JAX
    launch/main.py:306-329)."""
    aa = parse_aa_spec(cfg.aa)
    layers, mag, mstd = aa if aa else (0, 0.0, 0.0)
    default_stats = cfg.imagenet_default_mean_and_std
    return DeviceAugConfig(
        out_size=cfg.input_size, randaug_layers=layers,
        randaug_magnitude=mag, mag_std=mstd, reprob=cfg.reprob,
        color_jitter=cfg.color_jitter,
        mean=IMAGENET_DEFAULT_MEAN if default_stats
        else IMAGENET_INCEPTION_MEAN,
        std=IMAGENET_DEFAULT_STD if default_stats else IMAGENET_INCEPTION_STD)


def dense_views(model: nn.Module) -> list:
    """The conv-shaped weights (ndim 4) that the JAX model holds as dense
    kernels: every one but a flax nn.Conv's (the ViT's patch embedding,
    ConvNeXt's patch stem and downsamples)."""
    convs = conv_kernel_names(model)
    return [k for k, p in model.named_parameters()
            if p.ndim == 4 and k not in convs]


def pallas_attn_switch(pallas_attn: str, device: torch.device) -> bool:
    """`use_pallas_attn` for `--pallas_attn`, as the JAX trainer sets it
    (launch/main.py:207-211): `on`, or `auto` off the CPU, for every
    compute dtype: the port's kernels take bf16, fp16 and fp32 on the card,
    as the JAX kernels take any float dtype."""
    return pallas_attn == "on" or (pallas_attn == "auto"
                                   and device.type != "cpu")


WEIGHT_FILES = (".pth", ".pt", ".bin")


def load_weights_into(params, path: str, model_key: str = "model|module",
                      model_prefix: str = "") -> None:
    """Graft the weights of a .pth or a checkpoints directory onto the live
    `params` by name and shape, the position embedding resampled
    (JAX launch/main.py::_load_params_into)."""
    if not (path.endswith(WEIGHT_FILES) or os.path.isdir(path)):
        raise NotImplementedError(
            f"{path!r}: the port loads a .pth or a checkpoints directory; "
            f"pretrained sources are not in the port yet (ROADMAP M7)")
    _, n = merge_into_params(params, load_checkpoint(path, model_key,
                                                     model_prefix))
    log.info("loaded %d params from %s", n, path)


def _explicit_resume(cfg: TrainConfig, state: TrainState) -> int:
    """--resume of a checkpoints root (its newest epoch) or one epoch's
    directory in it (JAX launch/main.py:122-159; `setup` loads a .pth,
    weights only, before wrapping). Returns the epoch to start at."""
    path = cfg.resume
    if not os.path.isdir(path):
        raise FileNotFoundError(f"--resume: no checkpoint at {path!r}")
    root, epoch = os.path.abspath(path), None
    base = os.path.basename(root.rstrip("/"))
    if base.isdigit():  # .../checkpoints/<epoch>
        root, epoch = os.path.dirname(root), int(base)
    restored, meta = CheckpointManager(root).restore(state, epoch)
    if restored is None:
        raise FileNotFoundError(f"--resume: no epochs under {root!r}")
    used = epoch if epoch is not None else (meta or {}).get("epoch")
    log.info("resumed from %s at epoch %s", root, used)
    return (meta or {}).get("epoch", used or 0) + 1


def build_teacher(cfg: TrainConfig, device: torch.device) -> nn.Module:
    """The KD teacher (JAX launch/main.py:281-300): `--teacher_model` in
    the compute policy, without the attention kernels (as JAX builds it),
    initialised from seed + 1 or loaded from `--teacher_path`; frozen, in
    eval mode."""
    policy = get_policy(cfg.precision)
    teacher = create_model(cfg.teacher_model, num_classes=cfg.nb_classes,
                           img_size=cfg.input_size,
                           dtype=policy.compute_dtype,
                           param_dtype=policy.param_dtype, device=device)
    init_weights(teacher,
                 torch.Generator(device=device).manual_seed(cfg.seed + 1))
    if cfg.teacher_path:
        load_weights_into(dict(teacher.named_parameters()), cfg.teacher_path)
    else:
        log.warning("KD enabled without --teacher_path: teacher is random")
    return teacher.eval().requires_grad_(False)


def setup(cfg: TrainConfig) -> Optional[TrainerContext]:
    """The trainer on this process's place on the mesh; None on a rank
    past a mesh smaller than the world, which sits the run out."""
    check_slice(cfg)
    device = init_distributed(resolve_device(cfg.device))
    mesh = create_mesh(cfg.parse_mesh_shape(), device)
    if mesh is not None and not mesh.member:
        log.warning("rank %d sits out: the mesh %s runs on ranks 0-%d",
                    world()[0], mesh.sizes, len(mesh.ranks) - 1)
        return None
    nproc = len(mesh.ranks) if mesh is not None else 1
    data_n = mesh.size("data") if mesh is not None else 1
    data_i = mesh.index("data") if mesh is not None else 0
    check_batches(cfg, nproc, data_n)
    policy = get_policy(cfg.precision)
    want_pallas = pallas_attn_switch(cfg.pallas_attn, device)

    # a data index's rows of the global batch, and of the global eval batch
    rows = cfg.batch_size * nproc // data_n
    eval_rows = cfg.eval_batch_size() * nproc // data_n
    train_ds, info = build_dataset(cfg, True, data_i, data_n, rows)
    val_ds, val_info = build_dataset(cfg, False, data_i, data_n,
                                     eval_rows) \
        if not cfg.disable_eval else (None, None)
    steps_per_epoch = max(info.num_examples // (cfg.batch_size * nproc), 1)
    eval_batches = None
    if val_info is not None:
        eval_batches = max(val_info.num_examples //
                           (cfg.eval_batch_size() * nproc), 1)

    model_kw = dict(
        num_classes=cfg.nb_classes, img_size=cfg.input_size,
        drop_path_rate=cfg.drop_path, global_pool=cfg.global_pool,
        act_layer=cfg.act_layer or None,
        init_values=cfg.layer_scale_init_value or None,
        remat=cfg.grad_checkpointing, scan_blocks=cfg.scan_blocks or None,
        dtype=policy.compute_dtype, param_dtype=policy.param_dtype)
    # the kernel switches go to a model that has them, as JAX's hasattr
    # test decides (launch/main.py:208-214): a ConvNeXt has none
    if hasattr(create_model(cfg.model, **model_kw, device="meta"),
               "use_pallas_attn"):
        model_kw.update(use_pallas_attn=want_pallas,
                        use_pallas_mlp=cfg.pallas_mlp == "on")
    model = create_model(cfg.model, **model_kw, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(cfg.seed))
    # weights load into the whole tensors, before FSDP shards them
    if cfg.finetune:
        load_weights_into(dict(model.named_parameters()), cfg.finetune,
                          cfg.model_key, cfg.model_prefix)
    if cfg.resume.endswith(WEIGHT_FILES):
        load_weights_into(dict(model.named_parameters()), cfg.resume,
                          cfg.model_key, cfg.model_prefix)
        log.info("resumed model weights from %s", cfg.resume)
    unreached = ()
    if mesh is not None and cfg.param_sharding != "fsdp":
        # which parameters no gradient reaches, from a forward and backward
        # of the same configuration on the meta device (no kernels)
        unreached = unreached_parameters(
            create_model(cfg.model, **{
                k: v for k, v in model_kw.items()
                if k not in ("use_pallas_attn", "use_pallas_mlp")},
                device="meta"),
            (2, cfg.input_size, cfg.input_size, 3))
    model, splits = wrap_model(model, mesh, cfg.param_sharding, unreached)
    net = unwrap(model)

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
    # after wrapping: under FSDP the params, moments and EMA are shards,
    # on the model axis the split ones this rank's parts
    params = dict(net.named_parameters())
    tx = create_optimizer(
        cfg.opt, lr_fn, params, weight_decay=cfg.weight_decay,
        weight_decay_schedule=wd_fn, opt_eps=cfg.opt_eps,
        opt_betas=cfg.opt_betas, momentum=cfg.momentum,
        clip_grad=cfg.clip_grad, layer_decay=cfg.layer_decay,
        model_depth=getattr(net, "depth", 12), update_freq=cfg.update_freq,
        ema_decay=cfg.model_ema_decay if cfg.model_ema else None,
        dense_views=dense_views(net))
    if isinstance(tx, Optimizer):   # a whole-tensor update refuses parts
        tx.check_unsharded(params, splits)
    state = create_train_state(net, tx, with_ema=cfg.model_ema,
                               splits=splits)

    mix = MixupConfig(
        mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix, prob=cfg.mixup_prob,
        switch_prob=cfg.mixup_switch_prob, label_smoothing=cfg.smoothing,
        num_classes=cfg.nb_classes)
    step_cfg = StepConfig(
        device_aug=device_aug_config(cfg) if cfg.device_augment else None,
        mixup=mix, label_smoothing=cfg.smoothing, num_classes=cfg.nb_classes,
        ema_decay=cfg.model_ema_decay if cfg.model_ema else None,
        kd_alpha=cfg.kd_alpha, kd_temperature=cfg.kd_temperature,
        lr_schedule=lr_fn)
    teacher = build_teacher(cfg, device) if cfg.kd else None

    ckpt = None
    start_epoch = cfg.start_epoch
    if cfg.resume and not cfg.resume.endswith(WEIGHT_FILES):
        start_epoch = _explicit_resume(cfg, state)
    if cfg.output_dir and cfg.save_ckpt:
        ckpt = CheckpointManager(
            os.path.abspath(os.path.join(cfg.output_dir, "checkpoints")),
            max_to_keep=cfg.save_ckpt_num,
            save_interval_epochs=cfg.save_ckpt_freq,
            group=mesh.group if mesh is not None else None)
        if cfg.auto_resume and not cfg.resume:
            restored, epoch = auto_resume(ckpt, state)
            if restored is not None:
                start_epoch = epoch
                log.info("auto-resumed at epoch %d", start_epoch)
    shard = BatchShard(data_i, data_n,
                       mesh.axis_group("data") if data_n > 1 else None)
    return TrainerContext(
        cfg=cfg, device=device, model=model, state=state,
        train_step=make_train_step(model, tx, step_cfg, teacher,
                                   second_order=is_second_order(cfg.opt),
                                   shard=shard),
        eval_step=make_eval_step(model), train_ds=train_ds, val_ds=val_ds,
        steps_per_epoch=steps_per_epoch, loggers=build_loggers(cfg),
        ckpt=ckpt, teacher=teacher, start_epoch=start_epoch,
        eval_batches=eval_batches, shard=shard, mesh=mesh)


def train_one_epoch(ctx: TrainerContext, epoch: int,
                    max_steps: Optional[int] = None) -> dict:
    """Host loop for one epoch; the profile window, the watchdog's beat
    and the TensorBoard scalars as in JAX launch/main.py:371-417."""
    cfg = ctx.cfg
    logger = MetricLogger()
    n_steps = min(ctx.steps_per_epoch, max_steps or ctx.steps_per_epoch)

    # skip the first (warm-up) steps
    profile_at = (2 if cfg.profile_steps > 0 and epoch == ctx.start_epoch
                  and is_main_process() else -1)
    profile_dir = os.path.join(cfg.log_dir or cfg.output_dir or ".",
                               "profile")
    window = contextlib.ExitStack()  # holds the open profile trace
    tracing = False

    t0 = time.time()
    batches = device_prefetch(ctx.train_ds,
                              lambda b: to_device(b, ctx.device))
    for i in range(n_steps):
        try:
            images, labels = next(batches)
        except StopIteration:
            break
        if i == profile_at:
            window.enter_context(profiler.trace(profile_dir))
            tracing = True
        if tracing and i == profile_at + cfg.profile_steps:
            window.close()
            tracing = False
            print(f"profile trace written to {profile_dir}", flush=True)
        ctx.state, metrics = ctx.train_step(ctx.state, images, labels,
                                            cfg.seed)
        if ctx.watchdog is not None:
            ctx.watchdog.beat()
        if i % cfg.log_freq == 0 or i == n_steps - 1:
            host = {k: float(v)
                    for k, v in global_metrics(ctx, metrics).items()}
            logger.update(**host)
            if is_main_process():
                ips = cfg.batch_size * ctx.processes * (i + 1) / \
                    (time.time() - t0)
                print(f"epoch {epoch} [{i}/{n_steps}] "
                      f"loss {host['loss']:.4f} lr {host.get('lr', 0):.2e} "
                      f"grad_norm {host.get('grad_norm', 0):.2f} "
                      f"({ips:.0f} img/s)", flush=True)
            if "tb" in ctx.loggers:
                ctx.loggers["tb"].update(head="train",
                                         step=epoch * n_steps + i, **host)
    if tracing:  # the epoch is shorter than the profile window
        window.close()
        print(f"profile trace written to {profile_dir}", flush=True)
    if ctx.shard.count > 1:   # each sample once: over the data axis
        logger.synchronize_between_processes(ctx.shard.group)
    return {f"train_{k}": m.global_avg for k, m in logger.meters.items()}


def global_metrics(ctx: TrainerContext, metrics: dict) -> dict:
    """The step's metrics over the global batch: the data indices' mean of
    the loss, in one all-reduce over the data axis (a data index's model
    peers hold its loss alike; the grad norm and lr are every rank's)."""
    if ctx.shard.count == 1:
        return metrics
    loss = all_reduce_sum({"loss": metrics["loss"]}, ctx.shard.group)["loss"]
    return {**metrics, "loss": loss / ctx.shard.count}


def evaluate(ctx: TrainerContext, use_ema: bool = False,
             max_batches: Optional[int] = None) -> dict:
    """Eval pass: top-1/top-5/loss summed on the device, summed over the
    data axis in one all-reduce (each sample once) and read once at the
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
    if ctx.shard.count > 1:
        totals = all_reduce_sum(totals, ctx.shard.group)
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
    if world()[0] == 0 and env_world()[0] == 0:
        print(f"config: {cfg}", flush=True)
    ctx = setup(cfg)
    if ctx is None:   # past the mesh: nothing to train
        return {}
    main_process = is_main_process()
    if main_process:
        n = ctx.processes
        wrapper = "FSDP2" if is_fsdp(ctx.model) else \
            "DDP" if unwrap(ctx.model) is not ctx.model else "no wrapper"
        mesh = f"; mesh {ctx.mesh.sizes}" if ctx.mesh is not None else ""
        print(f"devices: {n} ({n} processes, {wrapper}): {ctx.device}{mesh}",
              flush=True)

    if cfg.eval_only:
        stats = evaluate(ctx, max_batches=max_eval_batches)
        if main_process:
            print(f"eval: top-1 {stats['acc1']:.2f}% top-5 "
                  f"{stats['acc5']:.2f}%")
        return stats

    watchdog = StepWatchdog(timeout_s=900.0).start()
    ctx.watchdog = watchdog
    max_accuracy = 0.0
    last_stats: dict = {}
    try:
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
                if main_process:
                    print(f"epoch {epoch}: top-1 {eval_stats['acc1']:.2f}% "
                          f"(best {max_accuracy:.2f}%)", flush=True)
            if ctx.ckpt is not None:
                ctx.ckpt.save(epoch, ctx.state, metadata={"epoch": epoch})
            ctx.loggers["jsonl"].log(stats)
            if "wandb" in ctx.loggers:
                ctx.loggers["wandb"].log(stats)
            last_stats = stats
    finally:
        watchdog.stop()
    if ctx.ckpt is not None:
        ctx.ckpt.wait()
        ctx.ckpt.close()
    if "tb" in ctx.loggers:
        ctx.loggers["tb"].flush()
    if "wandb" in ctx.loggers:
        ctx.loggers["wandb"].finish()
    return last_stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(config_from_args())
