"""Typed training configuration + CLI mapping.

Counterpart of vision_transformers_torch_xla_tpu/core/config.py: the same
`TrainConfig` fields and defaults, the same auto-generated flags and the
same reference-compat flag handling, so one command line configures either
trainer. The port's trainer (launch/main.py) raises NotImplementedError,
naming the ROADMAP item, for options outside its slice. `device` ''
means cuda there.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


def str2bool(v) -> bool:
    """Parity with reference main.py:130-141."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


@dataclasses.dataclass
class TrainConfig:
    # --- core schedule (main.py:146-153) ---
    batch_size: int = 64                 # per-process batch
    epochs: int = 300
    update_freq: int = 1                 # gradient accumulation steps
    save_ckpt_freq: int = 1
    save_ckpt_num: int = 3
    save_ckpt: bool = True

    # --- model (main.py:155-168) ---
    model: str = "my_vit_b"
    input_size: int = 224
    drop_path: float = 0.1
    global_pool: str = "avg"             # 'avg' | 'token' | 'map' | ''
    # (the reference trainer hardcodes avg for vit models, main.py:647)
    act_layer: str = ""                  # '' = model default (timm's
    # exact-erf GELU); the flagship recipe passes 'gelu_tanh'.
    layer_scale_init_value: float = 0.0  # 0 disables LayerScale
    grad_checkpointing: bool = False     # recompute each block (remat)
    scan_blocks: bool = False            # the JAX scan path's semantics
    pallas_attn: str = "auto"            # 'auto' | 'on' | 'off': the
    # attention kernels (ops/flash_attention.py); on the card they always
    # run, on the CPU their plain versions do
    pallas_mlp: str = "off"              # 'on' | 'off': fused-backward MLP
    # (ops/mlp_fused.py, kernel K3); same param tree either way

    # --- EMA (main.py:161-167) ---
    model_ema: bool = False
    model_ema_decay: float = 0.9999
    model_ema_eval: bool = False

    # --- optimizer (main.py:169-184) ---
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Optional[Tuple[float, float]] = None
    clip_grad: Optional[float] = None
    momentum: float = 0.9
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None  # cosine WD schedule endpoint

    # --- LR schedule (main.py:185-199) ---
    lr: float = 4e-3
    layer_decay: float = 1.0
    warmup_lr: float = 1e-6
    min_lr: float = 1e-6
    warmup_epochs: int = 20
    warmup_steps: int = -1

    # --- augmentation (main.py:198-230) ---
    color_jitter: float = 0.4            # inert in TFDS path (parity)
    aa: str = "rand-m9-mstd0.5-inc1"     # RandAugment spec
    smoothing: float = 0.1
    train_interpolation: str = "bicubic"
    crop_pct: Optional[float] = None
    reprob: float = 0.0                  # random erase (inert in TFDS path)
    remode: str = "pixel"
    recount: int = 1

    # --- on-device augmentation (new; SURVEY §7 stretch goal) ---
    device_augment: bool = False         # RRC/flip/RandAugment inside the step

    # --- mixup / cutmix (main.py:214-230) ---
    mixup: float = 0.8
    cutmix: float = 1.0
    cutmix_minmax: Optional[Tuple[float, float]] = None
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"

    # --- finetune (main.py:232-238) ---
    finetune: str = ""
    model_key: str = "model|module"
    model_prefix: str = ""

    # --- data (main.py:240-301) ---
    data_path: str = ""
    eval_data_path: str = ""
    nb_classes: int = 1000
    imagenet_default_mean_and_std: bool = True
    data_set: str = "synthetic"          # synthetic | tfds | tfrecord | folder | wds
    tfds_name: str = "imagenet2012"
    tfds_data_dir: str = ""
    train_split: str = "train"
    val_split: str = "validation"
    pp_train: str = ""                   # big_vision-style pp string; '' = default
    pp_eval: str = ""
    shuffle_buffer: int = 250_000        # datasets.py:60
    prefetch: int = 2                    # datasets.py:62
    num_parallel_calls: int = 100        # datasets.py:61
    cache_raw: bool = False
    synthetic_train_size: int = 1_281_167
    synthetic_val_size: int = 50_000

    # --- bookkeeping (main.py:303-330) ---
    output_dir: str = ""
    log_dir: Optional[str] = None
    device: str = ""                     # '' = default backend; 'cpu' forces host
    seed: int = 0
    resume: str = ""
    auto_resume: bool = True
    start_epoch: int = 0
    eval_only: bool = False
    disable_eval: bool = False
    num_workers: int = 4
    log_freq: int = 100

    # --- precision (replaces XLA_USE_BF16 env magic, main.py:30) ---
    precision: str = "bf16"              # bf16 | fp32 | bf16_pure

    # --- parallelism (new: the reference is DP-only, SURVEY §2.3) ---
    mesh_shape: str = "data"             # e.g. "data" or "data:8,model:4"
    param_sharding: str = "replicated"   # replicated | fsdp

    # --- logging (main.py:331-338) ---
    enable_wandb: bool = False
    project: str = "vit-tpu"
    wandb_ckpt: bool = False
    enable_tensorboard: bool = False

    # --- knowledge distillation (main.py:340-351) ---
    kd: bool = False
    teacher_model: str = "my_vit_l"
    teacher_path: str = ""
    kd_alpha: float = 0.5
    kd_temperature: float = 4.0

    # --- eval sizing (main.py:603: eval batch = 1.5x train) ---
    eval_batch_mult: float = 1.5

    # --- debug limits (new; 0 = no limit) ---
    limit_steps_per_epoch: int = 0
    limit_eval_batches: int = 0

    # --- profiling (new; reference has no profiler, SURVEY §5) ---
    profile_steps: int = 0               # capture a device trace of N steps
    # of the first epoch into <log_dir or output_dir>/profile

    def eval_batch_size(self) -> int:
        return int(self.batch_size * self.eval_batch_mult)

    def parse_mesh_shape(self):
        """'data' -> [('data',-1)]; 'data:8,model:4' -> [('data',8),('model',4)]."""
        axes = []
        for part in self.mesh_shape.split(","):
            part = part.strip()
            if ":" in part:
                name, n = part.split(":")
                axes.append((name.strip(), int(n)))
            else:
                axes.append((part, -1))
        return axes


_FIELD_HELP = {
    "batch_size": "per-process batch size",
    "model": "model name from the registry (see list_models())",
    "opt": "optimizer name (adamw, sgd, momentum, nadam, radam, lamb, lars, lion, adafactor, rmsproptf, novograd, adadelta, adagrad, adamax, ...)",
    "mesh_shape": "device mesh spec, e.g. 'data' or 'data:8,model:4' (-1 sizes inferred)",
}


def build_argparser() -> argparse.ArgumentParser:
    """Auto-generate the CLI from TrainConfig (one flag per field)."""
    p = argparse.ArgumentParser("ViT training (PyTorch port)",
                                add_help=True)
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name
        default = f.default
        help_txt = _FIELD_HELP.get(f.name, "")
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(name, type=str2bool, default=default, help=help_txt)
        elif f.type in ("Optional[Tuple[float, float]]",) or f.name in ("opt_betas", "cutmix_minmax"):
            p.add_argument(name, type=float, nargs="+", default=None, help=help_txt)
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default, help=help_txt)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default, help=help_txt)
        elif f.name in ("clip_grad", "weight_decay_end", "crop_pct", "log_dir"):
            typ = str if f.name == "log_dir" else float
            p.add_argument(name, type=typ, default=None, help=help_txt)
        else:
            p.add_argument(name, type=str, default=default, help=help_txt)
    return p


# Reference flags that don't exist here but are accepted for script
# compatibility (reference main.py:144-352). Mapped or warned-and-ignored.
_COMPAT_FLAGS = {
    # flag -> (action, detail)
    "--tpu": ("ignore", "the device comes from --device"),
    "--use_amp": ("map_bool", "precision"),          # true -> bf16 (default)
    "--eval": ("map_true", "eval_only"),
    "--dist_eval": ("ignore", "eval is always sharded over the data axis"),
    "--pin_mem": ("ignore", "the loader always pins host batches"),
    "--world_size": ("ignore", "topology comes from torchrun's env"),
    "--local_rank": ("ignore", "topology comes from torchrun's env"),
    "--rank": ("ignore", "topology comes from torchrun's env"),
    "--dist_url": ("ignore", "rendezvous configured via torchrun's env"),
    "--dist_on_itp": ("ignore", "not applicable"),
    "--model_ema_force_cpu": ("ignore", "EMA lives on the device"),
}


def config_from_args(argv=None) -> TrainConfig:
    import sys
    import warnings

    argv = list(sys.argv[1:] if argv is None else argv)
    # strip/translate reference-compat flags before the real parse
    cleaned = []
    i = 0
    eval_only = False
    while i < len(argv):
        arg = argv[i]
        base = arg.split("=")[0]
        if base in _COMPAT_FLAGS:
            action, detail = _COMPAT_FLAGS[base]
            consumed = 1
            if "=" not in arg and i + 1 < len(argv) and \
                    not argv[i + 1].startswith("--"):
                consumed = 2
            if action == "map_true":
                eval_only = True
            elif action != "map_bool":
                warnings.warn(f"{base} accepted for reference-script "
                              f"compatibility but ignored: {detail}")
            i += consumed
            continue
        cleaned.append(arg)
        i += 1

    args = build_argparser().parse_args(cleaned)
    kw = vars(args)
    for tup_field in ("opt_betas", "cutmix_minmax"):
        if kw.get(tup_field) is not None:
            kw[tup_field] = tuple(kw[tup_field])
    if eval_only:
        kw["eval_only"] = True
    return TrainConfig(**kw)
