"""Experiment logging sinks: TensorBoard, Weights & Biases, JSONL.

Counterpart of vision_transformers_torch_xla_tpu/obs/loggers.py (:23-144):
one JSON object per epoch appended to `<output_dir>/log.txt`, TensorBoard
scalars through `torch.utils.tensorboard`, and a W&B run. Both heavy sinks
are import-gated, as in the JAX package: when tensorboard or wandb does
not import, that sink is off and a warning says so. Only the main process
writes: rank 0 of `torch.distributed`, or the one process when no process
group exists.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional

import torch

log = logging.getLogger(__name__)


def is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


class JsonlLogger:
    """Append one JSON object per epoch to <output_dir>/log.txt."""

    def __init__(self, output_dir: str):
        self.path = os.path.join(output_dir, "log.txt") if output_dir else None
        if self.path and is_main_process():
            os.makedirs(output_dir, exist_ok=True)

    def log(self, stats: Dict):
        if not self.path or not is_main_process():
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(stats) + "\n")


class TensorboardLogger:
    """TensorBoard scalar writer; off (writer None) if tensorboard does not
    import."""

    def __init__(self, log_dir: str):
        self.writer = None
        self.step = 0
        if not is_main_process():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=log_dir)
        except Exception as e:  # pragma: no cover
            log.warning("tensorboard unavailable (%s); TB logging disabled", e)

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None,
               **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(f"{head}/{k}", float(v),
                                   self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


class WandbLogger:
    """W&B run (offline through WANDB_MODE, epoch metrics, optional
    checkpoint artifacts); off if wandb does not import."""

    def __init__(self, project: str, config: Dict,
                 run_name: Optional[str] = None, log_ckpt: bool = False):
        self._wandb = None
        self.log_ckpt = log_ckpt
        if not is_main_process():
            return
        try:
            import wandb

            self._wandb = wandb
            wandb.init(project=project, config=config, name=run_name,
                       mode=os.environ.get("WANDB_MODE", "online"))
            wandb.define_metric("epoch")
            wandb.define_metric("train/*", step_metric="epoch")
            wandb.define_metric("test/*", step_metric="epoch")
        except Exception as e:
            self._wandb = None
            log.warning("wandb unavailable (%s); W&B logging disabled", e)

    def log(self, metrics: Dict, commit: bool = True):
        if self._wandb is not None:
            self._wandb.log(metrics, commit=commit)

    def log_checkpoint(self, path: str, epoch: int):
        if self._wandb is None or not self.log_ckpt:
            return
        art = self._wandb.Artifact(f"ckpt-{self._wandb.run.id}", type="model",
                                   metadata={"epoch": epoch})
        art.add_dir(path)
        self._wandb.log_artifact(art)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()


class EventLogger:
    """Tagged event log: a print on the main process, and a line appended
    to $TPU_LOG_DIR/<tag>.log (the JAX package's variable) or `log_dir`."""

    def __init__(self, tag: str, log_dir: Optional[str] = None):
        self.tag = tag
        self.dir = log_dir or os.environ.get("TPU_LOG_DIR", "")

    def log(self, msg: str):
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] [{self.tag}] {msg}"
        if is_main_process():
            print(line, flush=True)
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            with open(os.path.join(self.dir, f"{self.tag}.log"), "a") as f:
                f.write(line + "\n")


def build_loggers(cfg) -> Dict:
    """The sinks the config asks for: 'jsonl' always (a no-op without
    --output_dir), 'tb' with --enable_tensorboard and --log_dir, 'wandb'
    with --enable_wandb."""
    out = {"jsonl": JsonlLogger(cfg.output_dir)}
    if cfg.enable_tensorboard and cfg.log_dir:
        out["tb"] = TensorboardLogger(cfg.log_dir)
    if cfg.enable_wandb:
        out["wandb"] = WandbLogger(cfg.project, dataclasses.asdict(cfg),
                                   log_ckpt=cfg.wandb_ckpt)
    return out
