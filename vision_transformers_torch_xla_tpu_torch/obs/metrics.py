"""Host-side metric meters.

Counterpart of vision_transformers_torch_xla_tpu/obs/metrics.py, as far as
the trainer uses it: `SmoothedValue` (the window's median and the global
average) and `MetricLogger` (a dict of them). Meters are fed from device
scalars pulled only at log_freq. `synchronize_between_processes` sums
each meter's [count, total] over the ranks of a torch.distributed group
(JAX :36-47): the trainer passes its data axis's, so a meter counts each
sample once whatever the model axis holds. `vit_train_flops_per_image` is
bench.py's analytic count (:40-52), the numerator of MFU.
"""
from __future__ import annotations

import collections
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


class SmoothedValue:
    """Track a series: the window's median and the global average."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, group=None):
        """All-reduce [count, total] across `group`'s processes (the
        default group if None; JAX :36-47)."""
        if not (dist.is_available() and dist.is_initialized()):
            return
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group) == "nccl" else torch.device("cpu")
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, group=group)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(median=self.median, global_avg=self.global_avg)


class MetricLogger:
    """Dict of SmoothedValues, fed by name."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = \
            collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is not None:
                self.meters[k].update(float(v))

    def synchronize_between_processes(self, group=None):
        for meter in self.meters.values():
            meter.synchronize_between_processes(group)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())


def vit_train_flops_per_image(img: int = 224, patch: int = 16,
                              dim: int = 768, depth: int = 12,
                              num_classes: int = 1000) -> float:
    """Analytic FLOPs of one train step per image: the forward's patch
    projection, per-block attention and MLP products and head, times 3."""
    s = (img // patch) ** 2 + 1
    patch_proj = 2 * s * (patch * patch * 3) * dim
    per_block = (2 * s * dim * 3 * dim          # qkv
                 + 2 * s * s * dim * 2          # scores + PV
                 + 2 * s * dim * dim            # proj
                 + 2 * s * dim * 4 * dim * 2)   # mlp fc1+fc2
    head = 2 * dim * num_classes
    fwd = patch_proj + depth * per_block + head
    return 3.0 * fwd
