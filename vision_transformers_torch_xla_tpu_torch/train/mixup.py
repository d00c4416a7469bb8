"""Batch-mode Mixup / CutMix on device tensors.

Counterpart of vision_transformers_torch_xla_tpu/train/mixup.py with the
sampling split from the application: `sample_mixup` draws the few
per-step scalars on the host from a numpy Generator (the gate, the
mixup/cutmix switch, one Beta(α, α) lambda and the cutmix box), and
`apply_mixup` applies them to the batch on its device. The scalars are
Python numbers, so the device work needs no host sync, and a test can feed
the JAX draws to `apply_mixup`. Semantics are timm's: pairing with the
batch flip, cut = int(h·√(1−λ)), a uniform centre, a clipped box, and λ
corrected from the box area (mixup.py:79-100).

On D data indices (the mesh's data axis) the pairing is the *global*
batch's flip, as JAX pairs the rows of its global array: global row g =
d·b + i mixes with row N−1−g, which is data index D−1−d's row b−1−i.
`apply_mixup` takes the flip as `flip`; the train step passes
parallel/sharding.py::global_flip, one exchange with that index's rank
in the data axis's group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8       # reference --mixup
    cutmix_alpha: float = 1.0      # reference --cutmix
    prob: float = 1.0              # --mixup_prob
    switch_prob: float = 0.5       # --mixup_switch_prob
    label_smoothing: float = 0.1   # --smoothing
    num_classes: int = 1000

    @property
    def enabled(self) -> bool:
        return self.mixup_alpha > 0.0 or self.cutmix_alpha > 0.0


@dataclasses.dataclass(frozen=True)
class MixupDraw:
    """One step's draws. `lam` is the Beta sample of the chosen branch;
    `box` = (y0, y1, x0, x1) is read only by cutmix."""

    apply: bool
    cutmix: bool
    lam: float
    box: Tuple[int, int, int, int] = (0, 0, 0, 0)


def smoothed_one_hot(labels: torch.Tensor, num_classes: int,
                     smoothing: float) -> torch.Tensor:
    """timm one_hot: on = 1 - s + s/C, off = s/C, fp32."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _rand_bbox(rng: np.random.Generator, h: int, w: int,
               lam: float) -> Tuple[int, int, int, int]:
    """timm rand_bbox: cut ratio √(1−λ), uniform centre, clipped box."""
    ratio = math.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    return (min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h),
            min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w))


def sample_mixup(rng: np.random.Generator, h: int, w: int,
                 cfg: MixupConfig) -> MixupDraw:
    """The per-step draws of mixup.py:66-78, from a numpy Generator. They
    equal the JAX draws in distribution, not bit for bit."""
    apply = bool(rng.random() < cfg.prob)
    if cfg.mixup_alpha > 0.0 and cfg.cutmix_alpha > 0.0:
        cutmix = bool(rng.random() < cfg.switch_prob)
    else:
        cutmix = cfg.cutmix_alpha > 0.0
    alpha = max(cfg.cutmix_alpha if cutmix else cfg.mixup_alpha, 1e-8)
    lam = float(rng.beta(alpha, alpha))
    box = _rand_bbox(rng, h, w, lam) if cutmix else (0, 0, 0, 0)
    return MixupDraw(apply, cutmix, lam, box)


def batch_flip(images: torch.Tensor, targets: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return images.flip(0), targets.flip(0)


def apply_mixup(images: torch.Tensor, targets: torch.Tensor,
                draw: MixupDraw, flip: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix NHWC images and soft targets with their partners: `flip(images,
    targets)` gives the partners' rows (the batch flip by default)."""
    if not draw.apply:
        return images, targets
    flipped, flipped_t = (flip or batch_flip)(images, targets)
    if draw.cutmix:
        y0, y1, x0, x1 = draw.box
        mixed = images.clone()
        mixed[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
        h, w = images.shape[1], images.shape[2]
        lam = 1.0 - float((y1 - y0) * (x1 - x0)) / float(h * w)
    else:
        lam = draw.lam
        mixed = (images.float() * lam + flipped.float() * (1.0 - lam)
                 ).to(images.dtype)
    return mixed, targets * lam + flipped_t * (1.0 - lam)


def mixup_cutmix(rng: np.random.Generator, images: torch.Tensor,
                 labels: torch.Tensor, cfg: MixupConfig,
                 flip: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample, then apply: (mixed images, fp32 soft targets)."""
    targets = smoothed_one_hot(labels, cfg.num_classes, cfg.label_smoothing)
    if not cfg.enabled:
        return images, targets
    draw = sample_mixup(rng, images.shape[1], images.shape[2], cfg)
    return apply_mixup(images, targets, draw, flip)
