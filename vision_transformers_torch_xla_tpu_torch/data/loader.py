"""Input pipeline: the synthetic source, and batches to the device.

Counterpart of vision_transformers_torch_xla_tpu/data/loader.py for the
`synthetic` data set: the `IMAGENET_*` constants, `DatasetInfo`,
`SyntheticDataset` (:63-110; the native stream when native/libvtx_io.so
loads, else the numpy stream, chosen as the JAX source chooses at :86),
`build_dataset` and `device_prefetch`. Batches stage in pinned host memory
and go to the card with non_blocking copies, a few steps ahead of compute.
Other data sets raise NotImplementedError naming ROADMAP M5.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from vision_transformers_torch_xla_tpu_torch.data import native
from vision_transformers_torch_xla_tpu_torch.data.transforms import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

# --imagenet_default_mean_and_std false -> inception-style normalization
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


def norm_constants(cfg):
    if getattr(cfg, "imagenet_default_mean_and_std", True):
        return IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    return IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD


@dataclasses.dataclass
class DatasetInfo:
    num_examples: int
    num_classes: int


class SyntheticDataset:
    """Deterministic synthetic ImageNet-shaped stream.

    Images are procedural (class-conditioned low-frequency patterns +
    noise), so a model can fit them. The same seed gives the JAX source's
    stream (one process: process index 0)."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, num_examples: int = 1_281_167,
                 seed: int = 0, normalize: bool = True,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.info = DatasetInfo(num_examples, num_classes)
        self._seed = seed
        self._normalize = normalize
        self._mean, self._std = mean, std

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._normalize and native.available():
            seed = self._seed + 1
            for step in itertools.count():
                yield native.synth_batch(self.batch_size, self.image_size,
                                         self.num_classes, seed + step,
                                         mean=self._mean, std=self._std)
        rng = np.random.default_rng(self._seed)
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        while True:
            labels = rng.integers(0, self.num_classes, self.batch_size)
            freq = (labels % 16 + 1).astype(np.float32)
            phase = (labels // 16 % 64).astype(np.float32) / 64 * 2 * np.pi
            base = np.sin(freq[:, None, None] * 6.28 * (yy + xx)[None] +
                          phase[:, None, None])
            images = base[..., None].repeat(3, axis=-1) * 0.25 + 0.5
            images += rng.normal(0, 0.05, images.shape).astype(np.float32)
            images = images.astype(np.float32)
            if self._normalize:
                images = (images - np.asarray(self._mean, np.float32)) / \
                    np.asarray(self._std, np.float32)
            yield images.astype(np.float32), labels.astype(np.int32)


def build_dataset(cfg, is_train: bool):
    """(dataset, info) for cfg.data_set; only `synthetic` is ported."""
    if cfg.data_set != "synthetic":
        raise NotImplementedError(
            f"data_set {cfg.data_set!r} is not in the port yet (ROADMAP M5); "
            f"use --data_set synthetic")
    batch = cfg.batch_size if is_train else cfg.eval_batch_size()
    mean, std = norm_constants(cfg)
    ds = SyntheticDataset(
        batch, cfg.input_size, cfg.nb_classes,
        cfg.synthetic_train_size if is_train else cfg.synthetic_val_size,
        seed=cfg.seed, normalize=True, mean=mean, std=std)
    return ds, ds.info


def to_device(batch, device: torch.device):
    """(images, labels) numpy -> tensors on `device`: pinned host memory and
    non_blocking copies on the card, plain tensors on the CPU."""
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def device_prefetch(iterator, put: Callable, size: int = 2):
    """Stage host batches on the device `size` steps ahead of compute, so
    the host-to-device copy overlaps the step. `put(batch)` maps one host
    batch to device tensors (e.g. `to_device`)."""
    it = iter(iterator)
    queue = collections.deque(put(b) for b in itertools.islice(it, size))
    while queue:
        yield queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
