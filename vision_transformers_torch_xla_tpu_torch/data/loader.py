"""Input pipeline: the synthetic and folder sources, and batches to the
device.

Counterpart of vision_transformers_torch_xla_tpu/data/loader.py for the
`synthetic` and `folder` data sets: the `IMAGENET_*` constants,
`norm_constants` (:37-44), `DatasetInfo`, `SyntheticDataset` (:63-110; the
native stream when native/libvtx_io.so loads, else the numpy stream,
chosen as the JAX source chooses at :86), `FolderDataset` (:247-308),
`build_dataset` and `device_prefetch`. Batches stage in pinned host memory
and go to the card with non_blocking copies, a few steps ahead of compute.
The TF-backed data sets (tfds, tfrecord, wds) raise NotImplementedError
naming ROADMAP M5.

Each of W data-parallel processes reads a stream of its own, as each JAX
process does: the synthetic source seeds process i with seed + i·1_000_003
+ 1 (native) or seed + i (numpy), and the folder source reads
samples[i::W] and reports W times its share as the example count. A
process's `batch_size` is its own; the global batch is W times it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import pathlib
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from vision_transformers_torch_xla_tpu_torch.data import native
from vision_transformers_torch_xla_tpu_torch.data.transforms import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

# the data sets whose pipelines need TensorFlow (ROADMAP M5)
TF_DATA_SETS = ("tfds", "tfrecord", "wds", "IMNET_WDS")

# --imagenet_default_mean_and_std false -> inception-style normalization
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


def norm_constants(cfg):
    if getattr(cfg, "device_augment", False):
        # raw [0, 1] pixels to the device; the train step normalizes
        # (data/device_aug.py). The eval set gets these too, and the eval
        # step does not normalize: as in the JAX trainer.
        return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
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
    noise), so a model can fit them. The same seed and process index give
    the JAX source's stream."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, num_examples: int = 1_281_167,
                 seed: int = 0, normalize: bool = True,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 process_index: int = 0):
        self.process_index = process_index
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.info = DatasetInfo(num_examples, num_classes)
        self._seed = seed
        self._normalize = normalize
        self._mean, self._std = mean, std

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._normalize and native.available():
            seed = self._seed + self.process_index * 1_000_003 + 1
            for step in itertools.count():
                yield native.synth_batch(self.batch_size, self.image_size,
                                         self.num_classes, seed + step,
                                         mean=self._mean, std=self._std)
        rng = np.random.default_rng(self._seed + self.process_index)
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


class FolderDataset:
    """A class-per-directory image tree through PIL, as the JAX source reads
    it: the same samples, order, crops and seeds, so the same tree and seed
    give the same batches bit for bit. Process i of n reads
    samples[i::n]."""

    def __init__(self, root: str, batch_size: int, image_size: int = 224,
                 is_train: bool = True, seed: int = 0,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 process_index: int = 0, process_count: int = 1):
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)
        self.root = pathlib.Path(root)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [
            (p, self.class_to_idx[d.name])
            for d in sorted(self.root.iterdir()) if d.is_dir()
            for p in sorted(d.iterdir())
            if p.suffix.lower() in (".jpg", ".jpeg", ".png")]
        self.samples = self.samples[process_index::process_count]
        self.batch_size = batch_size
        self.image_size = image_size
        self.is_train = is_train
        self._seed = seed
        self.info = DatasetInfo(len(self.samples) * process_count,
                                len(classes))

    def _load(self, path, rng: np.random.Generator) -> np.ndarray:
        """Train: a random crop of 40-100% of the area, resized to the
        square, and a random flip; eval: resize the short side to
        size·256/224, then the central square."""
        from PIL import Image

        img = Image.open(path).convert("RGB")
        s = self.image_size
        if self.is_train:
            scale = rng.uniform(0.4, 1.0)
            w, h = img.size
            cw = max(1, int(w * math.sqrt(scale)))
            ch = max(1, int(h * math.sqrt(scale)))
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch)).resize((s, s))
            if rng.random() < 0.5:
                img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        else:
            w, h = img.size
            ratio = (s * 256 // 224) / min(w, h)
            img = img.resize((int(w * ratio), int(h * ratio)))
            w, h = img.size
            img = img.crop(((w - s) // 2, (h - s) // 2,
                            (w - s) // 2 + s, (h - s) // 2 + s))
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - self._mean) / self._std

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self._seed)
        order = rng.permutation(len(self.samples)) if self.is_train \
            else np.arange(len(self.samples))
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            idx = order[i:i + self.batch_size]
            images = np.stack([self._load(self.samples[j][0], rng)
                               for j in idx])
            labels = np.asarray([self.samples[j][1] for j in idx], np.int32)
            yield images.astype(np.float32), labels


def build_dataset(cfg, is_train: bool, process_index: int = 0,
                  process_count: int = 1):
    """(dataset, info) for cfg.data_set: `synthetic`, or `folder` from
    --data_path (--eval_data_path, else --data_path, for eval); the stream
    of process `process_index` of `process_count`."""
    batch = cfg.batch_size if is_train else cfg.eval_batch_size()
    mean, std = norm_constants(cfg)
    if cfg.data_set == "synthetic":
        ds = SyntheticDataset(
            batch, cfg.input_size, cfg.nb_classes,
            cfg.synthetic_train_size if is_train else cfg.synthetic_val_size,
            seed=cfg.seed, normalize=True, mean=mean, std=std,
            process_index=process_index)
        return ds, ds.info
    if cfg.data_set == "folder":
        root = cfg.data_path if is_train else (cfg.eval_data_path
                                               or cfg.data_path)
        ds = FolderDataset(root, batch, cfg.input_size, is_train, cfg.seed,
                           mean=mean, std=std, process_index=process_index,
                           process_count=process_count)
        return ds, ds.info
    if cfg.data_set in TF_DATA_SETS:
        raise NotImplementedError(
            f"data_set {cfg.data_set!r} is not in the port yet (ROADMAP M5); "
            f"use --data_set synthetic or folder")
    raise ValueError(f"unknown data_set {cfg.data_set!r}")


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
