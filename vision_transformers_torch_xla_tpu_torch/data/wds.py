"""WebDataset-format input pipeline: tar shards of JPEG + cls files.

Counterpart of vision_transformers_torch_xla_tpu/data/wds.py
(`expand_shards` :37, `_sample_inception_crop` :49, `WdsDataset` :75):
tar shards are split among the processes, reshuffled each epoch, and
their samples decode through the native C++ runtime's worker pool
(data/native.py::DecodePool: fused JPEG decode + inception or central
crop + resize + normalize) when native/libvtx_io.so loads, and through
PIL otherwise. The same shards, seed and process give the JAX source's
batches bit for bit on either path.

Shard spec: a glob ('.../train-*.tar') or brace range
('.../train-{0000..0146}.tar'), as webdataset writes them. Sample
convention: <key>.jpg/.jpeg + <key>.cls (the ASCII class index).

Process i of n reads all_shards[i::n], so every process must hold at
least one shard; a process whose shards hold fewer samples than its
peers' ends its epoch early, as in the JAX source.
"""
from __future__ import annotations

import glob
import io
import logging
import math
import re
import tarfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from vision_transformers_torch_xla_tpu_torch.data import native
from vision_transformers_torch_xla_tpu_torch.data.loader import DatasetInfo
from vision_transformers_torch_xla_tpu_torch.data.transforms import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    central_crop_window,
)

log = logging.getLogger(__name__)


def expand_shards(spec: str) -> List[str]:
    """Expand '{0000..0146}' brace ranges or globs into a shard list."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", spec)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [spec[:m.start()] + str(i).zfill(width) + spec[m.end():]
                for i in range(int(lo), int(hi) + 1)]
    expanded = sorted(glob.glob(spec))
    return expanded if expanded else [spec]


def _sample_inception_crop(rng: np.random.Generator, w: int, h: int,
                           area_min: float = 0.05, area_max: float = 1.0,
                           ratio_min: float = 3 / 4, ratio_max: float = 4 / 3):
    """RandomResizedCrop window (x, y, w, h) in source pixels: up to 10
    draws of area and log-aspect, else the central square."""
    area = w * h
    for _ in range(10):
        target = rng.uniform(area_min, area_max) * area
        ar = math.exp(rng.uniform(math.log(ratio_min), math.log(ratio_max)))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if cw <= w and ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return x0, y0, cw, ch
    s = min(w, h)
    return (w - s) // 2, (h - s) // 2, s, s


class WdsDataset:
    """Iterable (images, labels) batches from webdataset tar shards; the
    stream of process `process_index` of `process_count`."""

    def __init__(self, shard_spec: str, batch_size: int, image_size: int = 224,
                 is_train: bool = True, seed: int = 0,
                 num_classes: int = 1000,
                 num_examples: Optional[int] = None,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 process_index: int = 0, process_count: int = 1):
        self._mean, self._std = tuple(mean), tuple(std)
        self.process_index = process_index
        self.all_shards = expand_shards(shard_spec)
        self.shards = self.all_shards[process_index::process_count]
        if not self.shards:
            raise ValueError(f"no shards for process {process_index} "
                             f"from {shard_spec!r}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.is_train = is_train
        self.seed = seed
        self._epoch = -1
        if num_examples is None:
            num_examples = self._count_examples()
        self.info = DatasetInfo(num_examples, num_classes)

    def _count_examples(self) -> int:
        """The first shard's count times the number of shards."""
        n = 0
        with tarfile.open(self.all_shards[0]) as tar:
            for m in tar:
                if m.name.endswith(".cls"):
                    n += 1
        return n * len(self.all_shards)

    def _iter_samples(self, rng: np.random.Generator
                      ) -> Iterator[Tuple[bytes, int]]:
        order = rng.permutation(len(self.shards)) if self.is_train \
            else np.arange(len(self.shards))
        for si in order:
            with tarfile.open(self.shards[si]) as tar:
                pending = {}
                for m in tar:
                    key, dot, ext = m.name.rpartition(".")
                    if not dot:
                        continue
                    data = tar.extractfile(m).read()
                    entry = pending.setdefault(key, {})
                    entry[ext.lower()] = data
                    if ("cls" in entry) and any(
                            e in entry for e in ("jpg", "jpeg")):
                        img = entry.get("jpg") or entry.get("jpeg")
                        yield img, int(entry["cls"])
                        del pending[key]

    def _decode(self, data: bytes, rng: np.random.Generator) -> np.ndarray:
        """One sample through PIL: the crop window, a resize to the square
        (PIL's default filter), normalization, and in training a flip."""
        from PIL import Image

        s = self.image_size
        pil = Image.open(io.BytesIO(data)).convert("RGB")
        w, h = pil.size
        x0, y0, cw, ch = (_sample_inception_crop(rng, w, h) if self.is_train
                          else central_crop_window(w, h, s))
        pil = pil.crop((x0, y0, x0 + cw, y0 + ch)).resize((s, s))
        arr = np.asarray(pil, np.float32) / 255.0
        img = ((arr - np.asarray(self._mean, np.float32)) /
               np.asarray(self._std, np.float32))
        if self.is_train and rng.random() < 0.5:
            img = img[:, ::-1]
        return np.ascontiguousarray(img, np.float32)

    def _iter_pooled(self, rng: np.random.Generator):
        """Batches through the native worker pool: the crop windows are
        drawn here (a header peek gives the size), decode + resize +
        normalize fan out to C++ threads, one wait per batch. A JPEG whose
        body fails to decode comes back by tag (its batch slot), and the
        slot is refilled from the stream: corrupt files are dropped, never
        trained on. A short last batch is dropped."""
        pool = native.DecodePool(mean=self._mean, std=self._std)
        s = self.image_size
        it = self._iter_samples(rng)
        batch_img = np.empty((self.batch_size, s, s, 3), np.float32)
        labels = np.zeros((self.batch_size,), np.int32)
        flips = np.zeros((self.batch_size,), bool)

        def submit_into(slot) -> bool:
            """Pull samples until one submits; False when the stream ends."""
            for data, cls in it:
                try:
                    w, h = native.jpeg_dims(data)
                except ValueError:
                    continue  # a header that does not parse: skip it
                crop = _sample_inception_crop(rng, w, h) if self.is_train \
                    else central_crop_window(w, h, s)
                pool.submit(data, batch_img[slot], s, crop=crop, tag=slot)
                flips[slot] = self.is_train and rng.random() < 0.5
                labels[slot] = cls
                return True
            return False

        try:
            while True:
                if not all(submit_into(n) for n in range(self.batch_size)):
                    pool.wait()
                    return
                pool.wait()
                failed = pool.take_failed()
                while failed:
                    log.warning("dropping %d corrupt jpeg(s)", len(failed))
                    if not all(submit_into(slot) for slot in failed):
                        pool.wait()
                        return
                    pool.wait()
                    failed = pool.take_failed()
                for i in np.nonzero(flips)[0]:
                    batch_img[i] = batch_img[i, :, ::-1]
                yield batch_img.copy(), labels.copy()
        finally:
            pool.close()

    def __iter__(self):
        self._epoch += 1
        rng = np.random.default_rng(
            self.seed + self._epoch * 100_003 + self.process_index)
        if native.available():
            yield from self._iter_pooled(rng)
            return
        images, labels = [], []
        for data, cls in self._iter_samples(rng):
            images.append(self._decode(data, rng))
            labels.append(cls)
            if len(images) == self.batch_size:
                yield (np.stack(images),
                       np.asarray(labels, np.int32))
                images, labels = [], []
