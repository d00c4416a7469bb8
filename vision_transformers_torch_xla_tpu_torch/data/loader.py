"""Input pipeline: every data set of the JAX trainer, and batches to the
device.

Counterpart of vision_transformers_torch_xla_tpu/data/loader.py: the
`IMAGENET_*` constants, `norm_constants` (:37-44), the default pp strings
(`DEFAULT_PP_TRAIN`, `DEFAULT_PP_EVAL`, :48-52), `DatasetInfo`,
`SyntheticDataset` (:63-110; the native stream when native/libvtx_io.so
loads, else the numpy stream, chosen as the JAX source chooses at :86),
the tf.data sources (`_finalize_tf_pipeline` :113, `_tfds_dataset` :142,
`_TfBackedDataset` :167, `TfdsDataset`, `TFRecordDataset`),
`FolderDataset` (:247-308), `build_dataset` (:311-346) and
`device_prefetch`. Batches stage in pinned host memory and go to the card
with non_blocking copies, a few steps ahead of compute.

`--data_set`: `synthetic`; `folder` (PIL over a class-per-directory tree);
`wds` and `IMNET_WDS` (webdataset tar shards, data/wds.py: the native
decode pool, or PIL where native/libvtx_io.so does not load); `tfrecord`
(data/tfrecord.py) and `tfds` (tensorflow_datasets), both through the
tf.data chain of the pp language (data/pp_builder.py, data/pp_ops.py).
TensorFlow and tensorflow_datasets are imported only by the last two,
which raise ImportError naming whichever is missing.

Each of W data-parallel processes (on a mesh: each of the data axis's W
indices, whose model peers read the same stream) reads a stream of its
own, as each JAX process does: the synthetic source seeds process i with seed + i·1_000_003
+ 1 (native) or seed + i (numpy); the folder source reads samples[i::W]
and reports W times its share as the example count; wds reads
shards[i::W]; tfrecord reads files[i::W] (or every W-th example when W
does not divide the shard count); tfds reads `tfds.even_splits(split,
W)[i]`. A process's `batch_size` is its own; the global batch is W times
it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import pathlib
from typing import Callable, Iterator, Optional, Tuple

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
    if getattr(cfg, "device_augment", False):
        # raw [0, 1] pixels to the device; the train step normalizes
        # (data/device_aug.py). The eval set gets these too, and the eval
        # step does not normalize: as in the JAX trainer.
        return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    if getattr(cfg, "imagenet_default_mean_and_std", True):
        return IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    return IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD


# the pp strings of the tf.data sources when --pp_train / --pp_eval are
# not given (JAX loader.py:48-52)
DEFAULT_PP_TRAIN = ("decode_jpeg_and_inception_crop(224)|flip_lr|"
                    "value_range(0, 1)|keep(\"image\", \"label\")")
DEFAULT_PP_EVAL = ("decode|resize_small(256)|central_crop(224)|"
                   "value_range(0, 1)|keep(\"image\", \"label\")")


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


def _finalize_tf_pipeline(ds, cfg, is_train: bool, pp_spec: str,
                          batch_size: int, epoch_seed: int):
    """The tf.data tail of every TF-backed source (tfds, tfrecord): host
    options -> [cache] -> [shuffle] -> map(pp) -> batch -> prefetch. One
    epoch is one pass (no repeat); each epoch rebuilds the pipeline with a
    seed of its own."""
    from vision_transformers_torch_xla_tpu_torch.data.pp_builder import (
        get_preprocess_fn,
    )
    from vision_transformers_torch_xla_tpu_torch.data.pp_ops import (
        tensorflow,
    )

    tf = tensorflow()
    opts = tf.data.Options()
    opts.threading.private_threadpool_size = 48
    opts.threading.max_intra_op_parallelism = 1
    opts.experimental_optimization.inject_prefetch = False
    ds = ds.with_options(opts)

    if is_train:
        if cfg.cache_raw:
            ds = ds.cache()
        ds = ds.shuffle(cfg.shuffle_buffer, seed=epoch_seed)
    pp_fn = get_preprocess_fn(pp_spec)
    ds = ds.map(pp_fn, num_parallel_calls=cfg.num_parallel_calls)
    ds = ds.batch(batch_size, drop_remainder=is_train)
    ds = ds.prefetch(cfg.prefetch)
    return ds


def _tfds_dataset(cfg, is_train: bool, pp_spec: str, batch_size: int,
                  epoch_seed: int = 0, process_index: int = 0,
                  process_count: int = 1):
    """(tf.data pipeline, DatasetInfo) of --tfds_name's split: process
    `process_index` reads `tfds.even_splits(split, process_count)` at that
    index, the images still encoded (decoded by the pp pipeline)."""
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise ImportError(f"--data_set tfds needs tensorflow_datasets: "
                          f"{e}") from e

    builder = tfds.builder(cfg.tfds_name,
                           data_dir=cfg.tfds_data_dir or None)
    split_name = cfg.train_split if is_train else cfg.val_split
    num_examples = builder.info.splits[split_name].num_examples
    num_classes = builder.info.features["label"].num_classes

    split = tfds.even_splits(split_name, process_count)[process_index]
    read_config = tfds.ReadConfig(
        shuffle_seed=epoch_seed if is_train else None,
        skip_prefetch=True)
    ds = builder.as_dataset(
        split=split, shuffle_files=is_train, read_config=read_config,
        decoders={"image": tfds.decode.SkipDecoding()})

    ds = _finalize_tf_pipeline(ds, cfg, is_train, pp_spec, batch_size,
                               epoch_seed)
    return ds, DatasetInfo(num_examples, num_classes)


class _TfBackedDataset:
    """A tf.data source rebuilt each epoch with seed + epoch: `iter()`
    pulls numpy batches and normalizes them on the host, unless the stats
    are the identity (the raw [0, 1] pixels of --device_augment). The
    stream of process `process_index` of `process_count`."""

    def __init__(self, cfg, is_train: bool, pp_spec: str, batch_size: int,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 process_index: int = 0, process_count: int = 1):
        from vision_transformers_torch_xla_tpu_torch.data.pp_ops import (
            tensorflow,
        )

        tensorflow()  # raises here, naming it, where TensorFlow is missing
        self.cfg, self.is_train = cfg, is_train
        self.pp_spec, self.batch_size = pp_spec, batch_size
        self._pi, self._pc = process_index, process_count
        self._epoch = -1
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)
        self._identity = bool(np.all(self._mean == 0)
                              and np.all(self._std == 1))
        self.info = self._build_info()

    def _build_info(self) -> DatasetInfo:
        raise NotImplementedError

    def _build(self, epoch_seed: int):
        raise NotImplementedError

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._epoch += 1
        ds = self._build(epoch_seed=self.cfg.seed + self._epoch)
        for batch in ds.as_numpy_iterator():
            images = batch["image"].astype(np.float32)
            if not self._identity:
                images = (images - self._mean) / self._std
            yield images, batch["label"].astype(np.int32)


class TfdsDataset(_TfBackedDataset):
    """`--data_set tfds`: --tfds_name's --train_split / --val_split."""

    def _build_info(self) -> DatasetInfo:
        _, info = _tfds_dataset(self.cfg, self.is_train, self.pp_spec,
                                self.batch_size,
                                process_index=self._pi,
                                process_count=self._pc)
        return info

    def _build(self, epoch_seed: int):
        ds, _ = _tfds_dataset(self.cfg, self.is_train, self.pp_spec,
                              self.batch_size, epoch_seed=epoch_seed,
                              process_index=self._pi, process_count=self._pc)
        return ds


class TFRecordDataset(_TfBackedDataset):
    """`--data_set tfrecord`: the Example shards of --data_path (eval:
    --eval_data_path, else --data_path) through the tfds source's pipeline
    tail (data/tfrecord.py has the schema and the split among
    processes)."""

    def __init__(self, cfg, is_train: bool, pp_spec: str, batch_size: int,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 process_index: int = 0, process_count: int = 1):
        self._pattern = (cfg.data_path if is_train
                         else (cfg.eval_data_path or cfg.data_path))
        super().__init__(cfg, is_train, pp_spec, batch_size, mean=mean,
                         std=std, process_index=process_index,
                         process_count=process_count)

    def _build_info(self) -> DatasetInfo:
        from vision_transformers_torch_xla_tpu_torch.data import (
            tfrecord as tfr,
        )

        meta = tfr.load_metadata(self._pattern)
        if meta is not None:
            return DatasetInfo(meta["num_examples"],
                               meta.get("num_classes") or self.cfg.nb_classes)
        return DatasetInfo(tfr.count_examples(self._pattern),
                           self.cfg.nb_classes)

    def _build(self, epoch_seed: int):
        from vision_transformers_torch_xla_tpu_torch.data import (
            tfrecord as tfr,
        )

        ds = tfr.tfrecord_source(self._pattern, self.is_train, epoch_seed,
                                 self._pi, self._pc)
        return _finalize_tf_pipeline(ds, self.cfg, self.is_train,
                                     self.pp_spec, self.batch_size,
                                     epoch_seed)


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
                  process_count: int = 1, batch: Optional[int] = None):
    """(dataset, info) for cfg.data_set: `synthetic`; `folder`, `wds` /
    `IMNET_WDS` or `tfrecord` from --data_path (--eval_data_path, else
    --data_path, for eval); `tfds` from --tfds_name. The stream of process
    `process_index` of `process_count` (on a mesh: the data index and the
    data axis's size, so a data index's model peers read the same stream),
    in batches of `batch` rows (--batch_size, or the eval batch, if
    None)."""
    if batch is None:
        batch = cfg.batch_size if is_train else cfg.eval_batch_size()
    mean, std = norm_constants(cfg)
    if cfg.data_set == "synthetic":
        ds = SyntheticDataset(
            batch, cfg.input_size, cfg.nb_classes,
            cfg.synthetic_train_size if is_train else cfg.synthetic_val_size,
            seed=cfg.seed, normalize=True, mean=mean, std=std,
            process_index=process_index)
        return ds, ds.info
    world = dict(process_index=process_index, process_count=process_count)
    if cfg.data_set in ("tfds", "tfrecord"):
        pp = (cfg.pp_train or DEFAULT_PP_TRAIN) if is_train else \
            (cfg.pp_eval or DEFAULT_PP_EVAL)
        source = TfdsDataset if cfg.data_set == "tfds" else TFRecordDataset
        ds = source(cfg, is_train, pp, batch, mean=mean, std=std, **world)
        return ds, ds.info
    if cfg.data_set in ("wds", "IMNET_WDS"):
        from vision_transformers_torch_xla_tpu_torch.data.wds import (
            WdsDataset,
        )

        spec = cfg.data_path if is_train else (cfg.eval_data_path
                                               or cfg.data_path)
        ds = WdsDataset(spec, batch, cfg.input_size, is_train, cfg.seed,
                        num_classes=cfg.nb_classes, mean=mean, std=std,
                        **world)
        return ds, ds.info
    if cfg.data_set == "folder":
        root = cfg.data_path if is_train else (cfg.eval_data_path
                                               or cfg.data_path)
        ds = FolderDataset(root, batch, cfg.input_size, is_train, cfg.seed,
                           mean=mean, std=std, **world)
        return ds, ds.info
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
