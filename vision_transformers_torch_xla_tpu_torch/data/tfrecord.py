"""TFRecord shards of tf.train.Example records through the tf.data chain.

Counterpart of vision_transformers_torch_xla_tpu/data/tfrecord.py
(`serialize_example` :34, `write_tfrecord_shards` :47, `_parse_fn` :84,
`load_metadata` :100, `count_examples` :112, `tfrecord_source` :120).
`--data_set tfrecord` reads raw shards through the same pipeline tail as
the tfds source (data/loader.py::_finalize_tf_pipeline: host options,
the epoch's seeded shuffle, the pp-language map, batch, prefetch).

Record schema (the surface of tfds imagenet2012 that the pp ops read):
  image: bytes feature, the ENCODED image (decoded by the pp pipeline)
  label: int64 feature

Shards written by `write_tfrecord_shards` carry a `<prefix>.metadata.json`
sidecar (num_examples, num_classes), so the data set's size needs no scan.
TensorFlow is imported on first use (data/pp_ops.py::tensorflow), except
by `load_metadata`, which reads only the sidecar.
"""
from __future__ import annotations

import glob as _glob
import json
import os
from typing import Iterable, Optional, Tuple

from vision_transformers_torch_xla_tpu_torch.data.pp_ops import tensorflow


def serialize_example(image_bytes: bytes, label: int) -> bytes:
    """One tf.train.Example with encoded image bytes + int64 label."""
    tf = tensorflow()
    feat = {
        "image": tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[image_bytes])),
        "label": tf.train.Feature(
            int64_list=tf.train.Int64List(value=[int(label)])),
    }
    return tf.train.Example(
        features=tf.train.Features(feature=feat)).SerializeToString()


def write_tfrecord_shards(examples: Iterable[Tuple[bytes, int]],
                          out_dir: str, prefix: str = "train",
                          num_shards: int = 8,
                          num_classes: Optional[int] = None) -> dict:
    """Write `(image_bytes, label)` pairs round-robin into
    `{prefix}-NNNNN-of-NNNNN.tfrecord` shards + a metadata sidecar.

    Returns the metadata dict {num_examples, num_classes, num_shards,
    pattern} (pattern is the glob that reads these shards back).
    """
    tf = tensorflow()
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(
        out_dir, f"{prefix}-{i:05d}-of-{num_shards:05d}.tfrecord")
        for i in range(num_shards)]
    writers = [tf.io.TFRecordWriter(p) for p in paths]
    n = 0
    max_label = -1
    try:
        for image_bytes, label in examples:
            writers[n % num_shards].write(serialize_example(image_bytes, label))
            max_label = max(max_label, int(label))
            n += 1
    finally:
        for w in writers:
            w.close()
    meta = {
        "num_examples": n,
        "num_classes": num_classes if num_classes is not None else max_label + 1,
        "num_shards": num_shards,
        "pattern": os.path.join(out_dir, f"{prefix}-*.tfrecord"),
    }
    with open(os.path.join(out_dir, f"{prefix}.metadata.json"), "w") as f:
        json.dump(meta, f)
    return meta


def _parse_fn():
    tf = tensorflow()
    spec = {
        "image": tf.io.FixedLenFeature([], tf.string),
        "label": tf.io.FixedLenFeature([], tf.int64),
    }

    def parse(record):
        feats = tf.io.parse_single_example(record, spec)
        # int32 labels downstream, as the tfds path casts them on the host
        feats["label"] = tf.cast(feats["label"], tf.int32)
        return feats

    return parse


def load_metadata(pattern: str) -> Optional[dict]:
    """Find the sidecar for a shard glob like `dir/train-*.tfrecord`."""
    base = os.path.basename(pattern)
    prefix = base.split("-")[0].split("*")[0].split(".")[0]
    cand = os.path.join(os.path.dirname(pattern),
                        f"{prefix}.metadata.json")
    if prefix and os.path.exists(cand):
        with open(cand) as f:
            return json.load(f)
    return None


def count_examples(pattern: str) -> int:
    """Fallback one-pass count when no metadata sidecar exists."""
    tf = tensorflow()
    files = sorted(_glob.glob(pattern))
    ds = tf.data.TFRecordDataset(files)
    return int(ds.reduce(0, lambda acc, _: acc + 1).numpy())


def tfrecord_source(pattern: str, is_train: bool, epoch_seed: int,
                    process_index: int, process_count: int):
    """The raw example stream of process `process_index` of
    `process_count`: {"image": bytes, "label": int32}. The processes' parts
    are disjoint and together complete:

      * a shard count divisible by the process count -> each process reads
        only its own files (files[i::n]), in training in a file order
        shuffled from the epoch's seed;
      * otherwise -> every file in order, then the example-level
        `ds.shard(process_count, process_index)`.
    """
    tf = tensorflow()
    files = sorted(tf.io.gfile.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no TFRecord shards match {pattern!r}")

    if len(files) % process_count == 0:
        mine = files[process_index::process_count]
        file_ds = tf.data.Dataset.from_tensor_slices(mine)
        if is_train:
            file_ds = file_ds.shuffle(len(mine), seed=epoch_seed,
                                      reshuffle_each_iteration=False)
        ds = file_ds.interleave(
            tf.data.TFRecordDataset,
            cycle_length=min(len(mine), 16),
            num_parallel_calls=tf.data.AUTOTUNE,
            deterministic=True)
    else:
        ds = tf.data.TFRecordDataset(files)
        ds = ds.shard(process_count, process_index)

    return ds.map(_parse_fn(), num_parallel_calls=tf.data.AUTOTUNE)
