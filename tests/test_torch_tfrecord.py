"""The port's tf.data sources (data/tfrecord.py, data/loader.py's
TFRecordDataset and TfdsDataset) against the JAX package's, on TFRecord
shards of seeded JPEGs that the test writes with the port's writer and
reads with both packages.

The two packages build the same tf.data graph: the same file split among
processes, the shuffle seeded with seed + epoch, the same pp ops, batch
and host normalization. So the batches are equal bit for bit, train and
eval, process 1 of 2, with the ImageNet stats and with the identity stats
of --device_augment (raw [0, 1] pixels). The train pipeline's random ops
draw under one `tf.random.set_seed`, with one parallel call and, as in
tests/test_torch_pp.py, one fixed op seed for the inception crop's box.
The tfds source runs on a stand-in tensorflow_datasets module (neither
machine has the package): builder, even_splits, ReadConfig, SkipDecoding.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from vision_transformers_torch_xla_tpu_torch.core.config import (  # noqa: E402
    TrainConfig,
    config_from_args,
)
from vision_transformers_torch_xla_tpu_torch.data import (  # noqa: E402
    loader,
    tfrecord,
)

N, SHARDS, CLASSES = 24, 4, 5
PP_TRAIN = ('decode_jpeg_and_inception_crop(32)|flip_lr|value_range(0, 1)|'
            'keep("image", "label")')
PP_EVAL = ('decode|resize_small(36)|central_crop(32)|value_range(0, 1)|'
           'keep("image", "label")')


def _examples(n=N, seed=0):
    """n (JPEG of 64-96 px, label) pairs from a seed."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(64, 97, 2))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        yield tf.io.encode_jpeg(img, quality=90).numpy(), i % CLASSES


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return tfrecord.write_tfrecord_shards(
        _examples(), str(tmp_path_factory.mktemp("tfr")), num_shards=SHARDS)


@pytest.fixture(autouse=True)
def seeded_box(monkeypatch):
    """One fixed op seed for the inception crop's box, in both packages
    (with op seed 0 the op ignores tf.random.set_seed)."""
    box = tf.image.sample_distorted_bounding_box
    monkeypatch.setattr(tf.image, "sample_distorted_bounding_box",
                        lambda *a, **kw: box(*a, seed=1234, **kw))


def _batches(ds):
    tf.random.set_seed(3)
    return list(ds)


def _assert_batches_equal(got, want, n):
    assert len(got) == len(want) == n
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_writer_metadata_and_count_equal_jax(shards, tmp_path):
    from vision_transformers_torch_xla_tpu.data import tfrecord as jax_tfr

    want = jax_tfr.write_tfrecord_shards(_examples(), str(tmp_path),
                                         num_shards=SHARDS)
    assert {k: v for k, v in shards.items() if k != "pattern"} == {
        k: v for k, v in want.items() if k != "pattern"} == {
        "num_examples": N, "num_classes": CLASSES, "num_shards": SHARDS}
    for name in sorted(os.listdir(tmp_path)):   # the same shard bytes
        if not name.endswith(".tfrecord"):
            continue
        with open(tmp_path / name, "rb") as a, open(os.path.join(
                os.path.dirname(shards["pattern"]), name), "rb") as b:
            assert a.read() == b.read(), name
    assert tfrecord.serialize_example(b"\x01\x02", 7) == \
        jax_tfr.serialize_example(b"\x01\x02", 7)
    pattern = shards["pattern"]
    assert tfrecord.load_metadata(pattern) == jax_tfr.load_metadata(pattern)
    assert tfrecord.count_examples(pattern) == \
        jax_tfr.count_examples(pattern) == N
    assert tfrecord.load_metadata(str(tmp_path / "val-*.tfrecord")) is None
    with pytest.raises(FileNotFoundError, match="no TFRecord shards"):
        tfrecord.tfrecord_source(str(tmp_path / "val-*.tfrecord"), False, 0,
                                 0, 1)


def _cfg(cls, pattern, **kw):
    return cls(data_set="tfrecord", data_path=pattern, batch_size=4,
               input_size=32, nb_classes=CLASSES, shuffle_buffer=16,
               num_parallel_calls=1, prefetch=1, seed=5, **kw)


STATS = {"imagenet": {}, "raw": dict(device_augment=True)}
# (train, process index, count, stats): each split, stats and process
# split (3 processes do not divide the 4 shards, so they read every file
# and keep every third example) at least once
CASES = [(True, 1, 2, "imagenet"), (True, 0, 1, "raw"), (True, 1, 3, "raw"),
         (False, 1, 2, "raw"), (False, 0, 1, "imagenet"),
         (False, 1, 3, "imagenet")]


@pytest.mark.parametrize(
    "is_train,index,count,stats", CASES,
    ids=[f"{'train' if t else 'eval'}-p{i}of{n}-{st}" for t, i, n, st in CASES])
def test_tfrecord_batches_equal_jax_bit_for_bit(shards, is_train, index,
                                                count, stats):
    """The port's TFRecordDataset against JAX's: two epochs in training
    (the shuffles reseeded), one in eval."""
    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        TFRecordDataset as JaxTFRecordDataset,
    )

    mean, std = loader.norm_constants(TrainConfig(**STATS[stats]))
    pp = PP_TRAIN if is_train else PP_EVAL
    batch = 4 if is_train else 3
    kw = dict(mean=mean, std=std, process_index=index, process_count=count)
    got = loader.TFRecordDataset(_cfg(TrainConfig, shards["pattern"]),
                                 is_train, pp, batch, **kw)
    want = JaxTFRecordDataset(_cfg(JaxTrainConfig, shards["pattern"]),
                              is_train, pp, batch, **kw)
    assert dataclasses.asdict(got.info) == dataclasses.asdict(want.info) == {
        "num_examples": N, "num_classes": CLASSES}
    mine = N // count   # 8 or 12 examples a process
    n_batches = mine // batch if is_train else -(-mine // batch)
    epochs = []
    for _ in range(2 if is_train else 1):
        g, w = _batches(got), _batches(want)
        _assert_batches_equal(g, w, n_batches)
        epochs.append(np.concatenate([x for x, _ in g]))
    if is_train:
        assert not np.array_equal(epochs[0], epochs[1])
    if stats == "raw":
        assert epochs[0].min() >= 0.0 and epochs[0].max() <= 1.0
    else:
        assert epochs[0].min() < 0.0


def test_build_dataset_tfrecord_matches_jax(shards):
    """--data_set tfrecord with --pp_train / --pp_eval: the port's
    build_dataset against JAX's (one process)."""
    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )

    kw = dict(pp_train=PP_TRAIN, pp_eval=PP_EVAL)
    for is_train, n_batches in ((True, 6), (False, 4)):
        ds, info = loader.build_dataset(
            _cfg(TrainConfig, shards["pattern"], **kw), is_train)
        jds, jinfo = jax_build_dataset(
            _cfg(JaxTrainConfig, shards["pattern"], **kw), is_train)
        assert dataclasses.asdict(info) == dataclasses.asdict(jinfo)
        assert ds.pp_spec == jds.pp_spec
        _assert_batches_equal(_batches(ds), _batches(jds), n_batches)
    # no --pp_train / --pp_eval: the JAX defaults
    for is_train in (True, False):
        ds, _ = loader.build_dataset(_cfg(TrainConfig, shards["pattern"]),
                                     is_train)
        assert ds.pp_spec == (loader.DEFAULT_PP_TRAIN if is_train
                              else loader.DEFAULT_PP_EVAL)


def _stand_in_tfds(examples, asked):
    """A tensorflow_datasets stand-in over in-memory examples: split
    'name[ishardn]' (its even_splits) serves examples[i::n]; `asked`
    records what each call asked for."""
    fake = types.ModuleType("tensorflow_datasets")
    n_all = len(examples)

    class _Split:
        num_examples = n_all

    class _Label:
        num_classes = CLASSES

    class _Info:
        splits = {"train": _Split, "validation": _Split}
        features = {"label": _Label}

    class _Builder:
        info = _Info()

        def as_dataset(self, split, shuffle_files, read_config, decoders):
            asked.append((split, shuffle_files, dict(vars(read_config)),
                          sorted(decoders)))
            i, n = (int(v) for v in split[split.index("[") + 1:-1].split(
                "shard"))
            part = examples[i::n]
            return tf.data.Dataset.from_tensor_slices(
                {"image": [e for e, _ in part],
                 "label": np.asarray([lb for _, lb in part], np.int64)})

    fake.builder = lambda name, data_dir=None: _Builder()
    fake.even_splits = lambda split, n: [f"{split}[{i}shard{n}]"
                                         for i in range(n)]
    fake.ReadConfig = lambda **kw: types.SimpleNamespace(**kw)
    fake.decode = types.SimpleNamespace(SkipDecoding=lambda: None)
    return fake


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_tfds_through_a_stand_in_equals_jax(monkeypatch, is_train):
    """Both packages' TfdsDataset over one stand-in module, process 1 of
    2: the same split, read config, info and batches."""
    import jax

    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )

    asked = []
    monkeypatch.setitem(sys.modules, "tensorflow_datasets",
                        _stand_in_tfds(list(_examples(16)), asked))
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    kw = dict(data_set="tfds", batch_size=2, input_size=32, seed=4,
              shuffle_buffer=8, num_parallel_calls=1, pp_train=PP_TRAIN,
              pp_eval=PP_EVAL, nb_classes=CLASSES)
    ds, info = loader.build_dataset(TrainConfig(**kw), is_train, 1, 2)
    jds, jinfo = jax_build_dataset(JaxTrainConfig(**kw), is_train)
    assert dataclasses.asdict(info) == dataclasses.asdict(jinfo) == {
        "num_examples": 16, "num_classes": CLASSES}
    _assert_batches_equal(_batches(ds), _batches(jds), 4 if is_train else 3)
    split = "train[1shard2]" if is_train else "validation[1shard2]"
    assert asked[0][0] == split and asked[0] == asked[1]
    assert asked[2:] == [asked[2]] * 2 and asked[2][1] is is_train
    assert asked[2][2] == {"shuffle_seed": 4 if is_train else None,
                           "skip_prefetch": True}


def test_main_trains_on_tfrecord_shards_on_the_cpu(shards, capsys):
    """main() --data_set tfrecord: 2 steps of test_vit and 1 eval batch,
    its first train batch JAX build_dataset's."""
    from vision_transformers_torch_xla_tpu.core.config import (
        config_from_args as jax_config_from_args,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    argv = ["--data_set", "tfrecord", "--data_path", shards["pattern"],
            "--pp_train", PP_TRAIN, "--pp_eval", PP_EVAL,
            "--model", "test_vit", "--input_size", "32", "--nb_classes",
            str(CLASSES), "--batch_size", "4", "--epochs", "1",
            "--limit_steps_per_epoch", "2", "--limit_eval_batches", "1",
            "--warmup_epochs", "0", "--num_parallel_calls", "1",
            "--shuffle_buffer", "16", "--log_freq", "1"]
    cfg = config_from_args(argv + ["--device", "cpu"])
    ctx = trainer.setup(cfg)
    jds, _ = jax_build_dataset(jax_config_from_args(argv), True)
    tf.random.set_seed(3)
    got = next(iter(ctx.train_ds))
    tf.random.set_seed(3)
    _assert_batches_equal([got], [next(iter(jds))], 1)
    stats = trainer.main(cfg)
    assert stats["count"] == 6.0   # one eval batch of 4 x 1.5
    assert all(np.isfinite(v) for v in stats.values())
    assert "epoch 0 [1/2] loss" in capsys.readouterr().out
