"""The port's webdataset source (data/wds.py, data/native.py::DecodePool)
against the JAX package's, on tar shards the test writes itself.

Both sources draw the shard order, the crop windows and the flips from
numpy's default_rng(seed + epoch·100_003 + process index), and decode
either through native/libvtx_io.so's worker pool or, where the library
does not load (a host without libjpeg), through PIL. So
the same shards, seed and process give the same batches bit for bit on
both paths: train and eval, two epochs, process 1 of 2. On the JAX side
the process index and count come from `jax.process_index` /
`process_count`, set here with monkeypatch.
"""
import dataclasses
import io
import tarfile

import numpy as np
import pytest

from vision_transformers_torch_xla_tpu_torch.core.config import (
    TrainConfig,
    config_from_args,
)
from vision_transformers_torch_xla_tpu_torch.data import loader, native, wds

N_SHARDS, PER_SHARD, CLASSES = 4, 6, 5


def _jpeg(rng, h: int, w: int) -> bytes:
    from PIL import Image

    arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def write_shards(root, n_shards=N_SHARDS, per_shard=PER_SHARD, seed=0):
    """n_shards tars of per_shard seeded JPEGs of 64-96 px (one a shard
    named .jpeg) with their .cls files, and a file of no sample."""
    rng = np.random.default_rng(seed)
    for s in range(n_shards):
        with tarfile.open(root / f"shard-{s:04d}.tar", "w") as tar:
            for i in range(per_shard):
                h, w = (int(v) for v in rng.integers(64, 97, 2))
                ext = "jpeg" if i == 2 else "jpg"
                key = f"{s:04d}{i:04d}"
                for name, data in (
                        (f"{key}.{ext}", _jpeg(rng, h, w)),
                        (f"{key}.cls",
                         str(int(rng.integers(0, CLASSES))).encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
            info = tarfile.TarInfo("README")
            info.size = 2
            tar.addfile(info, io.BytesIO(b"hi"))
    return str(root / f"shard-{{0000..{n_shards - 1:04d}}}.tar")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("wds"))


def _jax_process(monkeypatch, index: int, count: int):
    import jax

    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)


def _use_pil(monkeypatch):
    """Both packages' native modules report no library: the PIL path."""
    from vision_transformers_torch_xla_tpu.data import native as jax_native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _assert_batches_equal(got, want, n):
    assert len(got) == len(want) == n
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_expand_shards_and_crop_windows_equal_jax(shards):
    from vision_transformers_torch_xla_tpu.data import wds as jax_wds

    for spec in (shards, shards.replace("{0000..0003}", "*"),
                 "/x/train-{07..11}.tar", "/no/such/file.tar"):
        assert wds.expand_shards(spec) == jax_wds.expand_shards(spec)
    assert len(wds.expand_shards(shards)) == N_SHARDS
    got_rng, want_rng = (np.random.default_rng(4) for _ in range(2))
    for w, h in np.random.default_rng(1).integers(1, 600, (200, 2)):
        got = wds._sample_inception_crop(got_rng, int(w), int(h))
        assert got == jax_wds._sample_inception_crop(want_rng, int(w),
                                                      int(h))
        x0, y0, cw, ch = got
        assert 0 <= x0 and x0 + cw <= w and 0 <= y0 and y0 + ch <= h
        for out in (32, 224):
            assert wds.central_crop_window(int(w), int(h), out) == \
                jax_wds._central_crop_window(int(w), int(h), out)


@pytest.mark.parametrize("process", [(0, 1), (1, 2)], ids=["p0of1", "p1of2"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("path", ["native", "pil"])
def test_wds_batches_equal_jax_bit_for_bit(shards, monkeypatch, path,
                                           is_train, process):
    """Two epochs (the second reshuffles the shards and redraws the crops)
    of the port's WdsDataset against JAX's on the same shards and seed."""
    from vision_transformers_torch_xla_tpu.data import native as jax_native
    from vision_transformers_torch_xla_tpu.data.wds import (
        WdsDataset as JaxWdsDataset,
    )

    if path == "native":
        assert native.available() and jax_native.available()
    else:
        _use_pil(monkeypatch)
    index, count = process
    _jax_process(monkeypatch, index, count)
    batch = 4 if is_train else 6
    kw = dict(batch_size=batch, image_size=32, is_train=is_train, seed=7,
              num_classes=CLASSES)
    got = wds.WdsDataset(shards, **kw, process_index=index,
                         process_count=count)
    want = JaxWdsDataset(shards, **kw)
    assert got.shards == want.shards and len(got.shards) == N_SHARDS // count
    assert dataclasses.asdict(got.info) == {
        "num_examples": N_SHARDS * PER_SHARD, "num_classes": CLASSES}
    assert got.info.num_examples == want.info.num_examples
    epochs = []
    for _ in range(2):
        g, w = list(got), list(want)
        _assert_batches_equal(g, w, N_SHARDS * PER_SHARD // count // batch)
        epochs.append(np.concatenate([x for x, _ in g]))
    if is_train:   # the second epoch redraws the shard order and crops
        assert not np.array_equal(epochs[0], epochs[1])
    else:
        np.testing.assert_array_equal(epochs[0], epochs[1])


CORRUPT = b"\xff\xd8corrupt-body"


@pytest.fixture
def bad_shard(shards, tmp_path):
    """Shard 0 with a sample appended whose JPEG body does not decode."""
    bad = tmp_path / "bad-0000.tar"
    with tarfile.open(wds.expand_shards(shards)[0]) as tin, \
            tarfile.open(bad, "w") as tout:
        for m in tin:
            tout.addfile(m, tin.extractfile(m))
        for name, data in (("zzz_corrupt.jpg", CORRUPT),
                           ("zzz_corrupt.cls", b"4")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tout.addfile(info, io.BytesIO(data))
    return str(bad)


@pytest.mark.parametrize("path", ["native", "pil"])
def test_wds_corrupt_bodies_as_jax(bad_shard, monkeypatch, path):
    """Native: a JPEG whose header parses but whose body fails is dropped
    and its slot refilled from the stream, in both packages, with equal
    batches. PIL: both raise PIL's error on it (the JAX source catches
    nothing there)."""
    from PIL import UnidentifiedImageError

    from vision_transformers_torch_xla_tpu.data import native as jax_native
    from vision_transformers_torch_xla_tpu.data.wds import (
        WdsDataset as JaxWdsDataset,
    )

    kw = dict(batch_size=3, image_size=32, is_train=False,
              num_classes=CLASSES, num_examples=PER_SHARD + 1)
    if path == "pil":
        _use_pil(monkeypatch)
        for ds in (wds.WdsDataset(bad_shard, **kw), JaxWdsDataset(bad_shard,
                                                                  **kw)):
            with pytest.raises(UnidentifiedImageError):
                list(ds)
        return
    # the header peek passes, so the pooled decode meets the body
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "jpeg_dims", lambda d, real=mod.jpeg_dims:
                            (40, 52) if d == CORRUPT else real(d))
    got = list(wds.WdsDataset(bad_shard, **kw))
    want = list(JaxWdsDataset(bad_shard, **kw))
    _assert_batches_equal(got, want, PER_SHARD // 3)
    images = np.concatenate([x for x, _ in got])
    assert (np.abs(images).reshape(len(images), -1).max(1) > 0).all()


def test_decode_pool_equals_the_single_decode(shards):
    with tarfile.open(wds.expand_shards(shards)[1]) as tar:
        jpegs = [tar.extractfile(m).read() for m in tar
                 if m.name.endswith((".jpg", ".jpeg"))]
    crops = [None, (3, 5, 40, 30), (0, 0, 64, 64)]
    out = np.zeros((len(crops) + 1, 24, 24, 3), np.float32)
    pool = native.DecodePool(num_threads=2)
    try:
        for i, crop in enumerate(crops):
            pool.submit(jpegs[i], out[i], 24, crop=crop, tag=i)
        pool.submit(CORRUPT, out[-1], 24, tag=len(crops))
        pool.wait()
        assert pool.take_failed() == [len(crops)]
        assert pool.take_failed() == []
        with pytest.raises(ValueError, match="C-contiguous float32"):
            pool.submit(jpegs[0], out[0, :, ::2], 24)
    finally:
        pool.close()
    pool.close()   # a second close is a no-op
    for i, crop in enumerate(crops):
        np.testing.assert_array_equal(
            out[i], native.decode_jpeg_crop_resize(jpegs[i], 24, crop=crop))
    assert not out[-1].any()


def test_decode_pool_raises_without_the_library(shards, monkeypatch):
    """No silent stand-in: without libvtx_io.so the pool raises, and
    WdsDataset takes JAX's PIL path instead of the pool."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="make -C native"):
        native.DecodePool()
    monkeypatch.setattr(native, "DecodePool", None)  # never reached
    batches = list(wds.WdsDataset(shards, 6, 32, is_train=False))
    assert len(batches) == N_SHARDS


@pytest.mark.parametrize("data_set", ["wds", "IMNET_WDS"])
def test_build_dataset_wds_matches_jax(shards, tmp_path, monkeypatch,
                                       data_set):
    """--data_set wds / IMNET_WDS: train from --data_path, eval from
    --eval_data_path, both as the JAX build_dataset reads them, process 1
    of 2; an unknown data set raises in both."""
    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )

    _jax_process(monkeypatch, 1, 2)
    val = write_shards(tmp_path, n_shards=2, per_shard=4, seed=1)
    kw = dict(data_set=data_set, data_path=shards, eval_data_path=val,
              batch_size=2, input_size=24, seed=5, nb_classes=CLASSES)
    for is_train, n_batches in ((True, 6), (False, 1)):
        ds, info = loader.build_dataset(TrainConfig(**kw), is_train, 1, 2)
        jds, jinfo = jax_build_dataset(JaxTrainConfig(**kw), is_train)
        assert dataclasses.asdict(info) == dataclasses.asdict(jinfo)
        _assert_batches_equal(list(ds), list(jds), n_batches)
    assert info.num_examples == 8 and ds.batch_size == 3   # eval: 2 x 1.5
    for build, cfg in ((loader.build_dataset, TrainConfig),
                       (jax_build_dataset, JaxTrainConfig)):
        with pytest.raises(ValueError, match="unknown data_set 'bogus'"):
            build(cfg(data_set="bogus"), True)


def test_main_trains_on_wds_shards_on_the_cpu(shards, capsys):
    """main() --data_set wds: 2 steps of test_vit and 1 eval batch, its
    first train batch JAX build_dataset's."""
    from vision_transformers_torch_xla_tpu.core.config import (
        config_from_args as jax_config_from_args,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    argv = ["--data_set", "wds", "--data_path", shards, "--model", "test_vit",
            "--input_size", "32", "--nb_classes", str(CLASSES),
            "--batch_size", "4", "--epochs", "1", "--limit_steps_per_epoch",
            "2", "--limit_eval_batches", "1", "--warmup_epochs", "0",
            "--log_freq", "1"]
    cfg = config_from_args(argv + ["--device", "cpu"])
    ctx = trainer.setup(cfg)
    jds, _ = jax_build_dataset(jax_config_from_args(argv), True)
    _assert_batches_equal([next(iter(ctx.train_ds))], [next(iter(jds))], 1)
    stats = trainer.main(cfg)
    assert stats["count"] == 6.0   # one eval batch of 4 x 1.5
    assert all(np.isfinite(v) for v in stats.values())
    assert "epoch 0 [1/2] loss" in capsys.readouterr().out
