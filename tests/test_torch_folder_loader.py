"""The port's folder source (data/loader.py::FolderDataset) against the JAX
package's, on a tree of JPEGs and PNGs that the test writes itself.

PIL decodes, crops and resizes, and numpy's default_rng(seed) draws the
order and the crops, in both packages: so the same tree and seed give the
same batches bit for bit, train and eval, under every normalization the
trainer asks for (ImageNet's, inception's, and the raw [0, 1] pixels of
--device_augment).
"""
import dataclasses

import numpy as np
import pytest

from vision_transformers_torch_xla_tpu_torch.core.config import TrainConfig
from vision_transformers_torch_xla_tpu_torch.data import loader

CLASSES = ("cat", "dog", "eel")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 classes x 5 images of 80-100 px (one PNG a class) and a file that
    is not an image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for cls in CLASSES:
        d = root / cls
        d.mkdir()
        for i in range(5):
            h, w = rng.integers(80, 101, 2)
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / (f"{i}.png" if i == 4 else
                                           f"{i}.jpg"))
        (d / "notes.txt").write_text("not an image")
    return str(root)


STATS = {"imagenet": loader.norm_constants(TrainConfig()),
         "inception": loader.norm_constants(
             TrainConfig(imagenet_default_mean_and_std=False)),
         "raw": loader.norm_constants(TrainConfig(device_augment=True))}


@pytest.mark.parametrize("stats", list(STATS))
@pytest.mark.parametrize("is_train", [True, False])
def test_folder_batches_equal_jax_bit_for_bit(tree, is_train, stats):
    from vision_transformers_torch_xla_tpu.data.loader import (
        FolderDataset as JaxFolderDataset,
    )

    mean, std = STATS[stats]
    kw = dict(batch_size=4, image_size=32, is_train=is_train, seed=3,
              mean=mean, std=std)
    got = list(loader.FolderDataset(tree, **kw))
    want = list(JaxFolderDataset(tree, **kw))
    assert len(got) == len(want) == 15 // 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32 and gx.shape == (4, 32, 32,
                                                                   3)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gy.dtype == wy.dtype
    if stats == "raw":
        assert min(x.min() for x, _ in got) >= 0.0
        assert max(x.max() for x, _ in got) <= 1.0


def test_folder_info_and_samples_match_jax(tree):
    from vision_transformers_torch_xla_tpu.data.loader import (
        FolderDataset as JaxFolderDataset,
    )

    got = loader.FolderDataset(tree, 6, 32, is_train=False)
    want = JaxFolderDataset(tree, 6, 32, is_train=False)
    assert dataclasses.asdict(got.info) == {"num_examples": 15,
                                            "num_classes": 3}
    assert got.info.num_examples == want.info.num_examples
    assert got.class_to_idx == want.class_to_idx
    assert got.samples == want.samples
    labels = np.concatenate([y for _, y in got])
    assert labels.tolist() == [0] * 5 + [1] * 5 + [2] * 2   # eval: in order


@pytest.mark.parametrize("device_augment", [False, True])
def test_build_dataset_folder_matches_jax(tree, tmp_path, device_augment):
    """--data_set folder: train from --data_path, eval from
    --eval_data_path, both as the JAX build_dataset reads them."""
    from PIL import Image

    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.data.loader import (
        build_dataset as jax_build_dataset,
    )

    val = tmp_path / "val"
    for cls in CLASSES[:2]:
        (val / cls).mkdir(parents=True)
        for i in range(3):
            arr = np.full((40, 56, 3), 60 * i + 20, np.uint8)
            Image.fromarray(arr).save(val / cls / f"{i}.jpg")
    kw = dict(data_set="folder", data_path=tree, eval_data_path=str(val),
              batch_size=2, input_size=24, seed=5,
              device_augment=device_augment)
    for is_train, n_batches in ((True, 7), (False, 2)):
        ds, info = loader.build_dataset(TrainConfig(**kw), is_train)
        jds, jinfo = jax_build_dataset(JaxTrainConfig(**kw), is_train)
        assert dataclasses.asdict(info) == dataclasses.asdict(jinfo)
        got, want = list(ds), list(jds)
        assert len(got) == len(want) == n_batches
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    assert info.num_classes == 2 and ds.batch_size == 3   # eval: 2 x 1.5
