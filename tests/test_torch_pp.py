"""The port's pp language (data/pp_builder.py), its ops (data/pp_ops.py)
and RandAugment on tf.data (data/randaug_tf.py) against the JAX
package's, on the same encoded JPEGs.

Both packages build the same TensorFlow ops in the same order, so the
deterministic ops, the whole DEFAULT_PP_EVAL chain and the 15 RandAugment
ops at a fixed level and sign agree bit for bit. The random ops
(decode_jpeg_and_inception_crop, flip_lr, rand_augment_tf) draw from
TensorFlow's unseeded random ops; under one `tf.random.set_seed` both
packages build the same op sequence, so their draws, and their outputs,
are equal too: eagerly, and inside a tf.data map with one parallel call.
All but one: `tf.image.sample_distorted_bounding_box` (the inception
crop's box) takes op seed 0 when none is passed, and then ignores the
global seed. So the crop's test passes that op one fixed seed in both
packages: it holds the crop for the same drawn box, and the box's draw is
TensorFlow's own op.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from vision_transformers_torch_xla_tpu_torch.data import (  # noqa: E402
    loader,
    pp_builder,
    pp_ops,
    randaug_tf,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(seed: int, h: int = 72, w: int = 90) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(grid).resize((w, h)), np.int16)
    img += rng.integers(-6, 7, img.shape, dtype=np.int16)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _features(data: bytes):
    return {"image": tf.constant(data), "label": tf.constant(3, tf.int64),
            "extra": tf.constant(1.5)}


def _run(fn, data: bytes):
    return {k: np.asarray(v) for k, v in fn(_features(data)).items()}


def _assert_features_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pp_language_equals_jax():
    from vision_transformers_torch_xla_tpu.data import pp_builder as jax_pp

    assert pp_builder.list_pp_ops() == jax_pp.list_pp_ops()
    assert "randaug" in pp_builder.list_pp_ops()
    for spec in ("decode", " flip_lr ", "resize_small(256)",
                 'keep("image", "label")', "value_range(0, 1)",
                 "value_range(vmin=-1, vmax=1, clip_values=True)",
                 "normalize((0.5, 0.5, 0.5), std=[0.2, 0.2, 0.2])",
                 "randaug(2, 9, mstd=0.5)"):
        assert pp_builder._parse_call(spec) == jax_pp._parse_call(spec)
    for bad in ("", "  ", "a.b(1)", "(1)"):
        with pytest.raises(ValueError) as got:
            pp_builder._parse_call(bad)
        with pytest.raises(ValueError) as want:
            jax_pp._parse_call(bad)
        assert str(got.value) == str(want.value)
    spec = 'decode|resize_small(40)|bogus_op(3)|keep("image")'
    with pytest.raises(ValueError, match="unknown pp op 'bogus_op'") as got:
        pp_builder.get_preprocess_fn(spec)
    with pytest.raises(ValueError) as want:
        jax_pp.get_preprocess_fn(spec)
    assert str(got.value) == str(want.value)
    fn = pp_builder.get_preprocess_fn("decode||flip_lr", log_name="train")
    assert fn.__name__ == jax_pp.get_preprocess_fn(
        "decode||flip_lr", log_name="train").__name__ == "pp(train)"


DETERMINISTIC = [
    "decode", "decode(1)", "decode|resize_small(40)",
    'decode|resize_small(40, method="bilinear")',
    "decode|resize_small(300)|central_crop(224)", "decode|central_crop(48)",
    "decode|value_range(0, 1)", "decode|value_range()",
    "decode|value_range(-2, 2, clip_values=True)",
    'decode|keep("image", "label")', "decode|normalize",
    "decode|normalize((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))",
    loader.DEFAULT_PP_EVAL]


@pytest.mark.parametrize("spec", DETERMINISTIC)
def test_deterministic_ops_equal_jax_bit_for_bit(spec):
    from vision_transformers_torch_xla_tpu.data import loader as jax_loader
    from vision_transformers_torch_xla_tpu.data.pp_builder import (
        get_preprocess_fn as jax_pp_fn,
    )

    assert loader.DEFAULT_PP_EVAL == jax_loader.DEFAULT_PP_EVAL
    assert loader.DEFAULT_PP_TRAIN == jax_loader.DEFAULT_PP_TRAIN
    for seed, (h, w) in enumerate(((72, 90), (96, 64))):
        data = _jpeg(seed, h, w)
        got = _run(pp_builder.get_preprocess_fn(spec), data)
        _assert_features_equal(got, _run(jax_pp_fn(spec), data))
    if spec == loader.DEFAULT_PP_EVAL:
        assert got["image"].shape == (224, 224, 3) and sorted(got) == [
            "image", "label"]


LEVELS = ((9.0, 1.0), (3.5, -1.0), (10.0, -1.0), (0.0, 1.0))


@pytest.mark.parametrize("level,sign", LEVELS)
def test_the_15_randaug_ops_equal_jax_bit_for_bit(level, sign):
    from vision_transformers_torch_xla_tpu.data.randaug_tf import (
        RA_OPS as JAX_RA_OPS,
    )

    assert [n for n, _ in randaug_tf.RA_OPS] == [n for n, _ in JAX_RA_OPS]
    assert len(randaug_tf.RA_OPS) == 15
    img = tf.constant(np.random.default_rng(0).integers(
        0, 256, (32, 40, 3)).astype(np.float32))
    flat = tf.constant(np.full((16, 24, 3), 77.0, np.float32))
    for (name, fn), (_, jax_fn) in zip(randaug_tf.RA_OPS, JAX_RA_OPS):
        for x in (img, flat):
            got = np.asarray(fn(x, tf.constant(level), tf.constant(sign)))
            want = np.asarray(jax_fn(x, tf.constant(level),
                                     tf.constant(sign)))
            assert got.dtype == want.dtype == np.float32, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert got.min() >= 0.0 and got.max() <= 255.0, name


RANDOM = [loader.DEFAULT_PP_TRAIN,
          "decode_jpeg_and_inception_crop(40, area_min=30, method=\"area\")"
          "|flip_lr",
          "decode|randaug(2, 9, mstd=0.5)|value_range(0, 1)"]


@pytest.mark.parametrize("spec", RANDOM)
def test_random_ops_equal_jax_under_one_tf_seed(spec, monkeypatch):
    """Eagerly: each call after tf.random.set_seed(s) draws what the JAX
    package's call draws after the same seed; and in a tf.data map with
    num_parallel_calls=1, the whole stream of both packages is equal (but
    for RandAugment, whose 15-branch switch takes ~4 s a package to trace;
    the eager calls run the same function)."""
    from vision_transformers_torch_xla_tpu.data.pp_builder import (
        get_preprocess_fn as jax_pp_fn,
    )

    box = tf.image.sample_distorted_bounding_box
    monkeypatch.setattr(tf.image, "sample_distorted_bounding_box",
                        lambda *a, **kw: box(*a, seed=1234, **kw))

    images = [_jpeg(seed, *hw) for seed, hw in enumerate(
        ((72, 90), (96, 64), (80, 80), (64, 96)))]
    outs = []
    for seed in (0, 1):
        for data in images[:2]:
            tf.random.set_seed(seed)
            got = _run(pp_builder.get_preprocess_fn(spec), data)
            tf.random.set_seed(seed)
            _assert_features_equal(got, _run(jax_pp_fn(spec), data))
            outs.append(got["image"])
    # the draws are draws: the two seeds give two outputs
    assert not all(np.array_equal(a, b) for a, b in zip(outs[:2], outs[2:]))

    def stream(make_fn):
        tf.random.set_seed(11)
        ds = tf.data.Dataset.from_tensor_slices(
            {"image": images, "label": list(range(4))}).repeat(3)
        ds = ds.map(make_fn(spec), num_parallel_calls=1)
        return [b["image"] for b in ds.as_numpy_iterator()]

    if "randaug" in spec:
        return
    got, want = stream(pp_builder.get_preprocess_fn), stream(jax_pp_fn)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rand_augment_tf_equals_jax_under_one_tf_seed():
    from vision_transformers_torch_xla_tpu.data.randaug_tf import (
        rand_augment_tf as jax_rand_augment_tf,
    )

    img = tf.constant(np.random.default_rng(2).integers(
        0, 256, (24, 28, 3)).astype(np.uint8))
    for seed in range(6):
        kw = dict(num_layers=2, magnitude=9.0, mstd=0.5, prob=0.5 + seed / 12)
        tf.random.set_seed(seed)
        got = np.asarray(randaug_tf.rand_augment_tf(img, **kw))
        tf.random.set_seed(seed)
        want = np.asarray(jax_rand_augment_tf(img, **kw))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_tensorflow_hides_every_gpu_from_its_runtime(monkeypatch):
    """Where TensorFlow sees a GPU, the port hides it from TensorFlow's
    runtime before it builds an op: the card is torch's."""
    visible, calls = ["GPU:0"], []

    def set_visible(devices, device_type=None):
        calls.append((list(devices), device_type))
        visible.clear()

    monkeypatch.setattr(tf.config, "get_visible_devices",
                        lambda device_type=None: list(visible))
    monkeypatch.setattr(tf.config, "set_visible_devices", set_visible)
    assert pp_ops.tensorflow() is tf
    assert pp_ops.tensorflow() is tf
    assert calls == [([], "GPU")]


def test_the_tf_sources_need_tensorflow_and_name_it(monkeypatch, tmp_path):
    """Without TensorFlow the port imports and its tf.data sources raise
    ImportError naming it; without tensorflow_datasets, tfds raises naming
    that. In a fresh process, so that nothing has imported either."""
    code = """if True:
        import sys
        sys.modules["tensorflow"] = None
        sys.modules["tensorflow_datasets"] = None
        import vision_transformers_torch_xla_tpu_torch.launch.main
        from vision_transformers_torch_xla_tpu_torch.core.config import (
            TrainConfig)
        from vision_transformers_torch_xla_tpu_torch.data import (
            loader, pp_builder, pp_ops, randaug_tf, tfrecord, wds)
        assert "randaug" in pp_builder.list_pp_ops()
        assert tfrecord.load_metadata("/no/such/train-*.tfrecord") is None
        for data_set in ("tfrecord", "tfds"):
            try:
                loader.build_dataset(TrainConfig(
                    data_set=data_set, data_path="/x/train-*.tfrecord"), True)
            except ImportError as e:
                print(data_set, "raised:", e)
            else:
                raise SystemExit(data_set + " did not raise")
    """
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "tfrecord raised: the tf.data input pipeline (--data_set " \
        "tfrecord or tfds) needs tensorflow" in out.stdout
    assert "tfds raised:" in out.stdout and "tensorflow" in out.stdout
    # TensorFlow here, tensorflow_datasets missing: tfds names it
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", None)
    from vision_transformers_torch_xla_tpu_torch.core.config import TrainConfig

    with pytest.raises(ImportError, match="needs tensorflow_datasets"):
        loader.build_dataset(TrainConfig(data_set="tfds"), True)
