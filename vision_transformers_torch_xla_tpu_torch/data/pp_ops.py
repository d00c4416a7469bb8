"""The preprocessing ops of the pp language, on tf.data.

Counterpart of vision_transformers_torch_xla_tpu/data/pp_ops.py: decode,
decode_jpeg_and_inception_crop, flip_lr, resize_small, central_crop,
value_range, keep, normalize and randaug (data/randaug_tf.py), the same
TensorFlow ops in the same order, registered in the port's
data/pp_builder.py. They run inside a tf.data map on the host's CPU.

TensorFlow is imported only when an op is built (`tensorflow()`), so the
port imports and trains on the other data sets without it; a missing
TensorFlow raises ImportError naming it. Where TensorFlow sees a GPU,
`tensorflow()` hides it from TensorFlow's runtime first: the card is
torch's, and a TensorFlow runtime on it would reserve most of its memory.
"""
from __future__ import annotations

from vision_transformers_torch_xla_tpu_torch.data.pp_builder import (
    register_pp_op,
)


def tensorflow():
    """The tensorflow module, with every GPU hidden from its runtime."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(f"the tf.data input pipeline (--data_set tfrecord "
                          f"or tfds) needs tensorflow: {e}") from e
    if tf.config.get_visible_devices("GPU"):
        tf.config.set_visible_devices([], "GPU")
    return tf


@register_pp_op()
def decode(channels: int = 3):
    """Decode encoded image bytes -> uint8 HWC tensor."""
    tf = tensorflow()

    def _decode(features):
        features["image"] = tf.io.decode_image(
            features["image"], channels=channels, expand_animations=False)
        return features

    return _decode


@register_pp_op()
def decode_jpeg_and_inception_crop(size: int, area_min: int = 5,
                                   area_max: int = 100,
                                   method: str = "bilinear"):
    """Fused JPEG decode + RandomResizedCrop (inception crop): a distorted
    box of area_min-area_max % of the image and aspect 3/4-4/3, only that
    window decoded, then resized to (size, size)."""
    tf = tensorflow()

    def _crop(features):
        data = features["image"]
        shape = tf.image.extract_jpeg_shape(data)
        begin, crop_size, _ = tf.image.sample_distorted_bounding_box(
            shape,
            tf.zeros([0, 0, 4], tf.float32),
            area_range=(area_min / 100, area_max / 100),
            min_object_covered=0,
            use_image_if_no_bounding_boxes=True)
        top, left, _ = tf.unstack(begin)
        h, w, _ = tf.unstack(crop_size)
        image = tf.image.decode_and_crop_jpeg(
            data, tf.stack([top, left, h, w]), channels=3)
        image = tf.image.resize(image, (size, size), method=method)
        features["image"] = tf.cast(image, tf.uint8) \
            if image.dtype != tf.uint8 else image
        return features

    return _crop


@register_pp_op()
def flip_lr():
    """Random horizontal flip."""
    tf = tensorflow()

    def _flip(features):
        features["image"] = tf.image.random_flip_left_right(features["image"])
        return features

    return _flip


@register_pp_op()
def resize_small(smaller_size: int, method: str = "area"):
    """Resize so the shorter side equals smaller_size, keeping the aspect."""
    tf = tensorflow()

    def _resize(features):
        image = features["image"]
        h = tf.cast(tf.shape(image)[0], tf.float32)
        w = tf.cast(tf.shape(image)[1], tf.float32)
        ratio = smaller_size / tf.minimum(h, w)
        new_h = tf.cast(tf.round(h * ratio), tf.int32)
        new_w = tf.cast(tf.round(w * ratio), tf.int32)
        image = tf.image.resize(image, (new_h, new_w), method=method)
        features["image"] = tf.cast(image, tf.uint8)
        return features

    return _resize


@register_pp_op()
def central_crop(size: int):
    """Crop the central (size, size) window."""
    tf = tensorflow()

    def _crop(features):
        image = features["image"]
        h = tf.shape(image)[0]
        w = tf.shape(image)[1]
        top = (h - size) // 2
        left = (w - size) // 2
        features["image"] = tf.image.crop_to_bounding_box(image, top, left,
                                                          size, size)
        return features

    return _crop


@register_pp_op()
def value_range(vmin: float = -1.0, vmax: float = 1.0, in_min: float = 0.0,
                in_max: float = 255.0, clip_values: bool = False):
    """Map pixel values from [in_min, in_max] to [vmin, vmax], affinely."""
    tf = tensorflow()

    def _vr(features):
        image = tf.cast(features["image"], tf.float32)
        image = (image - in_min) / (in_max - in_min)
        image = vmin + image * (vmax - vmin)
        if clip_values:
            image = tf.clip_by_value(image, vmin, vmax)
        features["image"] = image
        return features

    return _vr


@register_pp_op()
def keep(*keys: str):
    """Drop every feature but `keys`."""

    def _keep(features):
        return {k: v for k, v in features.items() if k in keys}

    return _keep


@register_pp_op()
def normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    """(image - mean) / std inside the tf.data graph."""
    tf = tensorflow()

    def _norm(features):
        image = tf.cast(features["image"], tf.float32)
        features["image"] = (image - tf.constant(mean)) / tf.constant(std)
        return features

    return _norm


@register_pp_op()
def randaug(num_layers: int = 2, magnitude: float = 9, mstd: float = 0.5,
            prob: float = 0.5):
    """RandAugment, timm's 15-op increasing policy (data/randaug_tf.py)."""
    from vision_transformers_torch_xla_tpu_torch.data.randaug_tf import (
        rand_augment_tf,
    )

    def _ra(features):
        features["image"] = rand_augment_tf(
            features["image"], num_layers=num_layers, magnitude=magnitude,
            mstd=mstd, prob=prob)
        return features

    return _ra
