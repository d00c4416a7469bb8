"""timm's RandAugment on the tf.data path.

Counterpart of vision_transformers_torch_xla_tpu/data/randaug_tf.py: the
15 ops of timm's increasing set (`RA_OPS`, in timm's
_RAND_INCREASING_TRANSFORMS order: AutoContrast, Equalize, Invert, Rotate,
Posterize, Solarize, SolarizeAdd, Color, Contrast, Brightness, Sharpness,
ShearX, ShearY, TranslateXRel, TranslateYRel) and `rand_augment_tf`, the
same TensorFlow ops in the same order.

Magnitude M lives on timm's 0..10 scale (LEVEL_DENOM): for each layer the
level is drawn from N(M, mstd) and clipped to [0, 10], the op is applied
with probability `prob`, and signed ops flip direction with probability
1/2. Geometric ops fill with timm's 128 gray.

The ops take and return float32 HWC in [0, 255] inside the tf graph; the
public entry takes uint8 and returns uint8. The draws are TensorFlow's
unseeded random ops, as in the JAX module.
"""
from __future__ import annotations

from vision_transformers_torch_xla_tpu_torch.data.pp_ops import tensorflow

LEVEL_DENOM = 10.0
FILL = 128.0


# ---------------------------------------------------------------------------
# geometry: output->input affine maps via ImageProjectiveTransformV3
# (the PIL Image.transform(AFFINE, (a,b,c,d,e,f)) convention timm uses)
# ---------------------------------------------------------------------------

def _affine(image, a, b, c, d, e, f):
    tf = tensorflow()
    t = tf.cast(tf.stack([a, b, c, d, e, f, 0.0, 0.0]), tf.float32)
    out = tf.raw_ops.ImageProjectiveTransformV3(
        images=image[None], transforms=t[None],
        output_shape=tf.shape(image)[:2], fill_value=FILL,
        interpolation="BILINEAR", fill_mode="CONSTANT")
    return out[0]


def rotate(image, level, sign):
    """PIL rotate about center; degrees = level/10 * 30 (timm _rotate_level_to_arg)."""
    tf = tensorflow()
    radians = sign * level / LEVEL_DENOM * 30.0 * 3.14159265 / 180.0
    ct, st = tf.cos(radians), tf.sin(radians)
    shape = tf.cast(tf.shape(image), tf.float32)
    cy, cx = shape[0] / 2, shape[1] / 2
    return _affine(image, ct, -st, cx - ct * cx + st * cy,
                   st, ct, cy - st * cx - ct * cy)


def shear_x(image, level, sign):
    """shear = level/10 * 0.3 (timm _shear_level_to_arg)."""
    s = sign * level / LEVEL_DENOM * 0.3
    return _affine(image, 1.0, s, 0.0, 0.0, 1.0, 0.0)


def shear_y(image, level, sign):
    s = sign * level / LEVEL_DENOM * 0.3
    return _affine(image, 1.0, 0.0, 0.0, s, 1.0, 0.0)


def translate_x_rel(image, level, sign):
    """pixels = level/10 * 0.45 * width (timm _translate_rel_level_to_arg)."""
    tf = tensorflow()
    px = sign * level / LEVEL_DENOM * 0.45 * tf.cast(tf.shape(image)[1], tf.float32)
    return _affine(image, 1.0, 0.0, px, 0.0, 1.0, 0.0)


def translate_y_rel(image, level, sign):
    tf = tensorflow()
    px = sign * level / LEVEL_DENOM * 0.45 * tf.cast(tf.shape(image)[0], tf.float32)
    return _affine(image, 1.0, 0.0, 0.0, 0.0, 1.0, px)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

def _blend(degenerate, image, factor):
    tf = tensorflow()
    return tf.clip_by_value(
        degenerate + factor * (image - degenerate), 0.0, 255.0)


def _enhance_factor(level, sign):
    """timm _enhance_increasing_level_to_arg: 1 +- level/10 * 0.9."""
    return 1.0 + sign * level / LEVEL_DENOM * 0.9


def brightness(image, level, sign):
    tf = tensorflow()
    return _blend(tf.zeros_like(image), image, _enhance_factor(level, sign))


def _grayscale(image):
    tf = tensorflow()
    g = (0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2])
    return tf.round(g)


def contrast(image, level, sign):
    """PIL Contrast: blend against the mean of the grayscale image."""
    tf = tensorflow()
    mean = tf.reduce_mean(_grayscale(image))
    return _blend(tf.fill(tf.shape(image), mean), image,
                  _enhance_factor(level, sign))


def color(image, level, sign):
    """PIL Color (saturation): blend against grayscale."""
    tf = tensorflow()
    gray = tf.tile(_grayscale(image)[..., None], [1, 1, 3])
    return _blend(gray, image, _enhance_factor(level, sign))


def sharpness(image, level, sign):
    """PIL Sharpness: blend against SMOOTH-filtered image (3x3/13 kernel,
    borders untouched)."""
    tf = tensorflow()
    kernel = tf.constant([[1, 1, 1], [1, 5, 1], [1, 1, 1]], tf.float32) / 13.0
    kernel = tf.tile(kernel[:, :, None, None], [1, 1, 3, 1])
    smooth = tf.nn.depthwise_conv2d(image[None], kernel, [1, 1, 1, 1], "VALID")[0]
    smooth = tf.clip_by_value(smooth, 0.0, 255.0)
    smooth = tf.pad(smooth, [[1, 1], [1, 1], [0, 0]])
    mask = tf.pad(tf.ones_like(smooth[1:-1, 1:-1]), [[1, 1], [1, 1], [0, 0]])
    degenerate = tf.where(mask > 0, smooth, image)
    return _blend(degenerate, image, _enhance_factor(level, sign))


def posterize(image, level, sign):
    """PosterizeIncreasing: keep 4 - int(level/10 * 4) bits (min 1)."""
    tf = tensorflow()
    bits = 4 - tf.cast(level / LEVEL_DENOM * 4.0, tf.int32)
    shift = 8 - tf.maximum(bits, 1)
    q = tf.bitwise.right_shift(tf.cast(image, tf.uint8), tf.cast(shift, tf.uint8))
    return tf.cast(tf.bitwise.left_shift(q, tf.cast(shift, tf.uint8)), tf.float32)


def solarize(image, level, sign):
    """SolarizeIncreasing: invert pixels >= 256 - int(level/10 * 256)."""
    tf = tensorflow()
    thresh = 256.0 - tf.round(level / LEVEL_DENOM * 256.0)
    return tf.where(image < thresh, image, 255.0 - image)


def solarize_add(image, level, sign):
    """SolarizeAdd: add int(level/10 * 110) to pixels < 128."""
    tf = tensorflow()
    add = tf.round(level / LEVEL_DENOM * 110.0)
    return tf.where(image < 128.0,
                    tf.clip_by_value(image + add, 0.0, 255.0), image)


def invert(image, level, sign):
    return 255.0 - image


def autocontrast(image, level, sign):
    """PIL autocontrast per channel: stretch [min, max] to [0, 255]."""
    tf = tensorflow()

    def ch(c):
        lo = tf.reduce_min(c)
        hi = tf.reduce_max(c)
        scale = 255.0 / tf.maximum(hi - lo, 1e-6)
        return tf.where(hi > lo, tf.clip_by_value((c - lo) * scale, 0.0, 255.0), c)

    return tf.stack([ch(image[..., i]) for i in range(3)], axis=-1)


def equalize(image, level, sign):
    """PIL ImageOps.equalize per channel (histogram lut)."""
    tf = tensorflow()

    def ch(c):
        ci = tf.cast(c, tf.int32)
        histo = tf.histogram_fixed_width(ci, [0, 255], nbins=256)
        nonzero = tf.boolean_mask(histo, tf.not_equal(histo, 0))
        step = (tf.reduce_sum(histo) - nonzero[-1]) // 255

        def lut():
            l = (tf.cumsum(histo) + (step // 2)) // tf.maximum(step, 1)
            l = tf.concat([[0], l[:-1]], 0)
            return tf.clip_by_value(l, 0, 255)

        return tf.cond(tf.equal(step, 0), lambda: ci,
                       lambda: tf.gather(lut(), ci))

    return tf.cast(tf.stack([ch(image[..., i]) for i in range(3)], -1),
                   tf.float32)


# timm _RAND_INCREASING_TRANSFORMS order (auto_augment.py)
RA_OPS = (
    ("AutoContrast", autocontrast),
    ("Equalize", equalize),
    ("Invert", invert),
    ("Rotate", rotate),
    ("Posterize", posterize),
    ("Solarize", solarize),
    ("SolarizeAdd", solarize_add),
    ("Color", color),
    ("Contrast", contrast),
    ("Brightness", brightness),
    ("Sharpness", sharpness),
    ("ShearX", shear_x),
    ("ShearY", shear_y),
    ("TranslateXRel", translate_x_rel),
    ("TranslateYRel", translate_y_rel),
)


def rand_augment_tf(image, num_layers: int = 2, magnitude: float = 9.0,
                    mstd: float = 0.5, prob: float = 0.5):
    """Apply the RandAugment policy to one uint8 HWC image (tf graph)."""
    tf = tensorflow()
    img = tf.cast(image, tf.float32)
    for _ in range(num_layers):
        op_idx = tf.random.uniform((), 0, len(RA_OPS), tf.int32)
        level = tf.clip_by_value(
            tf.random.normal((), magnitude, mstd), 0.0, LEVEL_DENOM)
        sign = tf.where(tf.random.uniform(()) < 0.5, -1.0, 1.0)
        apply = tf.random.uniform(()) < prob

        def run(im, idx=op_idx, lv=level, sg=sign):
            return tf.switch_case(idx, [
                (lambda f=f: f(im, lv, sg)) for _, f in RA_OPS])

        img = tf.cond(apply, lambda im=img: run(im), lambda im=img: im)
    return tf.saturate_cast(tf.round(img), tf.uint8)
