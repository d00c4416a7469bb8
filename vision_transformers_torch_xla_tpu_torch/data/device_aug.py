"""On-device augmentation: RandomResizedCrop, flip, RandAugment, colour
jitter, normalization and random erasing on the batch's device.

Counterpart of vision_transformers_torch_xla_tpu/data/device_aug.py, with
the same names. The JAX module draws with jax.random inside the jitted
step; here the draws are split from their application, as in
train/mixup.py:

  * `sample_augment` draws every per-image scalar (the crop's area, log
    aspect ratio and x/y fractions, the flip bit, colour jitter's three
    factors, random erasing's gate, area, log aspect ratio and y/x
    fractions) and each RandAugment layer's (op, magnitude) on the host
    from a numpy Generator;
  * `apply_augment` applies them to the NHWC batch on its device. The one
    draw of image size, random erasing's noise, comes from a torch
    Generator on that device, or from the draw, so that a test can pass
    JAX's.

On W data-parallel processes the step draws for the global batch and
each rank applies its rows (`AugDraw.rows`; the erase noise through
core/rng.py::global_rand), as JAX draws for its global array.

Threefry and PCG64 never agree, so the tests feed the JAX draws. The op of
each RandAugment layer is chosen per batch, as in JAX `rand_augment_batch`
(:312-338), so it is Python control flow here, as `lax.switch` is there,
and the step reads nothing back from the device.

The JAX module has no Pallas kernel: its work is XLA's, so here it is
PyTorch ops in fp32. The crop is `jax.image.scale_and_translate(...,
"bilinear")` with its antialiased triangle weights, applied as two batched
products; the batched geometric ops are products with matrices built from
iota, one per batch; the per-image geometric ops sample four corners as
`map_coordinates(order=1, mode="constant")` does; `_equalize` makes one
histogram per image and channel with a single `scatter_add_`; `_sharpness`
blurs with nine shifted sums (zero padding, as `convolve2d(mode="same")`;
a cuDNN convolution could run in TF32, which the port never enables).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vision_transformers_torch_xla_tpu_torch.core.rng import global_rand

_F32 = np.float32
_EPS32 = float(np.finfo(np.float32).eps)


def _on(device: torch.device, arr: np.ndarray) -> torch.Tensor:
    """A small host array on `device`: pinned and non_blocking on the card,
    so the copy never waits for the device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RandomResizedCrop (inception crop: one antialiased bilinear resample)
# ---------------------------------------------------------------------------
def sample_crop(rng: np.random.Generator, b: int,
                area_range=(0.05, 1.0), ratio_range=(3 / 4, 4 / 3)
                ) -> np.ndarray:
    """(B, 4) fp32: area fraction, log aspect ratio, x and y fractions
    (JAX random_resized_crop :35-46)."""
    lo, hi = np.log(_F32(ratio_range[0])), np.log(_F32(ratio_range[1]))
    return np.stack([rng.uniform(area_range[0], area_range[1], b),
                     rng.uniform(lo, hi, b), rng.random(b), rng.random(b)],
                    axis=1).astype(np.float32)


def _crop_scale_translation(crop: np.ndarray, h: int, w: int, out_size: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The per-image (y, x) scale and translation of the crop, in fp32 as
    JAX computes them (:36-48): (B, 2) each."""
    crop = np.asarray(crop, np.float32)
    area = crop[:, 0] * _F32(h * w)
    ratio = np.exp(crop[:, 1])
    cw = np.clip(np.sqrt(area * ratio), _F32(8.0), _F32(w))
    ch = np.clip(np.sqrt(area / ratio), _F32(8.0), _F32(h))
    x0 = crop[:, 2] * (_F32(w) - cw)
    y0 = crop[:, 3] * (_F32(h) - ch)
    out = _F32(out_size)
    scale = np.stack([out / ch, out / cw], axis=1)
    translation = np.stack([-y0 * out / ch, -x0 * out / cw], axis=1)
    return scale, translation


def _scale_weights(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) resampling weights of one axis: jax/_src/image/scale.py
    ::compute_weight_mat with the triangle kernel and antialias on. The
    kernel widens by max(1/scale, 1); each output's weights are divided by
    their sum (zeroed where the sum is below 1000·eps) and zeroed where the
    sample lies outside [−0.5, in − 0.5]."""
    inv = 1.0 / scale                                         # (B,)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = ((_iota(out_size, scale.device) + 0.5) * inv[:, None]
              - (translation * inv)[:, None] - 0.5)           # (B, out)
    x = (sample[:, None, :] - _iota(in_size, scale.device)[None, :, None]
         ).abs() / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def random_resized_crop(images: torch.Tensor, crop: np.ndarray,
                        out_size: int) -> torch.Tensor:
    """(B, H, W, C) float -> (B, out, out, C): each image cropped and
    resized in one resample, as JAX's `jax.image.scale_and_translate`
    (two weight matrices per image, contracted with the image)."""
    b, h, w, _ = images.shape
    scale, translation = _crop_scale_translation(crop, h, w, out_size)
    st = _on(images.device, np.concatenate([scale, translation], axis=1))
    wy = _scale_weights(h, out_size, st[:, 0], st[:, 2])       # (B, H, out)
    wx = _scale_weights(w, out_size, st[:, 1], st[:, 3])       # (B, W, out)
    rows = torch.einsum("bhwc,bho->bowc", images, wy)
    return torch.einsum("bowc,bwp->bopc", rows, wx)


# ---------------------------------------------------------------------------
# RandAugment ops on (B, H, W, C) batches in [0, 1], each image on its own;
# `mag` is the layer's signed magnitude in [-1, 1]. Scalars derived from it
# are fp32, in JAX's order of operations.
# ---------------------------------------------------------------------------
def _affine_sample(imgs: torch.Tensor, mat, offset) -> torch.Tensor:
    """Bilinear resample through a 2x2 matrix + offset about the image
    centre: JAX `_affine_sample` (:57-72), whose `map_coordinates(order=1,
    mode='constant')` zeroes each out-of-range corner on its own."""
    _, h, w, _ = imgs.shape
    dev = imgs.device
    yy, xx = _iota(h, dev)[:, None], _iota(w, dev)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = yy - cy, xx - cx
    (m00, m01), (m10, m11) = [[float(v) for v in row] for row in mat]
    src_y = m00 * ys + m01 * xs + cy + float(offset[0])
    src_x = m10 * ys + m11 * xs + cx + float(offset[1])

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.long()
        return ((index, 1.0 - upper_w), (index + 1, upper_w))

    out = None
    for (iy, wy), (ix, wx) in itertools.product(nodes(src_y), nodes(src_x)):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = imgs[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1), :]
        term = (wy * wx)[..., None] * torch.where(valid[..., None], v, 0.0)
        out = term if out is None else out + term
    return out


def _rotate(imgs, mag):
    a = _F32(mag) * _F32(np.pi) / _F32(6)   # up to 30 deg at magnitude 1
    c, s = np.cos(a), np.sin(a)
    return _affine_sample(imgs, ((c, -s), (s, c)), (0.0, 0.0))


def _shear_x(imgs, mag):
    # src_x = x + 0.3·mag·y
    return _affine_sample(imgs, ((1.0, 0.0), (_F32(mag) * _F32(0.3), 1.0)),
                          (0.0, 0.0))


def _shear_y(imgs, mag):
    # src_y = y + 0.3·mag·x
    return _affine_sample(imgs, ((1.0, _F32(mag) * _F32(0.3)), (0.0, 1.0)),
                          (0.0, 0.0))


def _translate_x(imgs, mag):
    # timm TranslateXRel: pct = level/10 · 0.45
    return _affine_sample(imgs, ((1.0, 0.0), (0.0, 1.0)),
                          (0.0, _F32(mag) * _F32(0.45) * _F32(imgs.shape[2])))


def _translate_y(imgs, mag):
    return _affine_sample(imgs, ((1.0, 0.0), (0.0, 1.0)),
                          (_F32(mag) * _F32(0.45) * _F32(imgs.shape[1]), 0.0))


def _brightness(imgs, mag):
    return torch.clamp(imgs * float(_F32(1.0) + _F32(mag) * _F32(0.9)),
                       0.0, 1.0)


def _contrast(imgs, mag):
    mean = imgs.mean(dim=(1, 2), keepdim=True)
    return torch.clamp((imgs - mean) * float(_F32(1.0) + _F32(mag) * _F32(0.9))
                       + mean, 0.0, 1.0)


def _color(imgs, mag):
    grey = imgs.mean(dim=-1, keepdim=True)
    return torch.clamp(grey + (imgs - grey) * float(
        _F32(1.0) + _F32(mag) * _F32(0.9)), 0.0, 1.0)


def _posterize(imgs, mag):
    # timm PosterizeIncreasing: keep 4 - int(level/10 · 4) high bits
    bits = _F32(4.0) - np.floor(np.abs(_F32(mag)) * _F32(4.0))
    levels = float(max(_F32(2.0) ** bits, _F32(1.0)))
    return torch.floor(imgs * levels) / levels


def _solarize(imgs, mag):
    thresh = float(_F32(1.0) - np.abs(_F32(mag)))
    return torch.where(imgs >= thresh, 1.0 - imgs, imgs)


def _solarize_add(imgs, mag):
    # timm SolarizeAdd: add int(level/10 · 110) below the fixed 128 threshold
    add = float(np.abs(_F32(mag)) * _F32(110.0) / _F32(255.0))
    return torch.where(imgs < 0.5, torch.clamp(imgs + add, 0.0, 1.0), imgs)


def _invert(imgs, mag):
    return 1.0 - imgs


def _autocontrast(imgs, mag):
    lo = imgs.amin(dim=(1, 2), keepdim=True)
    hi = imgs.amax(dim=(1, 2), keepdim=True)
    return (imgs - lo) / torch.clamp(hi - lo, min=float(_F32(1e-5)))


def _equalize(imgs, mag):
    """Histogram equalization of each image and channel, with the LUT of
    JAX `_equalize` (:148-169): step = (Σh − h[255]) // 255,
    lut = (cumsum(h) + step // 2) // step shifted by one bin, identity
    where step is 0. One `scatter_add_` fills the (B·C, 256) histograms."""
    b, h, w, c = imgs.shape
    q = torch.clamp(torch.floor(imgs * 255.0 + 0.5), 0.0, 255.0).long()
    idx = q.permute(0, 3, 1, 2).reshape(b * c, h * w)
    hist = torch.zeros(b * c, 256, dtype=torch.long, device=imgs.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    step = torch.div(hist.sum(1, keepdim=True) - hist[:, 255:],
                     255, rounding_mode="floor")
    lut = torch.div(hist.cumsum(1) + torch.div(step, 2, rounding_mode="floor"),
                    torch.clamp(step, min=1), rounding_mode="floor")
    lut = torch.clamp(F.pad(lut[:, :-1], (1, 0)), 0, 255)
    out = torch.where(step == 0, idx, torch.gather(lut, 1, idx))
    # a divisor on the device: CUDA multiplies by the reciprocal of a host
    # scalar, an ulp away from the division that JAX and the CPU make
    denom = torch.full((), 255.0, dtype=imgs.dtype, device=imgs.device)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(imgs.dtype) / denom


def _sharpness(imgs, mag):
    """JAX `_sharpness` (:172-177): the 3x3 kernel [[1,1,1],[1,5,1],[1,1,1]]
    / 13 over each channel, zero-padded at the border, as nine shifted
    sums."""
    _, h, w, _ = imgs.shape
    k = np.asarray([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / _F32(13.0)
    padded = F.pad(imgs, (0, 0, 1, 1, 1, 1))
    blurred = None
    for dy, dx in itertools.product(range(3), range(3)):
        term = padded[:, dy:dy + h, dx:dx + w, :] * float(k[dy, dx])
        blurred = term if blurred is None else blurred + term
    return torch.clamp(imgs + (imgs - blurred) * float(_F32(mag))
                       * float(_F32(0.9)), 0.0, 1.0)


# the 15 ops of timm's default 'rand-*' policy (increasing transforms), in
# the JAX package's order
_RA_OPS = (_rotate, _shear_x, _shear_y, _translate_x, _translate_y,
           _brightness, _contrast, _color, _posterize, _solarize,
           _solarize_add, _equalize, _invert, _autocontrast, _sharpness)
RA_OP_NAMES = ("Rotate", "ShearX", "ShearY", "TranslateXRel",
               "TranslateYRel", "Brightness", "Contrast", "Color",
               "Posterize", "Solarize", "SolarizeAdd", "Equalize",
               "Invert", "AutoContrast", "Sharpness")


def sample_ra_layer(rng: np.random.Generator, magnitude: float,
                    mag_std: float, num_ops: int, apply_prob: float = 0.5
                    ) -> Tuple[int, float]:
    """One RandAugment layer with timm's grammar (JAX sample_ra_layer
    :193-212): level ~ N(magnitude, mag_std) clipped to [0, 10] over 10, a
    random sign, and an op that applies with `apply_prob` (else op index
    `num_ops`, the identity). Returns (op_idx, signed fp32 magnitude)."""
    normal, sign, apply, op = (rng.standard_normal(), rng.random(),
                               rng.random(), int(rng.integers(0, num_ops)))
    level = np.clip(_F32(magnitude) + _F32(normal) * _F32(mag_std),
                    _F32(0.0), _F32(10.0)) / _F32(10.0)
    mag = level * (_F32(1.0) if sign < 0.5 else _F32(-1.0))
    return (op if apply < apply_prob else num_ops), float(mag)


# ---------------------------------------------------------------------------
# Batched geometric ops: 1-D bilinear resampling as a product with a weight
# matrix built from iota (JAX :215-288). The matrices depend only on the
# batch's magnitude, so one is shared by every image and channel. They stay
# fp32 (the port never enables TF32).
# ---------------------------------------------------------------------------
def _lerp_rows(src: torch.Tensor, n_in: int) -> torch.Tensor:
    """(..., n_out) source coordinates -> (..., n_out, n_in) weights; a
    coordinate outside [0, n_in − 1] gets zero weight off the grid."""
    return torch.clamp(1.0 - (src[..., None] - _iota(n_in, src.device)).abs(),
                       min=0.0)


def _shear_x_batch(imgs, s):
    """out(y, x) = in(y, x + s·(y − cy))."""
    _, h, w, _ = imgs.shape
    y = _iota(h, imgs.device) - (h - 1) / 2.0
    x = _iota(w, imgs.device)
    wm = _lerp_rows(x[None, :] + float(s) * y[:, None], w)      # (H, W, W)
    return torch.einsum("hoi,bhic->bhoc", wm, imgs)


def _shear_y_batch(imgs, s):
    """out(y, x) = in(y + s·(x − cx), x)."""
    _, h, w, _ = imgs.shape
    x = _iota(w, imgs.device) - (w - 1) / 2.0
    yv = _iota(h, imgs.device)
    wm = _lerp_rows(yv[None, :] + float(s) * x[:, None], h)     # (W, H, H)
    return torch.einsum("woi,biwc->bowc", wm, imgs)


def _translate_x_batch(imgs, frac):
    """out(y, x) = in(y, x + frac·W)."""
    w = imgs.shape[2]
    wm = _lerp_rows(_iota(w, imgs.device) + float(_F32(frac) * _F32(w)), w)
    return torch.einsum("oi,bhic->bhoc", wm, imgs)


def _translate_y_batch(imgs, frac):
    h = imgs.shape[1]
    wm = _lerp_rows(_iota(h, imgs.device) + float(_F32(frac) * _F32(h)), h)
    return torch.einsum("oi,bihc->bohc", wm, imgs)


def _rotate_batch(imgs, a):
    """Paeth's three shears, Hx(tan a/2)·Hy(−sin a)·Hx(tan a/2): the source
    map of `_rotate`, with one more bilinear pass."""
    s1 = np.tan(_F32(a) / _F32(2.0))
    imgs = _shear_x_batch(imgs, s1)
    imgs = _shear_y_batch(imgs, -np.sin(_F32(a)))
    return _shear_x_batch(imgs, s1)


# batched forms of the geometric _RA_OPS (same order and scaling)
_RA_BATCH_GEOM = {
    _rotate: lambda ims, mag: _rotate_batch(
        ims, _F32(mag) * _F32(np.pi) / _F32(6)),
    _shear_x: lambda ims, mag: _shear_x_batch(ims, _F32(mag) * _F32(0.3)),
    _shear_y: lambda ims, mag: _shear_y_batch(ims, _F32(mag) * _F32(0.3)),
    _translate_x: lambda ims, mag: _translate_x_batch(
        ims, _F32(mag) * _F32(0.45)),
    _translate_y: lambda ims, mag: _translate_y_batch(
        ims, _F32(mag) * _F32(0.45)),
}


def sample_rand_augment(rng: np.random.Generator, num_layers: int = 2,
                        magnitude: float = 9.0, mag_std: float = 0.5
                        ) -> Tuple[Tuple[int, float], ...]:
    """`num_layers` draws of sample_ra_layer over the 15 ops."""
    return tuple(sample_ra_layer(rng, magnitude, mag_std, len(_RA_OPS))
                 for _ in range(num_layers))


def rand_augment(image: torch.Tensor,
                 layers: Sequence[Tuple[int, float]]) -> torch.Tensor:
    """timm-style RandAugment of one (H, W, C) image in [0, 1] with the
    per-image ops (JAX rand_augment :291-309); `layers` from
    sample_rand_augment."""
    image = image[None]
    for op_idx, mag in layers:
        if op_idx < len(_RA_OPS):
            image = _RA_OPS[op_idx](image, mag)
    return image[0]


def rand_augment_batch(images: torch.Tensor,
                       layers: Sequence[Tuple[int, float]]) -> torch.Tensor:
    """RandAugment with one (op, magnitude) per layer for the whole batch
    (JAX rand_augment_batch :312-338); the geometric ops run as
    `_RA_BATCH_GEOM`'s products."""
    for op_idx, mag in layers:
        if op_idx < len(_RA_OPS):
            op = _RA_OPS[op_idx]
            images = _RA_BATCH_GEOM.get(op, op)(images, mag)
    return images


def parse_aa_spec(spec: str):
    """'rand-m9-mstd0.5-inc1' -> (num_layers, magnitude, mag_std); None for
    an empty or 'none' spec (JAX parse_aa_spec :341-361)."""
    if not spec or spec in ("none", "None"):
        return None
    if not spec.startswith("rand"):
        raise ValueError(f"only RandAugment ('rand-...') specs supported, "
                         f"got {spec!r}")
    layers, mag, mstd = 2, 9.0, 0.5
    for part in spec.split("-")[1:]:
        if part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("m"):
            mag = float(part[1:])
        elif part.startswith("n"):
            layers = int(part[1:])
        # 'inc1'/'w0' and friends: accepted, no-op here
    return layers, mag, mstd


# ---------------------------------------------------------------------------
# Colour jitter and random erasing
# ---------------------------------------------------------------------------
def sample_color_jitter(rng: np.random.Generator, b: int,
                        strength: float) -> np.ndarray:
    """(B, 3) fp32 factors ~ U[1 − s, 1 + s]: brightness, contrast,
    saturation."""
    return rng.uniform(1 - strength, 1 + strength, (b, 3)).astype(np.float32)


def color_jitter(images: torch.Tensor, factors: np.ndarray) -> torch.Tensor:
    """Per-image brightness, contrast and saturation jitter (JAX
    color_jitter :364-380) with the drawn factors."""
    f = _on(images.device, factors)[:, :, None, None, None]    # (B, 3, 1..)
    images = torch.clamp(images * f[:, 0], 0.0, 1.0)
    mean = images.mean(dim=(1, 2), keepdim=True)
    images = torch.clamp((images - mean) * f[:, 1] + mean, 0.0, 1.0)
    grey = images.mean(dim=-1, keepdim=True)
    return torch.clamp(grey + (images - grey) * f[:, 2], 0.0, 1.0)


def sample_erase(rng: np.random.Generator, b: int, prob: float,
                 area_range=(0.02, 1 / 3), ratio_min: float = 0.3
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(gate (B,) bool, (B, 4) fp32: area fraction, log aspect ratio, y and
    x fractions) of JAX random_erase (:392-400)."""
    lo, hi = np.log(_F32(ratio_min)), np.log(_F32(1 / ratio_min))
    gate = rng.random(b) < prob
    return gate, np.stack([rng.uniform(area_range[0], area_range[1], b),
                           rng.uniform(lo, hi, b), rng.random(b),
                           rng.random(b)], axis=1).astype(np.float32)


def _erase_boxes(erase: np.ndarray, h: int, w: int) -> np.ndarray:
    """(B, 4) fp32 (y0, y0 + eh, x0, x0 + ew), in JAX's fp32 arithmetic."""
    erase = np.asarray(erase, np.float32)
    area = erase[:, 0] * _F32(h * w)
    r = np.exp(erase[:, 1])
    eh = np.clip(np.sqrt(area * r), _F32(1.0), _F32(h))
    ew = np.clip(np.sqrt(area / r), _F32(1.0), _F32(w))
    y0 = erase[:, 2] * (_F32(h) - eh)
    x0 = erase[:, 3] * (_F32(w) - ew)
    return np.stack([y0, y0 + eh, x0, x0 + ew], axis=1)


def random_erase(images: torch.Tensor, gate: np.ndarray, erase: np.ndarray,
                 noise: torch.Tensor) -> torch.Tensor:
    """timm-style RandomErasing, 'pixel' mode (JAX random_erase :383-406):
    where `gate`, a box of the image is replaced by `noise` (image shape)."""
    _, h, w, _ = images.shape
    dev = images.device
    box = _on(dev, _erase_boxes(erase, h, w))[:, :, None, None]
    yy, xx = _iota(h, dev)[:, None], _iota(w, dev)[None, :]
    in_box = ((yy >= box[:, 0]) & (yy < box[:, 1]) & (xx >= box[:, 2])
              & (xx < box[:, 3]))                               # (B, H, W)
    in_box = in_box & _on(dev, gate)[:, None, None]
    return torch.where(in_box[..., None], noise.to(images.dtype), images)


# ---------------------------------------------------------------------------
# The whole pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    out_size: int = 224
    use_rrc: bool = True                 # random resized crop
    use_flip: bool = True
    randaug_layers: int = 2              # 0 disables RandAugment
    randaug_magnitude: float = 9.0
    mag_std: float = 0.5
    reprob: float = 0.0                  # RandomErasing probability
    color_jitter: float = 0.0            # used only when randaug_layers == 0
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugDraw:
    """One step's draws. Each per-image array has the batch's length;
    `ra` holds one (op_idx, magnitude) per RandAugment layer (op_idx 15:
    the identity); `noise`, of the output's shape, fills the erased boxes
    (None: drawn on the device when a gate is open)."""

    crop: np.ndarray             # (B, 4) fp32, sample_crop
    flip: np.ndarray             # (B,) bool
    jitter: np.ndarray           # (B, 3) fp32, sample_color_jitter
    ra: Tuple[Tuple[int, float], ...]
    erase_gate: np.ndarray       # (B,) bool
    erase: np.ndarray            # (B, 4) fp32, sample_erase
    noise: Optional[torch.Tensor] = None

    def rows(self, sl: slice) -> "AugDraw":
        """The draws of the images in `sl` (a process's rows of the global
        batch); `ra` belongs to the whole batch."""
        return dataclasses.replace(
            self, crop=self.crop[sl], flip=self.flip[sl],
            jitter=self.jitter[sl], erase_gate=self.erase_gate[sl],
            erase=self.erase[sl],
            noise=None if self.noise is None else self.noise[sl])


def sample_augment(rng: np.random.Generator, b: int,
                   cfg: DeviceAugConfig) -> AugDraw:
    """Every host draw of one step for a batch of `b`, from a numpy
    Generator. They equal the JAX draws in distribution, not bit for
    bit."""
    crop = sample_crop(rng, b)
    flip = rng.random(b) < 0.5
    jitter = sample_color_jitter(rng, b, cfg.color_jitter)
    ra = sample_rand_augment(rng, cfg.randaug_layers, cfg.randaug_magnitude,
                             cfg.mag_std)
    gate, erase = sample_erase(rng, b, cfg.reprob)
    return AugDraw(crop, flip, jitter, ra, gate, erase)


def apply_augment(images: torch.Tensor, draw: AugDraw, cfg: DeviceAugConfig,
                  noise_generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Raw [0, 1] NHWC batch -> augmented and normalized fp32 batch on the
    same device (JAX augment_batch :423-457): crop, flip, colour jitter
    (only without RandAugment), RandAugment, normalization, then random
    erasing with unit-normal noise."""
    dev = images.device
    images = images.float()
    if cfg.use_rrc:
        images = random_resized_crop(images, draw.crop, cfg.out_size)
    if cfg.use_flip:
        flip = _on(dev, draw.flip)[:, None, None, None]
        images = torch.where(flip, images.flip(2), images)
    if cfg.color_jitter > 0 and cfg.randaug_layers == 0:
        images = color_jitter(images, draw.jitter)
    if cfg.randaug_layers > 0:
        images = rand_augment_batch(images, draw.ra)
    stats = _on(dev, np.asarray([cfg.mean, cfg.std], np.float32))
    images = (images - stats[0]) / stats[1]
    if cfg.reprob > 0 and draw.erase_gate.any():
        noise = draw.noise
        if noise is None:
            noise = global_rand(images.shape, noise_generator, dev,
                                normal=True)
        images = random_erase(images, draw.erase_gate, draw.erase, noise)
    return images


def augment_batch(rng: np.random.Generator, images: torch.Tensor,
                  cfg: DeviceAugConfig,
                  noise_generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Sample, then apply."""
    return apply_augment(images, sample_augment(rng, images.shape[0], cfg),
                         cfg, noise_generator)
