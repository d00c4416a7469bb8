"""The port's on-device augmentation (data/device_aug.py) against the JAX
package's, on the CPU, and the train step with --device_augment.

The JAX functions draw with jax.random; the port applies draws made
elsewhere. So each test makes the JAX calls' own draws by walking the same
key tree (`jax.random.split`, `uniform`, `bernoulli`, `normal` with the JAX
code's arguments) and feeds them to the port. Images are seeded numpy
arrays in [0, 1], 32-64 px, batches of at most 4.

Tolerances. The resampling ops (the crop, the geometric RandAugment ops)
and the photometric ones (brightness, contrast, colour, autocontrast,
sharpness, colour jitter) agree to 1e-5 absolute: both compute in fp32 with
the same weights, and differ in summation order and by an ulp of a
transcendental (cos, exp) at most. The quantizing ops (posterize,
solarize, solarize-add, equalize, invert) and random erasing agree
exactly on the same input. The chained `augment_batch` resamples before it
quantizes: there an element whose input differs by an ulp may land one
quantization step away (a posterize or equalize level, or the two sides of
a solarize threshold: at most 1 in pixel units). So the chain holds every
element to 5e-5 (1e-5 over the smallest std, 0.224), but lets a share of at
most 1e-3 of them be off by up to one such step (1 over the smallest std).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.data import device_aug as da

ATOL = 1e-5          # resampling and photometric ops
CHAIN_ATOL = 5e-5    # augment_batch, after normalization
CHAIN_SHARE = 1e-3   # its one-step quantization allowance

QUANTIZING = {"Posterize", "Solarize", "SolarizeAdd", "Equalize", "Invert"}
GEOMETRIC = ("Rotate", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel")
MAGS = (0.7, -0.45)


@functools.lru_cache(maxsize=None)
def _jit(fn, static_argnums=()):
    """A JAX function under jax.jit, made once: XLA then compiles it once,
    where op-by-op dispatch compiles each of its ops (the same
    computation, as the JAX trainer runs it)."""
    import jax

    return jax.jit(fn, static_argnums=static_argnums)


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# ---- the JAX draws, by the JAX code's own calls ---------------------------

def jax_crop_draw(key, area_range=(0.05, 1.0), ratio_range=(3 / 4, 4 / 3)):
    """random_resized_crop's four scalars (device_aug.py:35-46)."""
    import jax
    import jax.numpy as jnp

    k_area, k_ratio, k_x, k_y = jax.random.split(key, 4)
    return [jax.random.uniform(k_area, (), minval=area_range[0],
                               maxval=area_range[1]),
            jax.random.uniform(k_ratio, (), minval=jnp.log(ratio_range[0]),
                               maxval=jnp.log(ratio_range[1])),
            jax.random.uniform(k_x, (), minval=0.0, maxval=1.0),
            jax.random.uniform(k_y, (), minval=0.0, maxval=1.0)]


def jax_jitter_draw(key, strength):
    """color_jitter's three factors (:370-374)."""
    import jax

    return [jax.random.uniform(k, (), minval=1 - strength,
                               maxval=1 + strength)
            for k in jax.random.split(key, 3)]


def jax_erase_draw(key, shape, prob):
    """random_erase's gate, (area, log ratio, y, x) and noise (:392-404)."""
    import jax
    import jax.numpy as jnp

    k_gate, k_area, k_ratio, k_y, k_x, k_noise = jax.random.split(key, 6)
    erase = [jax.random.uniform(k_area, (), minval=0.02, maxval=1 / 3),
             jax.random.uniform(k_ratio, (), minval=jnp.log(0.3),
                                maxval=jnp.log(1 / 0.3)),
             jax.random.uniform(k_y, ()), jax.random.uniform(k_x, ())]
    return (bool(jax.random.bernoulli(k_gate, prob)), erase,
            np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))


def jax_aug_draw(rng, b, cfg) -> da.AugDraw:
    """The draws of JAX augment_batch(rng, images, cfg) (:423-457), its
    random_resized_crop (:33-36), rand_augment_batch (:333-337) and
    sample_ra_layer (:193-221), as the port's AugDraw."""
    import jax

    from vision_transformers_torch_xla_tpu.data.device_aug import (
        sample_ra_layer,
    )

    k_batch, k_ra = jax.random.split(rng)
    crop, flip, jitter = [], [], []
    for key in jax.random.split(k_batch, b):
        k_crop, k_flip, k_cj = jax.random.split(key, 3)
        crop.append(jax_crop_draw(k_crop))
        flip.append(bool(jax.random.bernoulli(k_flip)))
        jitter.append(jax_jitter_draw(k_cj, cfg.color_jitter))
    ra = []
    for _ in range(cfg.randaug_layers):
        k_layer, k_ra = jax.random.split(k_ra)
        op, mag = sample_ra_layer(k_layer, cfg.randaug_magnitude, cfg.mag_std,
                                  len(da.RA_OP_NAMES))
        ra.append((int(op), float(mag)))
    gates, erase, noise = [], [], []
    shape = (cfg.out_size, cfg.out_size, 3)
    for key in jax.random.split(jax.random.fold_in(rng, 1), b):
        g, e, n = jax_erase_draw(key, shape, cfg.reprob)
        gates.append(g), erase.append(e), noise.append(n)
    f32 = lambda rows: np.asarray(rows, np.float32)  # noqa: E731
    return da.AugDraw(crop=f32(crop), flip=np.asarray(flip),
                      jitter=f32(jitter), ra=tuple(ra),
                      erase_gate=np.asarray(gates), erase=f32(erase),
                      noise=torch.from_numpy(np.stack(noise)))


def _jax_ops():
    from vision_transformers_torch_xla_tpu.data import device_aug as jda

    assert jda.RA_OP_NAMES == da.RA_OP_NAMES
    return jda


# ---- each RandAugment op on the same input -------------------------------

@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("name", da.RA_OP_NAMES)
def test_ra_op_matches_jax(name, mag):
    """The per-image op (rand_augment's), JAX's on one image, the port's on
    a batch of that image."""
    import jax.numpy as jnp

    jda = _jax_ops()
    i = da.RA_OP_NAMES.index(name)
    img = _images((48, 40, 3), i)
    # the quantizing ops as written, op by op: under jit XLA turns
    # _equalize's division by 255 into a product with its reciprocal
    op = jda._RA_OPS[i] if name in QUANTIZING else _jit(jda._RA_OPS[i])
    want = np.asarray(op(jnp.asarray(img), jnp.float32(mag)))
    got = da._RA_OPS[i](torch.from_numpy(img)[None], mag)[0].numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name in QUANTIZING:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("name", GEOMETRIC)
def test_batched_geometric_op_matches_jax(name, mag):
    """rand_augment_batch's geometric ops: products with one iota-built
    matrix per batch (Rotate as three shears)."""
    import jax.numpy as jnp

    jda = _jax_ops()
    i = da.RA_OP_NAMES.index(name)
    imgs = _images((2, 48, 40, 3), 20 + i)
    want = np.asarray(_jit(jda._RA_BATCH_GEOM[jda._RA_OPS[i]])(
        jnp.asarray(imgs), jnp.float32(mag)))
    got = da._RA_BATCH_GEOM[da._RA_OPS[i]](torch.from_numpy(imgs), mag)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_rand_augment_per_image_matches_jax():
    """Two layers drawn by JAX sample_ra_layer from rand_augment's own
    keys, applied by the port's per-image ops."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.data.device_aug import (
        rand_augment,
        sample_ra_layer,
    )

    img = _images((32, 48, 3), 8)
    for seed in range(2):
        k = jax.random.key(100 + seed)
        layers = []
        for _ in range(2):
            k_layer, k = jax.random.split(k)
            op, mag = sample_ra_layer(k_layer, 9.0, 0.5, 15)
            layers.append((int(op), float(mag)))
        want = np.asarray(_jit(rand_augment, (2,))(
            jax.random.key(100 + seed), jnp.asarray(img), 2))
        got = da.rand_augment(torch.from_numpy(img), layers)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# ---- the crop, colour jitter and random erasing with JAX's draws ---------

# (input H, W, output size, area range): the trainer's crop (output as
# large as the input, scale >= 1), an upsampling crop, and downsampling
# crops, where the triangle kernel widens (antialias)
CROPS = {"trainer": (32, 32, 32, (0.05, 1.0)),
         "upsample": (36, 28, 56, (0.05, 1.0)),
         "downsample": (64, 60, 24, (0.6, 1.0)),
         "downsample_small_crop": (64, 48, 32, (0.2, 0.4))}


@pytest.mark.parametrize("case", list(CROPS))
def test_random_resized_crop_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.data.device_aug import (
        random_resized_crop,
    )

    h, w, out, area = CROPS[case]
    imgs = _images((4, h, w, 3), 30)
    keys = jax.random.split(jax.random.key(len(case)), 4)
    crop_fn = _jit(random_resized_crop, (2, 3))
    want = np.stack([np.asarray(crop_fn(k, jnp.asarray(im), out, area))
                     for k, im in zip(keys, imgs)])
    crop = np.asarray([jax_crop_draw(k, area) for k in keys], np.float32)
    scale, _ = da._crop_scale_translation(crop, h, w, out)
    if case.startswith("downsample"):
        assert (scale < 1).any()
    else:
        assert (scale >= 1).all()
    got = da.random_resized_crop(torch.from_numpy(imgs), crop, out)
    assert got.shape == (4, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_full_crop_is_the_image():
    """Area 1 and ratio 1 reproduce the input (JAX test_rrc_full_crop)."""
    img = _images((1, 40, 40, 3), 31)
    crop = np.asarray([[1.0, 0.0, 0.5, 0.5]], np.float32)
    got = da.random_resized_crop(torch.from_numpy(img), crop, 40)
    np.testing.assert_allclose(got.numpy(), img, rtol=0, atol=ATOL)


@pytest.mark.parametrize("strength", [0.4, 0.9])
def test_color_jitter_matches_jax(strength):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.data.device_aug import (
        color_jitter,
    )

    imgs = _images((3, 32, 40, 3), 40)
    keys = jax.random.split(jax.random.key(4), 3)
    want = np.stack([np.asarray(_jit(color_jitter, (2,))(
        k, jnp.asarray(im), strength)) for k, im in zip(keys, imgs)])
    factors = np.asarray([jax_jitter_draw(k, strength) for k in keys],
                         np.float32)
    got = da.color_jitter(torch.from_numpy(imgs), factors)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_random_erase_matches_jax(prob):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.data.device_aug import (
        random_erase,
    )

    imgs = _images((4, 32, 36, 3), 50) * 4 - 2     # normalized-like values
    keys = jax.random.split(jax.random.key(5), 4)
    want = np.stack([np.asarray(_jit(random_erase, (2,))(
        k, jnp.asarray(im), prob)) for k, im in zip(keys, imgs)])
    draws = [jax_erase_draw(k, imgs.shape[1:], prob) for k in keys]
    gate = np.asarray([g for g, _, _ in draws])
    erase = np.asarray([e for _, e, _ in draws], np.float32)
    noise = torch.from_numpy(np.stack([n for _, _, n in draws]))
    got = da.random_erase(torch.from_numpy(imgs), gate, erase, noise)
    np.testing.assert_array_equal(got.numpy(), want)
    assert gate.any() and (prob == 1.0) == gate.all()
    assert (got.numpy() != imgs).any()


# ---- the whole pipeline ---------------------------------------------------

# config, and the keys of its runs (key 119 draws Equalize, Rotate,
# Equalize: a quantizing op on each side of a resample)
AUG_CASES = {
    "recipe": (dict(randaug_layers=2, reprob=0.25), (60, 61)),
    "erase_all": (dict(randaug_layers=2, reprob=1.0), (90,)),
    "three_layers": (dict(randaug_layers=3, randaug_magnitude=7.0,
                          mag_std=1.0), (119,)),
    "jitter_no_randaug": (dict(randaug_layers=0, color_jitter=0.4), (170,)),
    "inception_stats": (dict(randaug_layers=1, use_flip=False,
                             mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
                        (150,)),
}


def _chain_matches(got, want, cfg):
    """augment_batch's limits (the module docstring): every element within
    CHAIN_ATOL, but at most CHAIN_SHARE of them within one quantization
    step instead."""
    diff = np.abs(got - want)
    far = diff > CHAIN_ATOL
    step = (1.0 + 1e-5) / min(cfg.std)   # the largest quantization step
    assert diff.max() <= step, diff.max()
    assert far.mean() <= CHAIN_SHARE, (int(far.sum()), far.size)


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_augment_batch_matches_jax_with_its_draws(case):
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.data import device_aug as jda

    kw, seeds = AUG_CASES[case]
    jcfg = jda.DeviceAugConfig(out_size=32, **kw)
    cfg = da.DeviceAugConfig(out_size=32, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    imgs = _images((4, 40, 36, 3), seeds[0])
    for seed in seeds:
        rng = jax.random.key(seed)
        want = np.asarray(_jit(jda.augment_batch, (2,))(
            rng, jnp.asarray(imgs), jcfg))
        draw = jax_aug_draw(rng, 4, cfg)
        got = da.apply_augment(torch.from_numpy(imgs), draw, cfg)
        assert got.shape == want.shape == (4, 32, 32, 3)
        assert len(draw.ra) == cfg.randaug_layers
        _chain_matches(got.numpy(), want, cfg)
    if case == "erase_all":
        assert all(draw.erase_gate)
    if case == "three_layers":
        assert [da.RA_OP_NAMES[op] for op, _ in draw.ra] == [
            "Equalize", "Rotate", "Equalize"]


def test_sample_augment_draws_follow_the_config():
    rng = np.random.default_rng(0)
    cfg = da.DeviceAugConfig(reprob=0.25, randaug_layers=3,
                             color_jitter=0.4)
    draws = [da.sample_augment(rng, 64, cfg) for _ in range(20)]
    crop = np.concatenate([d.crop for d in draws])
    assert crop.dtype == np.float32 and crop.shape == (1280, 4)
    assert crop[:, 0].min() >= 0.05 and crop[:, 0].max() <= 1.0
    assert np.abs(crop[:, 1]).max() <= np.log(4 / 3) + 1e-6
    assert crop[:, 2:].min() >= 0 and crop[:, 2:].max() < 1
    flips = np.concatenate([d.flip for d in draws])
    assert 0.4 < flips.mean() < 0.6
    jitter = np.concatenate([d.jitter for d in draws])
    assert jitter.min() >= 0.6 and jitter.max() <= 1.4
    gates = np.concatenate([d.erase_gate for d in draws])
    assert 0.18 < gates.mean() < 0.32
    layers = [layer for d in draws for layer in d.ra]
    assert len(layers) == 60
    ops = [op for op, _ in layers]
    assert set(ops) <= set(range(16)) and 15 in ops   # 15: not applied
    assert all(-1.0 <= mag <= 1.0 for _, mag in layers)
    assert all(d.noise is None for d in draws)


def test_augment_batch_draws_the_erase_noise_from_the_generator():
    cfg = da.DeviceAugConfig(out_size=16, reprob=1.0)
    imgs = torch.from_numpy(_images((2, 20, 20, 3), 70))

    def run(noise_seed):
        return da.augment_batch(np.random.default_rng(3), imgs, cfg,
                                torch.Generator().manual_seed(noise_seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 16, 16, 3) and a.dtype == torch.float32


@pytest.mark.parametrize("spec", ["rand-m9-mstd0.5-inc1", "rand-m7-n3",
                                  "rand-n1-m5-mstd1.0-w0", "", "none",
                                  "None"])
def test_parse_aa_spec_matches_jax(spec):
    from vision_transformers_torch_xla_tpu.data.device_aug import (
        parse_aa_spec,
    )

    assert da.parse_aa_spec(spec) == parse_aa_spec(spec)
    with pytest.raises(ValueError, match="RandAugment"):
        da.parse_aa_spec("v0")


# ---- one train step with --device_augment against the JAX step -----------

def test_train_step_with_device_augment_matches_jax(monkeypatch):
    """The tiny ViT of tests/test_torch_train.py in fp32 with the attention
    kernels on (JAX's in interpret mode, the port's plain versions), raw
    [0, 1] batches, the recipe's RandAugment and --reprob 0.25: the port's
    step fed the JAX step's aug draws (aug_rng is index 3 of
    split(fold_in(rng, step), 5), steps.py:67-74) and mixup draws (index
    0). Loss and grad norm to three_steps' 1e-5 relative. Key 3 draws
    Invert then Rotate, flips one image and erases the other."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from test_torch_train import CFG, _jax_draw
    from vision_transformers_torch_xla_tpu.data import device_aug as jda
    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )
    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train import steps as jsteps
    from vision_transformers_torch_xla_tpu.train.mixup import (
        MixupConfig as JaxMixupConfig,
    )
    from vision_transformers_torch_xla_tpu.train.state import (
        create_train_state as jax_train_state,
    )
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.models.vit import (
        VisionTransformer,
    )
    from vision_transformers_torch_xla_tpu_torch.train import mixup
    from vision_transformers_torch_xla_tpu_torch.train import optim
    from vision_transformers_torch_xla_tpu_torch.train.state import (
        create_train_state,
    )
    from vision_transformers_torch_xla_tpu_torch.train.steps import (
        StepConfig,
        make_train_step,
    )

    jmodel = JaxViT(**CFG, dtype=jnp.float32, use_pallas_attn=True)
    # the kernel model's params, made under jit by the plain model's init
    plain = jmodel.clone(use_pallas_attn=False)
    params = jax.jit(lambda k: nn.meta.unbox(plain.init(
        k, jnp.zeros((2, 32, 32, 3))))["params"])(jax.random.key(0))
    jtx = jo.maybe_fused_optimizer("adamw", 1e-3, params, weight_decay=0.05,
                                   ema_decay=0.9)
    # the update under jit, as the JAX trainer runs it; the step stays
    # eager (interpret-mode kernels do not lower under jit)
    jtx = jtx._replace(fused_update=jax.jit(jtx.fused_update))
    kw = dict(out_size=32, reprob=0.25)
    jcfg = jsteps.StepConfig(mixup=JaxMixupConfig(num_classes=10),
                             num_classes=10, ema_decay=0.9,
                             device_aug=jda.DeviceAugConfig(**kw))
    jstate = jax_train_state(params, jtx, with_ema=True)
    # the step imports augment_batch when it runs: take it under jit too
    monkeypatch.setattr(jda, "augment_batch",
                        _jit(jda.augment_batch, (2,)))

    model = VisionTransformer(**CFG, dtype=torch.float32,
                              use_pallas_attn=True)
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                          params)))
    tx = optim.maybe_fused_optimizer("adamw", 1e-3,
                                     dict(model.named_parameters()),
                                     weight_decay=0.05, ema_decay=0.9)
    pcfg = StepConfig(mixup=mixup.MixupConfig(num_classes=10),
                      num_classes=10, ema_decay=0.9,
                      device_aug=da.DeviceAugConfig(**kw))
    pstate = create_train_state(model, tx, with_ema=True)

    images = _images((2, 40, 36, 3), 80)
    labels = np.asarray([3, 8], np.int32)
    rng = jax.random.key(3)
    keys = jax.random.split(jax.random.fold_in(rng, 0), 5)
    aug_draw = jax_aug_draw(keys[3], 2, pcfg.device_aug)
    mix_draw = _jax_draw(keys[0], 32, 32, jcfg.mixup)
    assert [da.RA_OP_NAMES[op] for op, _ in aug_draw.ra] == ["Invert",
                                                             "Rotate"]
    assert aug_draw.flip.tolist() == [False, True]
    assert aug_draw.erase_gate.tolist() == [False, True]
    with pltpu.force_tpu_interpret_mode():
        jstate, want = jsteps.make_train_step(jmodel.apply, jtx, jcfg)(
            jstate, jnp.asarray(images), jnp.asarray(labels), rng)
    pstate, got = make_train_step(model, tx, pcfg)(
        pstate, torch.from_numpy(images), torch.from_numpy(labels), 0,
        mixup_draw=mix_draw, aug_draw=aug_draw)
    assert set(got) == set(want) == {"loss", "grad_norm"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
