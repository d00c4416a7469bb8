"""Golden logits and JPEGs for the PyTorch port's checks.

Writes tests/data/torch_port_golden_<model>.json: the JAX package's fp32
logits of a full-width model on two seeded images, with weights that both
packages can make from a seed. Four models have goldens (CONFIGS):

  * my_vit_b at 224 px (act_layer gelu_tanh, global_pool avg), the serving
    and training slices' model;
  * vit_base_patch14_dinov2 at 518 px (global_pool token; S = 1370, the
    long-sequence path), with its LayerScale gammas set to 1;
  * vit_base_patch14_reg4_dinov2 at 518 px (4 register tokens,
    no_embed_class; S = 1374 on the blocked kernels), gammas 1, cut to
    depth 4;
  * vit_base_patch16_siglip_224 (no class token, the MAP head; S = 196),
    cut to depth 4.

The two depth-4 goldens keep the full width (768, 12 heads of 64) and
run on a few GiB of host memory.

  * weights: a timm-named state dict from the port's
    core/seeded.py::seeded_state_dict(shapes, seed=0, gamma) (shapes read
    off the port's model built on the meta device), converted to flax
    params with ckpt/torch_compat.py::convert_vit_state_dict;
  * images: core/seeded.py::seeded_images(2, img, seed=0), NHWC.

chip_smoke.py rebuilds the same weights and images and holds the port's
bf16 forward on the card against these logits. For my_vit_b it also writes
the four small JPEGs (tests/data/serve_*.jpg) that the serve checks post.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py \
        [--model vit_base_patch14_dinov2 | vit_base_patch14_reg4_dinov2 |
         vit_base_patch16_siglip_224]

The 518-px model is a full-size fp32 run (~0.6 TFLOP): run it on a host
with the cores and memory for it.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DATA = os.path.join(REPO, "tests", "data")
JPEG_SIZES = ((320, 240), (240, 320), (256, 256), (500, 375))
# model -> image size, model kwargs, LayerScale gamma of the seeded weights
CONFIGS = {
    "my_vit_b": (224, dict(act_layer="gelu_tanh", global_pool="avg"), None),
    "vit_base_patch14_dinov2": (518, dict(global_pool="token"), 1.0),
    "vit_base_patch14_reg4_dinov2": (518, dict(global_pool="token",
                                               depth=4), 1.0),
    "vit_base_patch16_siglip_224": (224, dict(depth=4), None),
}


def write_jpegs() -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(JPEG_SIZES):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 17 + i)], -1)
        img = np.clip(base * 255 + rng.normal(0, 4, (h, w, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(DATA, f"serve_{i}.jpg"), quality=80)


def seeded_params(name: str):
    """The seeded timm state dict of CONFIGS[name] as flax params."""
    import torch

    from vision_transformers_torch_xla_tpu.ckpt.torch_compat import (
        convert_vit_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model

    img, kw, gamma = CONFIGS[name]
    meta = create_model(name, img_size=img, device=torch.device("meta"), **kw)
    shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    return convert_vit_state_dict(seeded_state_dict(shapes, seed=0,
                                                    gamma=gamma)), shapes


def weights_note(name: str) -> str:
    gamma = CONFIGS[name][2]
    return "core/seeded.py::seeded_state_dict(seed=0" + (
        f", gamma={gamma})" if gamma is not None else ")")


def write_golden(name: str) -> None:
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
    )

    img, kw, _ = CONFIGS[name]
    params, _ = seeded_params(name)
    images = seeded_images(2, img, seed=0)
    model = jax_create(name, img_size=img, dtype=jnp.float32, **kw)
    logits = jax.jit(lambda p, x: model.apply({"params": p}, x, True))(
        params, jnp.asarray(images))
    logits = np.asarray(logits, np.float32)
    path = os.path.join(DATA, f"torch_port_golden_{name}.json")
    with open(path, "w") as f:
        json.dump({
            "model": name, "model_kwargs": kw, "img_size": img,
            "weights": weights_note(name),
            "images": f"core/seeded.py::seeded_images(2, {img}, seed=0)",
            "dtype": "float32", "backend": "jax cpu",
            "logits": [[float(v) for v in row] for row in logits],
        }, f)
    print(f"wrote {path}: logits {logits.shape}, |max| "
          f"{np.abs(logits).max():.4f}, std {logits.std():.4f}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="my_vit_b", choices=sorted(CONFIGS))
    args = ap.parse_args()
    os.makedirs(DATA, exist_ok=True)
    if args.model == "my_vit_b":
        write_jpegs()
    write_golden(args.model)
