"""Golden gradient numbers for the PyTorch port's train-step check.

Writes tests/data/torch_port_train_golden_<model>.json: one JAX fp32
forward + backward of a full-width model on the CPU, drop_path 0, with the
weights and images of tools/make_torch_port_golden.py (its CONFIGS:
my_vit_b at 224 px, vit_base_patch14_dinov2 and, at depth 4,
vit_base_patch14_reg4_dinov2 at 518 px):

  * weights: the port's core/seeded.py::seeded_state_dict(shapes, seed=0,
    gamma), converted to flax params with
    ckpt/torch_compat.py::convert_vit_state_dict;
  * images: core/seeded.py::seeded_images(2, img, seed=0), NHWC;
  * labels: numpy default_rng(0).integers(0, 1000, 2);
  * loss: soft-target CE against one-hot targets smoothed by 0.1, no mixup
    (train/steps.py without mixup).

It records the loss, the global grad norm and every parameter's grad L2
norm under its timm name (through the port's ckpt/convert.py). chip_smoke.py
holds the port's bf16 train-mode forward + backward on the card against it.

    JAX_PLATFORMS=cpu python tools/make_torch_port_train_golden.py \
        [--model vit_base_patch14_dinov2 | vit_base_patch14_reg4_dinov2]
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SMOOTHING = 0.1


def main(name: str) -> None:
    import jax
    import jax.numpy as jnp

    from make_torch_port_golden import CONFIGS, seeded_params, weights_note
    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )
    from vision_transformers_torch_xla_tpu.train.losses import (
        soft_target_cross_entropy,
    )
    from vision_transformers_torch_xla_tpu.train.mixup import smoothed_one_hot
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
    )

    img, kw, _ = CONFIGS[name]
    kw = dict(kw, drop_path_rate=0.0)
    params, shapes = seeded_params(name)
    images = jnp.asarray(seeded_images(2, img, seed=0))
    labels = np.random.default_rng(0).integers(0, 1000, 2)
    targets = smoothed_one_hot(jnp.asarray(labels, jnp.int32), 1000, SMOOTHING)
    model = jax_create(name, img_size=img, dtype=jnp.float32, **kw)

    def loss_fn(p):
        logits = model.apply({"params": p}, images, True)
        return soft_target_cross_entropy(logits, targets)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = jax.tree.map(np.asarray, grads)
    norms = {k: float(np.linalg.norm(v.numpy().astype(np.float64)))
             for k, v in flax_to_state_dict(grads).items()}
    if set(norms) != set(shapes):
        raise RuntimeError(f"grad names differ from the port's: "
                           f"{sorted(set(norms) ^ set(shapes))}")
    grad_norm = float(np.sqrt(sum(n * n for n in norms.values())))
    path = os.path.join(REPO, "tests", "data",
                        f"torch_port_train_golden_{name}.json")
    with open(path, "w") as f:
        json.dump({
            "model": name, "model_kwargs": kw, "img_size": img,
            "weights": weights_note(name),
            "images": f"core/seeded.py::seeded_images(2, {img}, seed=0)",
            "labels": [int(v) for v in labels], "smoothing": SMOOTHING,
            "dtype": "float32", "backend": "jax cpu",
            "loss": float(loss), "grad_norm": grad_norm,
            "grad_norms": {k: norms[k] for k in sorted(norms)},
        }, f, indent=0)
    print(f"wrote {path}: loss {float(loss):.6f}, grad norm "
          f"{grad_norm:.6f}, {len(norms)} parameters")


if __name__ == "__main__":
    import argparse

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="my_vit_b")
    args = ap.parse_args()
    main(args.model)
