"""Golden gradient numbers for the PyTorch port's train-step check.

Writes tests/data/torch_port_train_golden_my_vit_b.json: one JAX fp32
forward + backward of full-width my_vit_b (act_layer gelu_tanh,
global_pool avg, drop_path 0) on the CPU, with weights and images that both
packages can make from a seed:

  * weights: the port's core/seeded.py::seeded_state_dict(shapes, seed=0),
    converted to flax params with ckpt/torch_compat.py::convert_vit_state_dict
    (the weights of tools/make_torch_port_golden.py);
  * images: core/seeded.py::seeded_images(2, 224, seed=0), NHWC;
  * labels: numpy default_rng(0).integers(0, 1000, 2);
  * loss: soft-target CE against one-hot targets smoothed by 0.1, no mixup
    (train/steps.py without mixup).

It records the loss, the global grad norm and every parameter's grad L2
norm under its timm name (through the port's ckpt/convert.py). chip_smoke.py
holds the port's bf16 train-mode forward + backward on the card against it.

    JAX_PLATFORMS=cpu python tools/make_torch_port_train_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "tests", "data",
                      "torch_port_train_golden_my_vit_b.json")
MODEL_KW = dict(act_layer="gelu_tanh", global_pool="avg", drop_path_rate=0.0)
SMOOTHING = 0.1


def main() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from vision_transformers_torch_xla_tpu.ckpt.torch_compat import (
        convert_vit_state_dict,
    )
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
        seeded_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model

    meta = create_model("my_vit_b", device=torch.device("meta"), **MODEL_KW)
    shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    params = convert_vit_state_dict(seeded_state_dict(shapes, seed=0))
    images = jnp.asarray(seeded_images(2, 224, seed=0))
    labels = np.random.default_rng(0).integers(0, 1000, 2)
    targets = smoothed_one_hot(jnp.asarray(labels, jnp.int32), 1000, SMOOTHING)
    model = jax_create("my_vit_b", dtype=jnp.float32, **MODEL_KW)

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
    with open(GOLDEN, "w") as f:
        json.dump({
            "model": "my_vit_b", "model_kwargs": MODEL_KW,
            "weights": "core/seeded.py::seeded_state_dict(seed=0)",
            "images": "core/seeded.py::seeded_images(2, 224, seed=0)",
            "labels": [int(v) for v in labels], "smoothing": SMOOTHING,
            "dtype": "float32", "backend": "jax cpu",
            "loss": float(loss), "grad_norm": grad_norm,
            "grad_norms": {k: norms[k] for k in sorted(norms)},
        }, f, indent=0)
    print(f"wrote {GOLDEN}: loss {float(loss):.6f}, grad norm "
          f"{grad_norm:.6f}, {len(norms)} parameters")


if __name__ == "__main__":
    main()
