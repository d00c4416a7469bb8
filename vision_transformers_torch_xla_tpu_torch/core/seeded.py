"""Weights and images made from a numpy seed.

The same seed gives the same arrays to the JAX package and to the port, so
a golden output made with one can be checked on the other without any
download (tools/make_torch_port_golden.py, chip_smoke.py).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def _is_norm_param(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and "norm" in parts[-2]


def seeded_state_dict(shapes: Mapping[str, Sequence[int]],
                      seed: int = 0, gamma: Optional[float] = None
                      ) -> Dict[str, np.ndarray]:
    """A timm-named fp32 state dict: norm weights 1 and biases 0, every other
    tensor N(0, 0.02), drawn in sorted-key order from default_rng(seed).
    With `gamma`, the LayerScale gammas (names ending in '.gamma') are set
    to that constant after the draw, so that the branches they scale move
    the output."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = tuple(int(n) for n in shapes[name])
        if _is_norm_param(name):
            fill = np.ones if name.endswith("weight") else np.zeros
            out[name] = fill(shape, np.float32)
        else:
            out[name] = rng.normal(0.0, 0.02, shape).astype(np.float32)
        if gamma is not None and name.endswith(".gamma"):
            out[name] = np.full(shape, gamma, np.float32)
    return out


def seeded_images(n: int, size: int, seed: int = 0) -> np.ndarray:
    """(n, size, size, 3) fp32 NHWC images, standard normal (the normalized
    input domain), from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, size, size, 3)).astype(np.float32)
