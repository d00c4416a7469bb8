"""Merging loaded weights into a model's parameters.

Counterpart of three functions of the JAX package:
`models/pretrained.py::merge_into_params` (:361-414) and
`_infer_prefix_tokens` (:349-358), and `models/vit.py::resample_pos_embed`
(:33-46). The registry's pretrained tags are not ported yet (ROADMAP M7).

`resample_pos_embed` is `jax.image.resize(..., "cubic")`, not
`F.interpolate`'s bicubic: Keys' kernel with a = -0.5, half-pixel centres,
the weights of each output renormalised to sum to one (so the edges are
not clamped), and, when the grid shrinks, the kernel widened by the
shrink factor (antialiasing). The weights are built on the host as
`jax.image.scale_and_translate` builds them and applied as two products.
"""
from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp32 weights of a 1-D cubic resize, as
    `jax._src.image.scale.compute_weight_mat` (antialiased) builds them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def resample_pos_embed(pos_embed: torch.Tensor, new_grid: Tuple[int, int],
                       old_grid: Tuple[int, int],
                       num_prefix_tokens: int = 1) -> torch.Tensor:
    """Cubic-resample a learned (1, P + N, D) position embedding from
    `old_grid` to `new_grid`; the P prefix tokens pass through."""
    prefix = pos_embed[:, :num_prefix_tokens]
    d = pos_embed.shape[-1]
    grid = pos_embed[:, num_prefix_tokens:].reshape(old_grid[0], old_grid[1],
                                                    d).float()
    # an axis whose size does not change is left as it is (jax.image.resize)
    if new_grid[0] != old_grid[0]:
        wh = torch.from_numpy(cubic_resize_weights(old_grid[0], new_grid[0]))
        grid = torch.einsum("hwd,hH->Hwd", grid, wh.to(grid.device))
    if new_grid[1] != old_grid[1]:
        ww = torch.from_numpy(cubic_resize_weights(old_grid[1], new_grid[1]))
        grid = torch.einsum("hwd,wW->hWd", grid, ww.to(grid.device))
    grid = grid.reshape(1, new_grid[0] * new_grid[1], d).to(pos_embed.dtype)
    return torch.cat([prefix, grid], dim=1)


def _infer_prefix_tokens(n_old: int, n_new: int) -> Optional[int]:
    """Shared prefix-token count p where both (n-p) are perfect squares."""
    for p in range(0, 9):
        a, b = n_old - p, n_new - p
        if a <= 0 or b <= 0:
            continue
        ra, rb = int(round(a ** 0.5)), int(round(b ** 0.5))
        if ra * ra == a and rb * rb == b:
            return p
    return None


@torch.no_grad()
def merge_into_params(params: Dict[str, torch.Tensor],
                      loaded: Mapping[str, torch.Tensor],
                      resample: bool = True
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Copy a loaded timm-named state dict into `params` (the model's live
    tensors), in place.

    Shape-matching entries are copied; a mismatched ``pos_embed`` is
    cubic-resampled to the new grid; anything else mismatched (the
    classifier head when the class count differs) is skipped with a
    warning and keeps its values. Loaded names the model lacks are
    ignored. Returns (params, n_loaded)."""
    n_loaded = 0
    for key, leaf in params.items():
        cand = loaded.get(key)
        if cand is None:
            continue
        cand = torch.as_tensor(cand)
        if tuple(cand.shape) == tuple(leaf.shape):
            leaf.copy_(cand)
            n_loaded += 1
            continue
        if (resample and key.split(".")[-1] == "pos_embed"
                and cand.ndim == 3 and leaf.ndim == 3
                and cand.shape[-1] == leaf.shape[-1]):
            p = _infer_prefix_tokens(cand.shape[1], leaf.shape[1])
            if p is not None:
                go = int(round((cand.shape[1] - p) ** 0.5))
                gn = int(round((leaf.shape[1] - p) ** 0.5))
                log.info("resampled %s %s -> %s", key, tuple(cand.shape),
                         tuple(leaf.shape))
                leaf.copy_(resample_pos_embed(cand.to(leaf.dtype), (gn, gn),
                                              (go, go), num_prefix_tokens=p))
                n_loaded += 1
                continue
        log.warning("skip %s (shape %s vs %s)", key, tuple(cand.shape),
                    tuple(leaf.shape))
    return params, n_loaded
