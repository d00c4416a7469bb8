"""Weights across from the JAX package.

Counterpart of vision_transformers_torch_xla_tpu/ckpt/torch_export.py
::export_vit_state_dict (:117) and ::save_torch_checkpoint (:1523), for the
ViT keys of this slice. `flax_to_state_dict` maps a flax ViT params tree
(nested dict of numpy arrays) to the port's timm-named state dict;
`load_checkpoint` reads the `{'model': state_dict}` .pth that
`save_torch_checkpoint` writes, unwrapped as JAX
ckpt/torch_compat.py::load_reference_checkpoint (:1857-1897) unwraps a
reference checkpoint (the port keeps timm names, so nothing is renamed),
or the newest epoch of the port's own checkpoints directory. Either loads
with `strict=True`.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_AFFINE = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _dense(name: str, leaf: str, w: np.ndarray):
    """flax Dense/LayerNorm leaf -> (timm key, value): kernels transpose."""
    return f"{name}.{_AFFINE[leaf]}", (w.T if leaf == "kernel" else w)


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ViT params (the 'params' collection, or variables holding it) ->
    timm-named fp32 torch state dict."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    for path, w in _flatten(params).items():
        top, leaf = path[0], path[-1]
        if top in ("cls_token", "pos_embed") and len(path) == 1:
            sd[top] = w
        elif path == ("patch_embed", "proj", "kernel"):
            # (p·p·C, D) matmul kernel -> OIHW conv weight (D, C, p, p)
            kk, d = w.shape
            p = int(round((kk // 3) ** 0.5))
            sd["patch_embed.proj.weight"] = \
                w.reshape(p, p, 3, d).transpose(3, 2, 0, 1)
        elif path == ("patch_embed", "proj", "bias"):
            sd["patch_embed.proj.bias"] = w
        elif m := re.fullmatch(r"blocks_(\d+)", top):
            pre = f"blocks.{m.group(1)}"
            if path[1] in ("ls1", "ls2") and leaf == "gamma":
                sd[f"{pre}.{path[1]}.gamma"] = w
            elif path[1] in ("norm1", "norm2") and len(path) == 3:
                k, v = _dense(f"{pre}.{path[1]}", leaf, w)
                sd[k] = v
            elif path[1] in ("attn", "mlp") and len(path) == 4 and path[2] in (
                    "qkv", "proj", "q_norm", "k_norm", "fc1", "fc2"):
                k, v = _dense(f"{pre}.{path[1]}.{path[2]}", leaf, w)
                sd[k] = v
            else:
                raise ValueError(f"vit convert: unmapped {path}")
        elif top in ("norm", "fc_norm", "norm_pre", "head") and len(path) == 2:
            k, v = _dense(top, leaf, w)
            sd[k] = v
        else:
            raise ValueError(f"vit convert: unmapped {path}")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def load_checkpoint(path: str, key: str = "model|module",
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """A state dict on the CPU, from a .pth or a checkpoints directory.

    A .pth: the entry under the first of the '|'-separated `key`s it holds
    (`--model_key`), else the whole dict; then a DDP `module.` prefix and
    `prefix` (`--model_prefix`) are stripped from the names. A directory of
    ckpt/checkpoint.py's checkpoints: the newest epoch's EMA params when
    they were saved, else its params."""
    if os.path.isdir(path):
        from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
            CheckpointManager,
        )

        raw = CheckpointManager(os.path.abspath(path)).restore_raw()
        if raw is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return raw.get("ema_params") or raw["params"]
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt
    if isinstance(ckpt, Mapping):
        sd = next((ckpt[k] for k in key.split("|") if k in ckpt), ckpt)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    if prefix:
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v
              for k, v in sd.items()}
    return sd


def save_checkpoint(path: str, state_dict: Mapping[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """torch.save `{'model': state_dict, **extra}` (numpy arrays become
    tensors), the format `load_checkpoint` reads."""
    sd = {k: torch.as_tensor(np.ascontiguousarray(v))
          if isinstance(v, np.ndarray) else v for k, v in state_dict.items()}
    torch.save({"model": sd, **(extra or {})}, path)
