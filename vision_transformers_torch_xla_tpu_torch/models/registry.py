"""Model registry: a flat name -> entrypoint map.

Counterpart of vision_transformers_torch_xla_tpu/models/registry.py
(`register_model` :27, `model_entrypoint` :63, `get_default_cfg` :99) for
the names this port has: the ViT zoo, `my_vit_*` and the 31 ConvNeXt
names. Pretrained-tag databases, deprecation aliases and the families
past ConvNeXt are ROADMAP M8's.
"""
from __future__ import annotations

import sys
import warnings
from typing import Callable, Dict, List, Optional

_model_entrypoints: Dict[str, Callable] = {}
_model_default_cfgs: Dict[str, dict] = {}


def split_model_name_tag(model_name: str, no_tag: str = ""):
    """'name.tag' -> ('name', 'tag')."""
    name, *tag = model_name.split(".", 1)
    return name, (tag[0] if tag else no_tag)


def register_model(fn: Callable = None, *, default_cfg: Optional[dict] = None):
    """Decorator registering a model entrypoint under its function name."""

    def _register(fn: Callable) -> Callable:
        name = fn.__name__
        if name in _model_entrypoints:
            warnings.warn(f"model {name!r} re-registered; overwriting")
        _model_entrypoints[name] = fn
        if default_cfg is not None:
            _model_default_cfgs[name] = default_cfg
        mod = sys.modules.get(fn.__module__)
        if mod is not None and hasattr(mod, "__all__") and \
                name not in mod.__all__:
            mod.__all__.append(name)
        return fn

    return _register(fn) if fn is not None else _register


def list_models() -> List[str]:
    return sorted(_model_entrypoints)


def model_entrypoint(name: str) -> Callable:
    name = split_model_name_tag(name)[0]
    try:
        return _model_entrypoints[name]
    except KeyError:
        raise RuntimeError(f"unknown model {name!r}; known: "
                           f"{list_models()}") from None


def get_default_cfg(name: str) -> dict:
    """The default cfg attached to `name` at register time."""
    return dict(_model_default_cfgs.get(split_model_name_tag(name)[0], {}))
