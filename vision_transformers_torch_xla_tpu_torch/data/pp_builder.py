"""Preprocessing-op registry and the string language of pipelines.

Counterpart of vision_transformers_torch_xla_tpu/data/pp_builder.py
(`register_pp_op` :21, `list_pp_ops` :35, `_parse_call` :41,
`get_preprocess_fn` :59), with its error texts. A pipeline is a string
such as

    "decode_jpeg_and_inception_crop(224)|flip_lr|value_range(0, 1)|keep(\"image\", \"label\")"

split on '|'; each op is parsed as name(args) with `ast.literal_eval` for
the arguments, looked up in the registry and composed left to right over
a feature dict. Ops register as factories: `op(*args, **kw)` returns the
`features -> features` function. The ops themselves are data/pp_ops.py's,
which register in this module's registry.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List

_pp_ops: Dict[str, Callable] = {}


def register_pp_op(name: str = None):
    """Decorator: @register_pp_op() registers the factory under its
    __name__, a leading 'get_' stripped."""

    def _register(factory: Callable) -> Callable:
        key = name or factory.__name__
        if key.startswith("get_"):
            key = key[4:]
        _pp_ops[key] = factory
        return factory

    return _register


def list_pp_ops() -> List[str]:
    from vision_transformers_torch_xla_tpu_torch.data import pp_ops  # noqa: F401 (registers)

    return sorted(_pp_ops)


def _parse_call(spec: str):
    """'op(1, key="v")' -> (name, args, kwargs); a bare 'op' -> (op, (), {}).
    Arguments are literals only (ast, no evaluation of code)."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty pp op spec")
    if "(" not in spec:
        return spec, (), {}
    expr = ast.parse(spec, mode="eval").body
    if not isinstance(expr, ast.Call) or not isinstance(expr.func, ast.Name):
        raise ValueError(f"malformed pp op spec: {spec!r}")
    args = tuple(ast.literal_eval(a) for a in expr.args)
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in expr.keywords}
    return expr.func.id, args, kwargs


def get_preprocess_fn(pp_spec: str, log_name: str = "") -> Callable:
    """Compose a pp string into one features -> features function."""
    from vision_transformers_torch_xla_tpu_torch.data import pp_ops  # noqa: F401 (registers)

    fns = []
    for part in pp_spec.split("|"):
        part = part.strip()
        if not part:
            continue
        op_name, args, kwargs = _parse_call(part)
        if op_name not in _pp_ops:
            raise ValueError(
                f"unknown pp op {op_name!r} in {pp_spec!r}; known: {list_pp_ops()}")
        fns.append(_pp_ops[op_name](*args, **kwargs))

    def _fn(features):
        for fn in fns:
            features = fn(features)
        return features

    _fn.__name__ = f"pp({log_name or pp_spec})"
    return _fn
