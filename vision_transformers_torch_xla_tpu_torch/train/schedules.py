"""LR / weight-decay schedules.

Counterpart of vision_transformers_torch_xla_tpu/train/schedules.py: linear
warmup from `start_warmup_value` to `base_value` over `warmup_iters` steps,
then a half-cosine from `base_value` to `final_value`. `cosine_schedule_fn`
evaluates on the host in float32, the JAX function's dtype, so the step
needs no device round trip; `cosine_scheduler` is the materialized array,
equal to the JAX one element for element.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def cosine_schedule_fn(base_value: float, final_value: float, epochs: int,
                       niter_per_ep: int, warmup_epochs: int = 0,
                       start_warmup_value: float = 0.0,
                       warmup_steps: int = -1) -> Callable[[int], float]:
    """f(step) -> value, with the JAX function's float32 arithmetic."""
    warmup_iters = warmup_steps if warmup_steps > 0 else \
        int(warmup_epochs * niter_per_ep)
    total = epochs * niter_per_ep
    rest = max(total - warmup_iters, 1)
    f32 = np.float32

    def fn(step: int) -> float:
        step = f32(step)
        if step < warmup_iters:
            return float(f32(start_warmup_value) + step * f32(
                base_value - start_warmup_value) / f32(max(warmup_iters, 1)))
        j = min(step - f32(warmup_iters), f32(rest))
        return float(f32(final_value) + f32(0.5 * (base_value - final_value))
                     * (f32(1) + np.cos(f32(np.pi) * j / f32(rest))))

    return fn


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0,
                     warmup_steps: int = -1) -> np.ndarray:
    """Materialized array form, one value per global iteration."""
    warmup_iters = warmup_steps if warmup_steps > 0 else \
        int(warmup_epochs * niter_per_ep)
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters,
                         endpoint=False) if warmup_iters > 0 else np.array([])
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    rest = max(len(iters), 1)
    cosine = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / rest))
    schedule = np.concatenate((warmup, cosine))
    if len(schedule) != epochs * niter_per_ep:
        raise ValueError(f"schedule has {len(schedule)} values for "
                         f"{epochs} x {niter_per_ep} iterations")
    return schedule
