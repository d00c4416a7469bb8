"""Per-step random streams.

Counterpart of vision_transformers_torch_xla_tpu/core/rng.py and of the
key discipline of train/steps.py (`fold_in(rng, step)`, then one key per
stream). Here the seeds come from numpy's SeedSequence over
(seed, step, stream): the host draws mixup's few scalars from a numpy
Generator, and the model's stochastic layers (dropout and drop_path, in
call order) draw from a torch.Generator on the batch's device. The draws
equal JAX's in distribution, not bit for bit: threefry and Philox never
agree, so the tests feed the JAX draws where they compare the two.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

STREAMS = ("mixup", "model")


@dataclasses.dataclass
class StepRngs:
    mixup: np.random.Generator
    model: torch.Generator


def stream_seed(seed: int, step: int, stream: str) -> int:
    """A 64-bit seed that depends on (seed, step, stream) only."""
    ss = np.random.SeedSequence([seed, step, STREAMS.index(stream)])
    return int(ss.generate_state(1, np.uint64)[0])


def step_rngs(seed: int, step: int, device) -> StepRngs:
    """The generators of one train step."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, step, "model"))
    return StepRngs(
        mixup=np.random.default_rng(stream_seed(seed, step, "mixup")),
        model=gen)
