"""Per-step random streams.

Counterpart of vision_transformers_torch_xla_tpu/core/rng.py and of the
key discipline of train/steps.py (`fold_in(rng, step)`, then one key per
stream). Here the seeds come from numpy's SeedSequence over
(seed, step, stream): the host draws mixup's few scalars, and the on-device
augmentation's per-image scalars and RandAugment ops, from numpy
Generators; the model's stochastic layers (dropout and drop_path, in call
order) and the augmentation's erase noise draw from torch.Generators on
the batch's device. The draws equal JAX's in distribution, not bit for
bit: threefry and Philox never agree, so the tests feed the JAX draws
where they compare the two.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

STREAMS = ("mixup", "model", "aug")


@dataclasses.dataclass
class StepRngs:
    mixup: np.random.Generator
    model: torch.Generator
    aug: np.random.Generator
    aug_noise: torch.Generator


def stream_seed(seed: int, step: int, stream: str, word: int = 0) -> int:
    """A 64-bit seed that depends on (seed, step, stream) only; `word` picks
    another of the stream's independent words (word 0 does not depend on
    how many are made)."""
    ss = np.random.SeedSequence([seed, step, STREAMS.index(stream)])
    return int(ss.generate_state(word + 1, np.uint64)[word])


def step_rngs(seed: int, step: int, device) -> StepRngs:
    """The generators of one train step."""
    def on_device(stream, word=0):
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, step, stream, word))
        return gen

    return StepRngs(
        mixup=np.random.default_rng(stream_seed(seed, step, "mixup")),
        model=on_device("model"),
        aug=np.random.default_rng(stream_seed(seed, step, "aug")),
        aug_noise=on_device("aug", word=1))
