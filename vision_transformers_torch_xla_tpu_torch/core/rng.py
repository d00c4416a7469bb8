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

On a mesh every stream is seeded alike on every rank and draws for the
*global* batch, as the JAX step draws for its global array: data index d
of the data axis's D takes rows [d·b, (d+1)·b) of each per-sample draw
(`BatchShard`, `global_rand`), and the ranks of one data index (its
`model` peers) draw the same rows. So a step on the mesh draws what the
one-process step draws on the data indices' batches put end to end, bit
for bit. The per-batch draws (mixup's gate, λ and box; RandAugment's ops)
are the same on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

STREAMS = ("mixup", "model", "aug", "hess")


@dataclasses.dataclass
class StepRngs:
    mixup: np.random.Generator
    model: torch.Generator
    aug: np.random.Generator
    aug_noise: torch.Generator
    hess: torch.Generator       # AdaHessian's Rademacher probes


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
        aug_noise=on_device("aug", word=1), hess=on_device("hess"))


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This process's rows of the global batch: data index `index` of
    `count` holds rows [index·b, (index+1)·b) of a global batch of
    count·b. `group` joins the processes of the other data indices that
    share this process's place on the other axes (the data axis's group;
    None with one data index)."""

    index: int = 0
    count: int = 1
    group: object = dataclasses.field(default=None, compare=False)

    def rows(self, b: int) -> slice:
        return slice(self.index * b, (self.index + 1) * b)


_SHARD = [BatchShard()]


def current_shard() -> BatchShard:
    return _SHARD[-1]


@contextlib.contextmanager
def sharded_draws(shard: BatchShard):
    """Within the block, the model's per-sample draws (`global_rand`) take
    `shard`'s rows of the global batch's draw."""
    _SHARD.append(shard)
    try:
        yield shard
    finally:
        _SHARD.pop()


def global_rand(shape, generator: torch.Generator, device,
                normal: bool = False) -> torch.Tensor:
    """torch.rand (torch.randn with `normal`) of a batch-first local shape:
    with D > 1 data indices (`current_shard`) the rows of the draw for the
    global batch that are this process's."""
    fn = torch.randn if normal else torch.rand
    shard, shape = current_shard(), tuple(shape)
    if shard.count == 1:
        return fn(shape, generator=generator, device=device)
    b = shape[0]
    return fn((b * shard.count,) + shape[1:], generator=generator,
              device=device)[shard.rows(b)]
