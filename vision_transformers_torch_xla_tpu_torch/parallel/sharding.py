"""The model and the step on the data axis: DDP, FSDP2 and their exchanges.

Counterpart of vision_transformers_torch_xla_tpu/parallel/sharding.py. In
JAX the batch is sharded over the mesh's 'data' axis, the params carry
logical axes (parallel/mesh.py::axis_rules) and GSPMD inserts every
collective. Here each process holds its rows of the global batch and the
wrapper makes the collectives:

  * --param_sharding replicated: `DistributedDataParallel`, whose
    all-reduce averages the ranks' gradients. The ranks' losses are means
    over equal batches, so the average is the gradient of the global mean,
    the JAX step's.
  * --param_sharding fsdp: FSDP2 (`fully_shard`) on each block, then on
    the root, over the 1-D 'data' mesh. Every parameter becomes a DTensor
    sharded on dim 0 (JAX's rule shards the embed axis: a layout choice
    that changes no number); the forward all-gathers a block's weights,
    the backward reduce-scatters its gradients (averaged). No
    mixed-precision policy: the layers cast the fp32 weights to the compute
    dtype themselves (models/layers.py::Dense), as the JAX layers do.

The train state (params, moments, EMA) is built from the wrapped model's
parameters, so under FSDP it holds shards; `local` gives the shard a
rank updates, `full` gathers a whole tensor, `copy_full_into` writes a
whole tensor into a live one's shard.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from vision_transformers_torch_xla_tpu_torch.core.rng import BatchShard
from vision_transformers_torch_xla_tpu_torch.parallel.mesh import axis_rules


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (the tensor itself otherwise); under
    no_grad it is the storage the DTensor owns, so in-place ops update it."""
    return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank calls it);
    the tensor itself otherwise."""
    return t.full_tensor() if is_sharded(t) else t


def local_rows(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of `whole` that `like` holds on this rank: FSDP2's dim-0
    shard (torch.chunk's rows, empty past the last chunk), or `whole`."""
    if not is_sharded(like):
        return whole
    mesh = like.device_mesh
    n, r = mesh.size(), mesh.get_local_rank()
    chunks = torch.chunk(whole, n, dim=0)
    part = chunks[r] if r < len(chunks) else whole[:0]
    want = like.to_local().shape
    if part.shape != want:
        raise ValueError(f"shard {tuple(part.shape)} of {tuple(whole.shape)}"
                         f" does not fit the live shard {tuple(want)}")
    return part


@torch.no_grad()
def copy_full_into(live: torch.Tensor, whole: torch.Tensor) -> None:
    """Copy a whole tensor into `live`, or into its shard."""
    local(live).copy_(local_rows(whole.to(live.device), live))


def unwrap(model: nn.Module) -> nn.Module:
    """The model inside DDP (FSDP2 wraps in place)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def is_fsdp(model: nn.Module) -> bool:
    return isinstance(model, FSDPModule)


def unreached_parameters(meta_model: nn.Module,
                         input_shape: Sequence[int]) -> list:
    """Names of the parameters that no gradient reaches: one forward and
    backward of `meta_model` (the model's own configuration, built on the
    meta device, so nothing is computed) on an input of `input_shape`."""
    x = torch.zeros(tuple(input_shape), device="meta")
    meta_model(x, True).float().sum().backward()
    return [k for k, p in meta_model.named_parameters() if p.grad is None]


def wrap_model(model: nn.Module, mesh, param_sharding: str,
               unreached: Sequence[str] = ()) -> nn.Module:
    """The model on the mesh's data axis: DDP, or FSDP2 on each block and
    the root when the rules shard the params' embed axis over 'data'
    (--param_sharding fsdp). `unreached` (`unreached_parameters`) turns on
    DDP's search for parameters without a gradient. No mesh: the model."""
    if mesh is None:
        return model
    if dict(axis_rules(param_sharding, mesh))["embed"] == "data":
        for blk in model.blocks:
            fully_shard(blk, mesh=mesh)
        fully_shard(model, mesh=mesh)
        return model
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=mesh.get_group(),
        find_unused_parameters=bool(unreached))


@contextlib.contextmanager
def params_swapped_in(model: nn.Module,
                      params: Mapping[str, torch.Tensor]):
    """Within the block the FSDP model's shards hold `params`' (the EMA's,
    for an eval), and get their own back after it. FSDP2 all-gathers its
    own shards, so a functional call cannot pass other params through."""
    live = dict(model.named_parameters())
    swapped = {k: local(p).clone() for k, p in live.items()
               if params[k] is not p}
    with torch.no_grad():
        for k in swapped:
            local(live[k]).copy_(local(params[k]))
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, saved in swapped.items():
                local(live[k]).copy_(saved)


def _exchange(x: torch.Tensor, partner: int, world: int) -> torch.Tensor:
    """`partner`'s x for ours: one all-to-all whose only non-empty split
    is the partner's."""
    splits = [0] * world
    splits[partner] = x.shape[0]
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=splits,
                           input_split_sizes=splits)
    return out


def global_flip(shard: BatchShard) -> Callable:
    """flip(images, targets) -> the partners of this rank's rows in the
    global batch's flip: rank W−1−r's rows, reversed. The two travel in one
    exchange when their dtypes agree."""
    partner = shard.world - 1 - shard.rank

    def flip(images: torch.Tensor, targets: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = images.shape[0]
        if images.dtype == targets.dtype:
            both = torch.cat([images.reshape(b, -1), targets], dim=1)
            got = _exchange(both, partner, shard.world).flip(0)
            n = images[0].numel()
            return got[:, :n].reshape(images.shape), got[:, n:]
        return (_exchange(images, partner, shard.world).flip(0),
                _exchange(targets, partner, shard.world).flip(0))

    return flip


def all_reduce_sum(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' sums of a dict of scalars, in one all-reduce."""
    keys = list(values)
    stacked = torch.stack([values[k].float() for k in keys])
    dist.all_reduce(stacked)
    return dict(zip(keys, stacked.unbind(0)))
