"""The model and the step on the mesh: DDP, FSDP2, the model axis's split
and their exchanges.

Counterpart of vision_transformers_torch_xla_tpu/parallel/sharding.py. In
JAX the batch is sharded over the mesh's 'data' axis, the params carry
logical axes (parallel/mesh.py::axis_rules) and GSPMD inserts every
collective. Here each process holds its data index's rows of the global
batch and the wrappers and layers make the collectives:

  * the model axis first (`split_heads`, `split_tokens`;
    parallel/split.py): under the rules that map `heads`, `mlp` and
    `qkv_out` to 'model' each rank keeps its heads' and hidden columns'
    parts of the split layers (a narrower model); under sp (`seq_act` to
    'model') the blocks run on the rank's tokens.
  * --param_sharding replicated: `DistributedDataParallel` over the data
    axis's group (under sp over every rank of the mesh; see
    parallel/split.py for why the average then is the one-process
    gradient), whose all-reduce averages the ranks' gradients. The ranks'
    losses are means over equal batches, so the average is the gradient
    of the global mean, the JAX step's.
  * --param_sharding fsdp: FSDP2 (`fully_shard`) on each block, then on
    the root, over the 'data' axis: every parameter (of the narrower model
    under the model axis: FSDP2 over `data` on top of the split, 2-D as
    JAX's FSDP_AXIS_RULES are) becomes a DTensor sharded on dim 0 (JAX's
    rule shards the embed axis: a layout choice that changes no number);
    the forward all-gathers a block's weights, the backward
    reduce-scatters its gradients (averaged). No mixed-precision policy:
    the layers cast the fp32 weights to the compute dtype themselves
    (models/layers.py::Dense), as the JAX layers do.

The train state (params, moments, EMA) is built from the wrapped model's
parameters, so under FSDP it holds shards and under the model axis parts;
`local` gives the tensor a rank updates, `full` gathers a whole tensor,
`copy_full_into` writes a whole tensor into a live one's part. A tensor
cut over the model axis also needs its `Split` (the train state's
`splits`, by name).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from vision_transformers_torch_xla_tpu_torch.core.rng import BatchShard
from vision_transformers_torch_xla_tpu_torch.models.layers import (
    Attention,
    AttentionPoolLatent,
    Dense,
    Mlp,
    ParallelScalingBlock,
)
from vision_transformers_torch_xla_tpu_torch.parallel.mesh import (
    ProcessMesh,
    axis_rules,
)
from vision_transformers_torch_xla_tpu_torch.parallel.split import (
    ModelAxis,
    Split,
)


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (the tensor itself otherwise); under
    no_grad it is the storage the DTensor owns, so in-place ops update it."""
    return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor, split: Optional[Split] = None) -> torch.Tensor:
    """The whole tensor of a DTensor, of a part cut over the model axis by
    `split`, or of both (a collective: every rank calls it); the tensor
    itself otherwise."""
    t = t.full_tensor() if is_sharded(t) else t
    return split.join(t) if split is not None else t


def local_rows(whole: torch.Tensor, like: torch.Tensor,
               split: Optional[Split] = None) -> torch.Tensor:
    """The part of `whole` that `like` holds on this rank: its model-axis
    part by `split`, then FSDP2's dim-0 shard of that (torch.chunk's rows,
    empty past the last chunk), or `whole`."""
    if split is not None:
        whole = split.rows(whole)
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
def copy_full_into(live: torch.Tensor, whole: torch.Tensor,
                   split: Optional[Split] = None) -> None:
    """Copy a whole tensor into `live`, or into its part."""
    local(live).copy_(local_rows(whole.to(live.device), live, split))


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


def model_axis(mesh: Optional[ProcessMesh]) -> Optional[ModelAxis]:
    """This rank's place on the mesh's `model` axis; None without one of a
    size above 1."""
    if mesh is None or mesh.size("model") == 1:
        return None
    return ModelAxis(mesh.axis_group("model"), mesh.index("model"),
                     mesh.size("model"))


def _divides(what: str, n: int, axis: ModelAxis) -> None:
    if n % axis.count:
        raise ValueError(f"{what} {n} does not split over the model axis "
                         f"of {axis.count}")


def split_heads(model: nn.Module, axis: ModelAxis) -> Dict[str, Split]:
    """Tensor parallelism (the rules' `heads`, `mlp`, `qkv_out` on
    'model'): every `Attention` and `AttentionPoolLatent` keeps its rank's
    H/M heads (qkv and kv column-parallel by head, so q, k and v of the
    same heads; proj row-parallel) and every `Mlp` its H/M hidden columns
    (fc1 column-parallel, both halves of a packed SwiGLU; fc2
    row-parallel), in place. Returns the `Split` of each cut parameter by
    name. A block the port cannot split raises NotImplementedError naming
    its ROADMAP item; nothing is left replicated in silence."""
    if hasattr(model, "stages"):
        raise NotImplementedError(
            f"{type(model).__name__}: tensor parallelism over the model "
            f"axis (its depthwise convs' channels and MLP columns) is not "
            f"in the port yet (ROADMAP M6b)")
    plan = []   # (module, attribute, parameter name, Split)

    def cut(prefix: str, dense: Dense, dim: int, parts: int = 1,
            bias: bool = True) -> None:
        plan.append((dense, "weight", f"{prefix}.weight",
                     Split(dim, parts, axis)))
        if bias and dense.bias is not None:
            plan.append((dense, "bias", f"{prefix}.bias",
                         Split(0, parts, axis)))

    for name, m in model.named_modules():
        if isinstance(m, ParallelScalingBlock):
            raise NotImplementedError(
                f"{name}: ParallelScalingBlock's fused in-projection on the "
                f"model axis is not in the port yet (ROADMAP M6b)")
        if isinstance(m, Attention):
            if m.norm is not None:
                raise NotImplementedError(
                    f"{name}: scale_attn_norm normalizes the heads of every "
                    f"rank together; on the model axis it is not in the "
                    f"port yet (ROADMAP M6b)")
            _divides(f"{name}: heads", m.num_heads, axis)
            cut(f"{name}.qkv", m.qkv, 0, 3)
            cut(f"{name}.proj", m.proj, 1, bias=False)
            m.heads_split = axis
        elif isinstance(m, AttentionPoolLatent):
            _divides(f"{name}: heads", m.num_heads, axis)
            cut(f"{name}.q", m.q, 0)
            cut(f"{name}.kv", m.kv, 0, 2)
            cut(f"{name}.proj", m.proj, 1, bias=False)
            m.heads_split = axis
        elif isinstance(m, Mlp):
            if m.norm is not None:
                raise NotImplementedError(
                    f"{name}: scale_mlp_norm normalizes the hidden columns "
                    f"of every rank together; on the model axis it is not "
                    f"in the port yet (ROADMAP M6b)")
            parts = 2 if m.glu else 1
            _divides(f"{name}: hidden", m.fc1.weight.shape[0] // parts, axis)
            cut(f"{name}.fc1", m.fc1, 0, parts)
            cut(f"{name}.fc2", m.fc2, 1, bias=False)
            m.hidden_split = axis
    splits = {}
    for module, attr, name, split in plan:
        p = getattr(module, attr)
        setattr(module, attr, nn.Parameter(split.rows(p.detach()),
                                           requires_grad=p.requires_grad))
        splits[name] = split
    return splits


def split_tokens(model: nn.Module, axis: ModelAxis) -> None:
    """Sequence parallelism (--param_sharding sp): the blocks run on the
    rank's tokens and each `Attention` in them gathers the sequence
    (models/vit.py, models/layers.py). The params stay whole. Dropout on
    the split tokens (proj_drop; attention's own dropout runs on the
    gathered scores and draws as the unsplit model does) raises
    NotImplementedError naming its ROADMAP item, as does a block the port
    cannot split."""
    if not hasattr(model, "seq_split"):
        raise NotImplementedError(
            f"{type(model).__name__}: --param_sharding sp is in the port "
            f"for the VisionTransformer alone (ROADMAP M6b)")
    for name, m in model.blocks.named_modules():
        if isinstance(m, ParallelScalingBlock):
            raise NotImplementedError(
                f"blocks.{name}: ParallelScalingBlock under --param_sharding "
                f"sp is not in the port yet (ROADMAP M6b)")
        rate = m.proj_drop if isinstance(m, Attention) else \
            m.drop if isinstance(m, Mlp) else 0.0
        if rate > 0.0:
            raise NotImplementedError(
                f"blocks.{name}: dropout on the tokens split over the "
                f"model axis (proj_drop) is not in the port yet "
                f"(ROADMAP M6b)")
        if isinstance(m, Attention):
            m.seq_split = axis
    model.seq_split = axis


def fsdp_units(model: nn.Module) -> list:
    """The modules FSDP2 wraps before the root: each block, a ConvNeXt's
    `stages.S.blocks.B`."""
    if hasattr(model, "stages"):
        return [blk for stage in model.stages for blk in stage.blocks]
    return list(model.blocks)


def wrap_model(model: nn.Module, mesh: Optional[ProcessMesh],
               param_sharding: str, unreached: Sequence[str] = ()
               ) -> Tuple[nn.Module, Dict[str, Split]]:
    """The model on the mesh, and the `Split` of each parameter cut over
    the model axis: the model axis's split (`split_heads`, or under sp
    `split_tokens`), then FSDP2 on each block (`fsdp_units`) and the root
    over 'data' when the rules shard the params' embed axis there (--param_sharding
    fsdp), else DDP over the data axis's group (under sp over the whole
    mesh's). `unreached` (`unreached_parameters`) turns on DDP's search
    for parameters without a gradient. No mesh: the model."""
    if mesh is None:
        return model, {}
    rules = dict(axis_rules(param_sharding, mesh))
    axis = model_axis(mesh)
    splits = {}
    tokens = rules["seq_act"] == "model"
    if axis is not None:
        if tokens:
            split_tokens(model, axis)
        else:
            splits = split_heads(model, axis)
    if rules["embed"] == "data":
        data = mesh.device_mesh["data"]
        for blk in fsdp_units(model):
            fully_shard(blk, mesh=data)
        fully_shard(model, mesh=data)
        return model, splits
    group = mesh.group if tokens else mesh.axis_group("data")
    if group is None:   # no data axis: nothing to average
        return model, splits
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group,
        find_unused_parameters=bool(unreached)), splits


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


def _exchange(x: torch.Tensor, shard: BatchShard) -> torch.Tensor:
    """The partner data index's x for ours (D−1−d, within the data axis's
    group): one all-to-all whose only non-empty split is the partner's."""
    splits = [0] * shard.count
    splits[shard.count - 1 - shard.index] = x.shape[0]
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=splits,
                           input_split_sizes=splits, group=shard.group)
    return out


def global_flip(shard: BatchShard) -> Callable:
    """flip(images, targets) -> the partners of this rank's rows in the
    global batch's flip: data index D−1−d's rows, reversed. The two travel
    in one exchange when their dtypes agree."""

    def flip(images: torch.Tensor, targets: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = images.shape[0]
        if images.dtype == targets.dtype:
            both = torch.cat([images.reshape(b, -1), targets], dim=1)
            got = _exchange(both, shard).flip(0)
            n = images[0].numel()
            return got[:, :n].reshape(images.shape), got[:, n:]
        return (_exchange(images, shard).flip(0),
                _exchange(targets, shard).flip(0))

    return flip


def all_reduce_sum(values: Dict[str, torch.Tensor], group=None
                   ) -> Dict[str, torch.Tensor]:
    """The sums over `group`'s ranks of a dict of scalars, in one
    all-reduce."""
    keys = list(values)
    stacked = torch.stack([values[k].float() for k in keys])
    dist.all_reduce(stacked, group=group)
    return dict(zip(keys, stacked.unbind(0)))
