"""Process group and device mesh: the data axis over torch.distributed.

Counterpart of vision_transformers_torch_xla_tpu/parallel/mesh.py
(`init_distributed` :54-89, `create_mesh` :92-123, `axis_rules` :126-137).
The JAX trainer runs one process per host over all of its chips; the port
runs one process per GPU, launched by torchrun, so a host of 4 cards is 4
processes and the world is the number of GPUs:

    torchrun --nproc_per_node 4 -m \
        vision_transformers_torch_xla_tpu_torch.launch.main ...

`init_distributed` joins the group that torchrun's env describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): nccl on the card, gloo
with --device cpu. Without that env the world is one process with no
group. Unlike JAX (mesh.py:88-89), a rendezvous that fails raises: nothing
drops quietly to one process.

`create_mesh` resolves the (name, size) pairs of --mesh_shape as JAX does,
with JAX's errors, over the world's GPUs. Only the data axis is ported:
a `model` axis larger than 1 (tensor parallelism), --param_sharding sp
and a mesh smaller than the world (JAX's device subset, :113-115) raise
naming ROADMAP M6.
"""
from __future__ import annotations

import datetime
import logging
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# JAX's logical-axis -> mesh-axis rules (mesh.py:28-51), by name: 'fsdp'
# shards the params' embed axis over 'data' (ZeRO-3), 'sp' the
# activations' token axis over 'model'; plain DP leaves params replicated.
LOGICAL_AXIS_RULES = (
    ("batch", "data"),
    ("heads", "model"),
    ("mlp", "model"),
    ("qkv_out", "model"),
    ("embed", None),
    ("seq", None),
    ("classes", None),
    ("patch", None),
    ("layers", None),
    ("seq_act", None),
)
FSDP_AXIS_RULES = LOGICAL_AXIS_RULES[:4] + (("embed", "data"),) + \
    LOGICAL_AXIS_RULES[5:]
SP_AXIS_RULES = tuple(
    (lg, "model" if lg == "seq_act" else (None if p == "model" else p))
    for lg, p in LOGICAL_AXIS_RULES)

TORCHRUN_ENV = ("RANK", "WORLD_SIZE")
# a rendezvous or collective that waits longer than this raises
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def torchrun_env() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def env_world() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from torchrun's env; (0, 1, 0)
    without it."""
    if not torchrun_env():
        return 0, 1, 0
    rank = int(os.environ["RANK"])
    return (rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", rank)))


def init_distributed(device: torch.device) -> torch.device:
    """Join the process group torchrun's env describes and return this
    process's device: cuda without an index becomes cuda:LOCAL_RANK, made
    current before the group comes up. A group that is already up (a
    caller started it) is kept, as JAX keeps one (mesh.py:63-64). Without
    the env there is no group. A failed rendezvous raises."""
    rank, size, local = env_world()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized() or not torchrun_env():
        return device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", rank=rank, world_size=size,
                            timeout=GROUP_TIMEOUT)
    log.info("torch.distributed: rank %d of %d (%s)", dist.get_rank(),
             dist.get_world_size(), dist.get_backend())
    return device


def world() -> Tuple[int, int]:
    """(rank, world size) of the group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_sizes(axes: Sequence[Tuple[str, int]], n: int) -> dict:
    """{name: size} of (name, size) pairs over n devices, one size -1
    (inferred), with JAX create_mesh's errors (:107-119). A mesh smaller
    than n (JAX's device subset) raises naming M6."""
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by fixed axes "
                             f"{known}")
        sizes[sizes.index(-1)] = n // known
    want = math.prod(sizes)
    if want < n:
        raise NotImplementedError(
            f"mesh {dict(zip(names, sizes))} on {n} devices: a mesh over a "
            f"subset of the processes is not in the port yet (ROADMAP M6)")
    if want != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return dict(zip(names, sizes))


def check_axes(axes: Sequence[Tuple[str, int]], param_sharding: str) -> None:
    """Raise, naming M6, on the parts of JAX's mesh the port lacks: any axis
    but `data` of a size other than 1 (tensor parallelism over `model`) and
    --param_sharding sp; an unknown --param_sharding is a ValueError."""
    if param_sharding == "sp":
        raise NotImplementedError(
            "--param_sharding sp (sequence parallelism) is not in the port "
            "yet (ROADMAP M6)")
    if param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"--param_sharding {param_sharding!r}: one of "
                         f"replicated, fsdp, sp")
    for name, size in axes:
        if name != "data" and size != 1:
            raise NotImplementedError(
                f"mesh axis {name}:{size}: only the data axis is in the "
                f"port yet; tensor parallelism is ROADMAP M6")


def create_mesh(axes: Sequence[Tuple[str, int]] = (("data", -1),),
                device: Optional[torch.device] = None):
    """The 1-D DeviceMesh named 'data' over the group's ranks, or None
    without a group (one process: both shardings are the plain model)."""
    sizes = mesh_sizes(axes, world()[1])
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh((device or torch.device("cpu")).type,
                            (sizes.get("data", 1),),
                            mesh_dim_names=("data",))


def axis_rules(param_sharding: str = "replicated", mesh=None):
    """Logical -> mesh rules by --param_sharding (JAX :126-137), dropping
    mappings to axes the mesh lacks."""
    rules = {"fsdp": FSDP_AXIS_RULES, "sp": SP_AXIS_RULES}.get(
        param_sharding, LOGICAL_AXIS_RULES)
    if mesh is None:
        return rules
    return tuple((lg, p if p in mesh.mesh_dim_names else None)
                 for lg, p in rules)
