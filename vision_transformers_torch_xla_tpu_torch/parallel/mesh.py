"""Process group and device mesh: the data and model axes over
torch.distributed.

Counterpart of vision_transformers_torch_xla_tpu/parallel/mesh.py
(`init_distributed` :54-89, `create_mesh` :92-123, `axis_rules` :126-137).
The JAX trainer runs one process per host over all of its chips; the port
runs one process per GPU, launched by torchrun (launch/runner.py fans it
out over hosts), so a host of 4 cards is 4 processes and the world is the
number of GPUs:

    torchrun --nproc_per_node 4 -m \
        vision_transformers_torch_xla_tpu_torch.launch.main \
        --mesh_shape data:2,model:2 ...

`init_distributed` joins the group that torchrun's env describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): nccl on the card, gloo
with --device cpu. Without that env the world is one process with no
group. Unlike JAX (mesh.py:88-89), a rendezvous that fails raises: nothing
drops quietly to one process.

`create_mesh` resolves the (name, size) pairs of --mesh_shape as JAX does,
with JAX's errors, over the world's GPUs, into a `ProcessMesh`: the
DeviceMesh named as JAX names it, the last axis fastest, and the groups of
its axes. `data` carries the batch (DDP or FSDP2, parallel/sharding.py);
`model` carries the heads and the MLP's hidden dim (tensor parallelism) or,
under --param_sharding sp, the tokens (parallel/split.py). A mesh smaller
than the world takes the first ranks, as JAX takes the first devices
(:113-115): the others sit out, and every group the trainer uses is the
mesh's or one of its axes', never the default group.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
from typing import Dict, Optional, Sequence, Tuple

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
    than n is JAX's device subset: its product is what the mesh uses."""
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
    if want > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return dict(zip(names, sizes))


def check_axes(axes: Sequence[Tuple[str, int]], param_sharding: str) -> None:
    """Raise on what the rules cannot place: an unknown --param_sharding
    (ValueError), and an axis other than `data` and `model` of a size
    above 1, which no logical axis maps to (JAX would run every step on it
    twice over; the port refuses it)."""
    if param_sharding not in ("replicated", "fsdp", "sp"):
        raise ValueError(f"--param_sharding {param_sharding!r}: one of "
                         f"replicated, fsdp, sp")
    for name, size in axes:
        if name not in ("data", "model") and size != 1:
            raise ValueError(
                f"mesh axis {name}:{size}: the rules map batch to 'data' "
                f"and heads, mlp and tokens to 'model'; no axis maps to "
                f"{name!r}")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place on the mesh of --mesh_shape.

    `device_mesh` is the torch DeviceMesh over the first `len(ranks)`
    ranks, named as JAX names its axes; `group` holds every rank of the
    mesh (never the default group: ranks past the mesh sit out), and
    `member` says whether this process is one of them. The last axis is
    the fastest, as in JAX's reshape (mesh.py:123): on a (data, model)
    mesh rank = d·M + m."""

    device_mesh: object
    sizes: Dict[str, int]
    ranks: Tuple[int, ...]
    group: object
    member: bool

    def size(self, name: str) -> int:
        return self.sizes.get(name, 1)

    def index(self, name: str) -> int:
        """This rank's coordinate on axis `name` (0 on an axis the mesh
        lacks)."""
        if name not in self.sizes:
            return 0
        return self.device_mesh.get_local_rank(name)

    def axis_group(self, name: str):
        """The group of this rank's peers along `name`: the ranks whose
        other coordinates equal this rank's. None on an axis the mesh
        lacks."""
        if name not in self.sizes:
            return None
        return self.device_mesh.get_group(name)


def create_mesh(axes: Sequence[Tuple[str, int]] = (("data", -1),),
                device: Optional[torch.device] = None
                ) -> Optional[ProcessMesh]:
    """The N-D mesh over the group's ranks (a collective: every rank of the
    world calls it), or None without a group (one process: every
    sharding is the plain model). A mesh smaller than the world takes the
    first ranks, as JAX takes the first devices (:113-115); the rest are
    logged and sit out."""
    rank, n = world()
    sizes = mesh_sizes(axes, n)
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(sizes)
    want = math.prod(sizes.values())
    ranks = tuple(range(want))
    device_mesh = DeviceMesh(
        (device or torch.device("cpu")).type,
        torch.arange(want).reshape(tuple(sizes.values())),
        mesh_dim_names=names)
    member = rank < want
    if len(names) > 1:
        # every rank of the world takes part in making a group
        group = dist.new_group(list(ranks), timeout=GROUP_TIMEOUT)
    else:
        group = device_mesh.get_group() if member else None
    if want < n:
        log.warning("mesh %s uses ranks 0-%d of %d: ranks %d-%d sit out",
                    sizes, want - 1, n, want, n - 1)
    return ProcessMesh(device_mesh, sizes, ranks,
                       group if member else None, member)


def axis_rules(param_sharding: str = "replicated", mesh=None):
    """Logical -> mesh rules by --param_sharding (JAX :126-137), dropping
    mappings to axes the mesh lacks (a DeviceMesh or a ProcessMesh)."""
    rules = {"fsdp": FSDP_AXIS_RULES, "sp": SP_AXIS_RULES}.get(
        param_sharding, LOGICAL_AXIS_RULES)
    if mesh is None:
        return rules
    names = mesh.sizes if isinstance(mesh, ProcessMesh) else \
        mesh.mesh_dim_names
    return tuple((lg, p if p in names else None) for lg, p in rules)
