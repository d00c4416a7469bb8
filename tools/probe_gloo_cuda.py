#!/usr/bin/env python3
"""Which torch.distributed collectives gloo runs on CUDA tensors.

Two ranks on one card (cuda:0), joined over gloo on 127.0.0.1: each rank
tries, in turn, the collectives the port's data axis uses on CUDA tensors
(all_reduce, broadcast, all_to_all_single with uneven splits,
all_gather_into_tensor, reduce_scatter_tensor), then a DDP step and an
FSDP2 (`fully_shard`) step of a small model. Rank 0 prints one line for
each, `ok` or the error. NCCL refuses two ranks on one card, so this is
what decides whether a one-card smoke can run FSDP2 across two ranks.

    python tools/probe_gloo_cuda.py

Needs one NVIDIA GPU; imports nothing of JAX.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

WORLD = 2


def rank_main(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    from torch import nn

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))

    def all_to_all():
        x = torch.full((4, 3), float(rank), device=dev)
        out = torch.empty_like(x)
        splits = [0] * WORLD
        splits[WORLD - 1 - rank] = 4
        dist.all_to_all_single(out, x, splits, splits)
        assert out.eq(WORLD - 1 - rank).all()

    def gather():
        out = torch.empty(WORLD * 3, device=dev)
        dist.all_gather_into_tensor(out, torch.full((3,), float(rank),
                                                    device=dev))
        assert out.tolist() == [0.0] * 3 + [1.0] * 3

    def scatter():
        out = torch.empty(3, device=dev)
        dist.reduce_scatter_tensor(out, torch.ones(WORLD * 3, device=dev))
        assert out.eq(WORLD).all()

    def model():
        torch.manual_seed(0)
        return nn.Sequential(nn.Linear(8, 16), nn.Linear(16, 4)).to(dev)

    def ddp():
        from torch.nn.parallel import DistributedDataParallel

        m = DistributedDataParallel(model(), device_ids=[0])
        m(torch.randn(5, 8, device=dev)).sum().backward()

    def fsdp():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        mesh = init_device_mesh("cuda", (WORLD,), mesh_dim_names=("data",))
        m = model()
        for layer in m:
            fully_shard(layer, mesh=mesh)
        fully_shard(m, mesh=mesh)
        m(torch.randn(5, 8, device=dev)).sum().backward()
        torch.cuda.synchronize()

    probes = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(3, device=dev)),
        "broadcast": lambda: dist.broadcast(torch.ones(3, device=dev), 0),
        "all_to_all_single": all_to_all,
        "all_gather_into_tensor": gather,
        "reduce_scatter_tensor": scatter,
        "DDP step": ddp,
        "FSDP2 step": fsdp,
    }
    for name, probe in probes.items():
        try:
            probe()
            torch.cuda.synchronize()
            result = "ok"
        except Exception as e:  # the probe reports every failure
            result = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        if rank == 0:
            print(f"gloo on CUDA tensors, {name}: {result}", flush=True)
        # a rank whose probe failed may have left its peer waiting
        dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--rank", str(r), str(port)])
        for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return max(codes)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(main())
