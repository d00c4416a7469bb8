"""Multi-node runner: fan one torchrun command out to every GPU host.

Counterpart of vision_transformers_torch_xla_tpu/launch/runner.py, with
its operational features: the working directory tarred and copied to each
node (`--SCP_CODE`), stale processes cleaned up first, per-node env,
parallel ssh with fail-fast, and per-node logs under `--LOG_DIR`. JAX runs
one process per TPU VM and discovers the pod from gcloud; the port runs
torchrun on each host, which starts `--NPROC_PER_NODE` processes (one per
GPU) and joins every node through c10d rendezvous on the first host:

    python -m vision_transformers_torch_xla_tpu_torch.launch.runner \\
        --HOSTS gpu0,gpu1 --NPROC_PER_NODE 8 \\
        --COMMAND "-m vision_transformers_torch_xla_tpu_torch.launch.main \\
            --model my_vit_b --mesh_shape data:8,model:2 ..."

runs on node i (0-based, in --HOSTS order):

    torchrun --nnodes 2 --node_rank i --nproc_per_node 8 \\
        --rdzv_backend c10d --rdzv_endpoint gpu0:29400 <COMMAND>

There is nothing of gcloud: the hosts are a list, `--SSH` and `--SCP` are
command templates ({host}; {src}, {dst}), so any remote shell, or a local
one, carries the commands. Each node's shell exports NODE_RANK and
NNODES, as JAX's runner exports each worker's process id and count.
"""
from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

# processes still holding a GPU from an earlier run (JAX's runner frees the
# TPU the same way, reference multihost_runner_orig.py:177-198)
STALE_CLEANUP = ("sudo lsof -t /dev/nvidia[0-9]* 2>/dev/null | "
                 "xargs -r sudo kill -9; ")
# what the workdir tarball leaves out (build/ holds this machine's kernels)
TAR_SKIP = (".git", "__pycache__", ".jax_cache", "output", "build",
            "chiprun_out")


def tar_workdir(workdir: str) -> str:
    """Tar the working dir for the copy (reference :200-215)."""
    fd, path = tempfile.mkstemp(suffix=".tar.gz")
    os.close(fd)
    with tarfile.open(path, "w:gz") as tar:
        for entry in sorted(os.listdir(workdir)):
            if entry in TAR_SKIP:
                continue
            tar.add(os.path.join(workdir, entry), arcname=entry)
    return path


def torchrun_command(node_rank: int, hosts: Sequence[str], nproc: int,
                     port: int, command: str,
                     torchrun: str = "torchrun") -> str:
    """Node `node_rank`'s torchrun line: all nodes rendezvous (c10d) on the
    first host."""
    return (f"{torchrun} --nnodes {len(hosts)} --node_rank {node_rank} "
            f"--nproc_per_node {nproc} --rdzv_backend c10d "
            f"--rdzv_endpoint {hosts[0]}:{port} {command}")


def remote_command(node_rank: int, args, tarball: Optional[str]) -> str:
    """What node `node_rank`'s shell runs: unpack the code, clean up, export
    the env, run torchrun (reference :257-270)."""
    hosts = args.HOSTS
    exports = f"export NODE_RANK={node_rank} NNODES={len(hosts)} && "
    setup = (f"mkdir -p {args.REMOTE_DIR} && cd {args.REMOTE_DIR} && "
             + (f"tar xzf {args.REMOTE_DIR}.tar.gz && " if tarball else "")
             + STALE_CLEANUP)
    return setup + exports + torchrun_command(
        node_rank, hosts, args.NPROC_PER_NODE, args.RDZV_PORT, args.COMMAND,
        args.TORCHRUN)


def run_node(node_rank: int, args, tarball: Optional[str],
             procs: Dict[int, subprocess.Popen], lock: threading.Lock,
             stop: threading.Event) -> int:
    """Copy the code to one node and run its command over the --SSH
    template, its output into LOG_DIR/node_<i>.log (reference
    :237-294)."""
    host = args.HOSTS[node_rank]
    logfile = os.path.join(args.LOG_DIR, f"node_{node_rank}.log")
    with open(logfile, "w") as log:
        if tarball:
            copy = shlex.split(args.SCP.format(
                src=tarball, host=host, dst=f"{args.REMOTE_DIR}.tar.gz"))
            r = subprocess.run(copy, stdout=log, stderr=subprocess.STDOUT,
                               timeout=600)
            if r.returncode != 0:
                return r.returncode
        with lock:
            if stop.is_set():
                return -1
            # a session of its own: fail-fast stops the shell and its
            # children together
            p = subprocess.Popen(
                shlex.split(args.SSH.format(host=host))
                + [remote_command(node_rank, args, tarball)],
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
            procs[node_rank] = p
        return p.wait()


def parse_args(argv=None):
    ap = argparse.ArgumentParser("multi-node torchrun runner")
    ap.add_argument("--HOSTS", required=True,
                    type=lambda s: [h for h in s.split(",") if h],
                    help="comma-separated hosts; the first hosts the "
                         "rendezvous")
    ap.add_argument("--COMMAND", required=True,
                    help="what torchrun runs, e.g. '-m "
                         "vision_transformers_torch_xla_tpu_torch.launch."
                         "main --model my_vit_b'")
    ap.add_argument("--NPROC_PER_NODE", type=int, default=8)
    ap.add_argument("--RDZV_PORT", type=int, default=29400)
    ap.add_argument("--SCP_CODE", type=lambda s: s.lower() != "false",
                    default=True)
    ap.add_argument("--LOG_DIR", default="./runner_logs")
    ap.add_argument("--REMOTE_DIR", default="~/run",
                    help="where each node unpacks and runs the code")
    ap.add_argument("--SSH", default="ssh -o BatchMode=yes {host}",
                    help="remote shell; the node's command is its last "
                         "argument")
    ap.add_argument("--SCP", default="scp {src} {host}:{dst}")
    ap.add_argument("--TORCHRUN", default="torchrun")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    n = len(args.HOSTS)
    print(f"{n} node(s) x {args.NPROC_PER_NODE} process(es), rendezvous on "
          f"{args.HOSTS[0]}:{args.RDZV_PORT}")
    os.makedirs(args.LOG_DIR, exist_ok=True)
    tarball = tar_workdir(os.getcwd()) if args.SCP_CODE else None
    procs: Dict[int, subprocess.Popen] = {}
    lock, stop = threading.Lock(), threading.Event()
    codes: List[Optional[int]] = [None] * n
    done = threading.Condition()

    def work(i):
        code = run_node(i, args, tarball, procs, lock, stop)
        with done:
            codes[i] = code
            done.notify()

    t0 = time.time()
    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    rc = 0
    try:
        with done:
            while any(c is None for c in codes):
                done.wait()
                failed = [i for i, c in enumerate(codes)
                          if c is not None and c != 0]
                if failed and not stop.is_set():
                    i = failed[0]
                    rc = codes[i]
                    print(f"node {i} FAILED (rc={rc}); see "
                          f"{args.LOG_DIR}/node_{i}.log")
                    # fail-fast: stop the other nodes (reference :350-354)
                    with lock:
                        stop.set()
                        for j, p in procs.items():
                            if j != i and p.poll() is None:
                                os.killpg(p.pid, signal.SIGTERM)
    finally:
        for t in threads:
            t.join()
        if tarball:
            os.remove(tarball)
    print(f"done in {time.time() - t0:.0f}s (rc={rc})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
