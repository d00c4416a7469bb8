"""The port's multi-node runner (launch/runner.py): the per-node torchrun
commands and env, fail-fast with per-node logs, and one local fan-out in
which two one-process "nodes", started through a stand-in ssh (a local
shell), join one gloo group over c10d rendezvous and all-reduce their
ranks. No training: a few seconds."""
import os
import socket
import sys
import time

import pytest

from vision_transformers_torch_xla_tpu_torch.launch import runner


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def local_nodes(monkeypatch, tmp_path):
    """A working dir of its own and no GPU cleanup: the nodes are local
    shells of this machine."""
    code = tmp_path / "code"
    code.mkdir()
    monkeypatch.chdir(code)
    monkeypatch.setattr(runner, "STALE_CLEANUP", "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "NODE_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return code


@pytest.mark.parametrize("node", [0, 1])
def test_per_node_torchrun_commands_and_env(node):
    args = runner.parse_args([
        "--HOSTS", "gpu0,gpu1", "--NPROC_PER_NODE", "8", "--RDZV_PORT",
        "29500", "--COMMAND", "-m vision_transformers_torch_xla_tpu_torch."
        "launch.main --mesh_shape data:8,model:2"])
    assert args.HOSTS == ["gpu0", "gpu1"] and args.SCP_CODE
    cmd = runner.remote_command(node, args, tarball="code.tar.gz")
    assert cmd.startswith("mkdir -p ~/run && cd ~/run && tar xzf "
                          "~/run.tar.gz && " + runner.STALE_CLEANUP)
    assert f"export NODE_RANK={node} NNODES=2 && torchrun " in cmd
    assert cmd.endswith(
        f"torchrun --nnodes 2 --node_rank {node} --nproc_per_node 8 "
        f"--rdzv_backend c10d --rdzv_endpoint gpu0:29500 -m "
        f"vision_transformers_torch_xla_tpu_torch.launch.main --mesh_shape "
        f"data:8,model:2")
    no_code = runner.remote_command(node, args, tarball=None)
    assert "tar xzf" not in no_code


def test_the_tarball_leaves_out_git_and_builds(tmp_path):
    import tarfile

    for d in ("pkg", ".git", "build", "__pycache__"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "f.txt").write_text(d)
    path = runner.tar_workdir(str(tmp_path))
    try:
        with tarfile.open(path) as tar:
            names = tar.getnames()
    finally:
        os.remove(path)
    assert names == ["pkg", "pkg/f.txt"]


def test_fail_fast_and_per_node_logs(local_nodes, tmp_path):
    """Node 1 fails once node 0 has started; node 0, which would run for a
    minute, is stopped, and each node's output is in its own log."""
    fake = tmp_path / "fake_torchrun.sh"
    started = tmp_path / "node0_started"
    fake.write_text(
        '#!/bin/sh\necho "node $NODE_RANK: $*"\n'
        f'if [ "$NODE_RANK" = 0 ]; then touch {started}; sleep 60; fi\n'
        f'for i in $(seq 100); do [ -e {started} ] && exit 3; sleep 0.1; '
        'done\nexit 4\n')
    fake.chmod(0o755)
    logs = tmp_path / "logs"
    t0 = time.monotonic()
    rc = runner.main([
        "--HOSTS", "127.0.0.1,127.0.0.1", "--NPROC_PER_NODE", "1",
        "--COMMAND", "train.py", "--SSH", "bash -c", "--SCP_CODE", "false",
        "--REMOTE_DIR", str(tmp_path / "run"), "--TORCHRUN", str(fake),
        "--LOG_DIR", str(logs)])
    assert rc == 3
    assert time.monotonic() - t0 < 30
    for node in (0, 1):
        text = (logs / f"node_{node}.log").read_text()
        assert text.startswith(f"node {node}: --nnodes 2 --node_rank {node} ")
        assert text.rstrip().endswith("train.py")


def test_local_fan_out_joins_one_gloo_group(local_nodes, tmp_path):
    """Two one-process nodes through torchrun's c10d rendezvous on a free
    port: the code is tarred, copied and unpacked on each node, and the
    ranks' all-reduce gives 0 + 1 on both."""
    (local_nodes / "allreduce.py").write_text(
        "import os, datetime\n"
        "import torch, torch.distributed as dist\n"
        "dist.init_process_group('gloo', "
        "timeout=datetime.timedelta(seconds=60))\n"
        "t = torch.tensor([float(dist.get_rank())])\n"
        "dist.all_reduce(t)\n"
        "open(f'result_{dist.get_rank()}.txt', 'w').write("
        "f\"{os.environ['NODE_RANK']} {dist.get_world_size()} "
        "{t.item()}\")\n"
        "dist.destroy_process_group()\n")
    remote = tmp_path / "run"
    rc = runner.main([
        "--HOSTS", "127.0.0.1,127.0.0.1", "--NPROC_PER_NODE", "1",
        "--RDZV_PORT", str(_free_port()), "--COMMAND", "allreduce.py",
        "--SSH", "bash -c", "--SCP", "cp {src} {dst}",
        "--REMOTE_DIR", str(remote),
        "--TORCHRUN", f"{sys.executable} -m torch.distributed.run",
        "--LOG_DIR", str(tmp_path / "logs")])
    logs = {n: (tmp_path / "logs" / f"node_{n}.log").read_text()
            for n in (0, 1)}
    assert rc == 0, logs
    results = sorted((remote / f"result_{r}.txt").read_text().split()
                     for r in (0, 1))
    assert [r[1:] for r in results] == [["2", "1.0"], ["2", "1.0"]]
    assert sorted(r[0] for r in results) == ["0", "1"]
