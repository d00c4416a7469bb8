"""Time the PyTorch port's attention kernels on one NVIDIA GPU.

The port is imported from the checkout given by --repo (by default the one
this script sits in), so that two trees can be compared in turns from one
command, each in its own process: for example with the parent commit
unpacked by `git archive` under build/parent,

    for t in build/parent . . build/parent; do
        python tools/time_torch_attention.py --repo $t --batch 128
    done

or, for the long-sequence kernels (K4, K5, K6) at the 518-px model's
shape, `--batch 32 --seq 1370 --kernels flash_fwd flash_bwd_dkdv
flash_bwd_dq sdpa_fwd sdpa_bwd --profile`.

Each run prints one JSON line: the tree, the card's name and power limit
(nvidia-smi), per kernel the median CUDA-event time of one call (host
launch cost included) in each of --rounds rounds, on seeded inputs of
--dtype (bfloat16 by default; float16 and float32 run the kernels' other
instantiations, which trees before they existed refuse) at (B, S, H, D) =
(--batch, --seq, --heads (12 by default), --head_dim), and ptxas's
registers and spills for each kernel this process built (none when
build/kernels/ held it; with --build_all every library of the tree is
built first, so that two trees' ptxas reports can be compared kernel by
kernel). A kernel the tree cannot run at the shape (before the head dims
over 128 ran on them, K1, K2, K9 and K10 raised there) gets its error
message under "errors", and the others are timed.
With --profile it adds, from a torch.profiler trace of 10 calls of each
wrapper, the device time per call of each CUDA kernel it launched (the
backward's dq and dk/dv launches apart).
The kernels are named by their wrappers in ops/flash_attention.py: attn_fwd
(K1, with the row stats) and attn_bwd (K2, from K1's o and stats), hp_fwd
(K9) and hp_bwd (K10), which every tree since they were ported has, and
fused_fwd, fused_bwd, qkv_fwd, qkv_bwd (K7, K8, K11, K12); flash_fwd is
ops/flash_blocked.py's (K4), on q, k, v read from a (B, S, 3·H·D)
projection as the model's path reads them, and flash_bwd_dkdv and
flash_bwd_dq (K5, K6) from K4's o and lse, with dO a view of (B, S, H, D)
memory and dq, dk, dv views of one (B, S, 3·H·D) buffer, as
`flash_bwd` lays them out; flash_delta the torch op that gives them delta
(`flash_bwd` runs the three). mha_fwd_bwd is the op-level entry point
`multi_head_attention(use_pallas=True)`, forward and backward (K7 and K8),
on the (B, H, S, D) q, k, v of fused_fwd. fc2_bwd is ops/mlp_fused.py's
K3 on dy (B, S, 768), the fc2 weight (768, 3072) and h (B, S, 3072), and
fc2_unfused the default path's work for the same result (cuBLAS da,
autograd's GELU backward, the fp32 bias sum), its yardstick. sdpa_fwd and
sdpa_bwd (its whole backward, dq, dk and dv) are the attention's
yardstick, torch's scaled_dot_product_attention on contiguous copies of
those q, k, v, which the port never calls. attn_fwd_plain and
fused_fwd_plain are the plain versions of K1 (attn_fwd_reference, with the
stats) and K7 (fused_fwd_reference) on the same inputs, which K9's and
K11's plain versions repeat; attn_bwd_plain and fused_bwd_plain those of K2
(attn_bwd_reference, on K1's o and stats) and K8 (fused_bwd_reference,
which K10's and K12's repeat); flash_fwd_plain is K4's
(flash_fwd_reference), flash_bwd_dkdv_plain and flash_bwd_dq_plain K5's
and K6's (flash_bwd_dkdv_reference, flash_bwd_dq_reference) on K4's lse
and delta.

The fp32 forwards on csrc/attn_fwd_simt.cuh's register tiles against the
parent's loops, at a head dim of 256:

    python tools/time_torch_attention.py --dtype float32 --head_dim 256 \
        --batch 32 --kernels attn_fwd hp_fwd fused_fwd qkv_fwd --profile

and the wide backward (K2 in bf16 and fp16 on csrc/attn_bwd_tc.cu's wide
tiles, K8, K10 and K12 in fp32 on csrc/hp_bwd_simt.cu's):

    python tools/time_torch_attention.py --head_dim 256 --batch 32 \
        --kernels attn_bwd attn_bwd_plain sdpa_bwd --profile
    python tools/time_torch_attention.py --dtype float32 --head_dim 256 \
        --batch 32 --kernels fused_bwd hp_bwd qkv_bwd fused_bwd_plain \
        sdpa_bwd --profile

and K6 on the tensor cores in fp16 and past 128 (csrc/flash_bwd.cu), the
fp32 K2 past 128 (csrc/attn_bwd_simt.cu):

    python tools/time_torch_attention.py --dtype float16 --batch 32 \
        --seq 1370 --kernels flash_bwd_dq flash_bwd_dq_plain sdpa_bwd \
        --profile
    python tools/time_torch_attention.py --batch 1 --seq 1370 --heads 4 \
        --head_dim 256 --kernels flash_bwd_dq flash_bwd_dq_plain sdpa_bwd
    python tools/time_torch_attention.py --dtype float32 --head_dim 256 \
        --batch 32 --kernels attn_bwd attn_bwd_plain sdpa_bwd --profile

and the fp32 K4 and K5 past 128 (the wide register tiles of
csrc/flash_fwd_simt.cu and csrc/flash_bwd_simt.cu; --reps 10 at B 32,
where the parent's loops take ~0.1-0.3 s a call):

    python tools/time_torch_attention.py --dtype float32 --batch 32 \
        --seq 1370 --head_dim 256 --kernels flash_fwd flash_bwd_dkdv \
        flash_fwd_plain flash_bwd_dkdv_plain sdpa_fwd sdpa_bwd --profile
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def seeded(shape, seed: int, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


def calls(fa, fb, mf, b: int, s: int, H: int, D: int, dtype):
    """Each kernel's wrapper call on its seeded inputs."""
    qkv = seeded((b, s, 3 * H * D), 1, dtype)
    do = seeded((b, s, H * D), 2, dtype)
    q, k, v, g = (seeded((b, H, s, D), 3 + i, dtype) for i in range(4))
    qkv5 = qkv.view(b, s, 3, H, D)
    heads = fb.heads(qkv, H)
    dense = [t.detach().contiguous().requires_grad_() for t in heads]
    dob = do.view(b, s, H, D).transpose(1, 2)
    state = {}
    attention = importlib.import_module(
        fa.__name__.rsplit(".", 1)[0] + ".attention")

    def blocked_bwd(name):
        # K4's o and lse once, then the backward kernel alone
        if not state:
            o, lse = fb.flash_fwd(*heads)
            state["delta"], state["lse"] = fb.flash_delta(o, dob), lse
            state["o"] = o
            state["grads"] = fb.heads(torch.empty_like(qkv), H)
        dq, dk, dv = state["grads"]
        args = (*heads, dob, state["lse"], state["delta"])
        if name == "delta":  # the row sums the backward kernels start from
            return fb.flash_delta(state["o"], dob)
        if name == "dkdv":
            return fb.flash_bwd_dkdv(*args, dk, dv)
        if name == "dq_plain":
            return fb.flash_bwd_dq_reference(*args, D ** -0.5)
        if name == "dkdv_plain":
            return fb.flash_bwd_dkdv_reference(*args, D ** -0.5)
        return fb.flash_bwd_dq(*args, dq)

    def attn_bwd(plain=False):
        # K1's o and row stats once, then K2 (or its plain version) alone
        if "stats" not in state:
            state["stats"] = fa.attn_fwd(qkv, H, with_stats=True)
        if plain:
            return fa.attn_bwd_reference(qkv, do, *state["stats"], H,
                                         D ** -0.5)
        return fa.attn_bwd(qkv, do, *state["stats"], H)

    def mha_fwd_bwd():
        # the entry point's forward and backward on leaves of q, k, v
        if "leaves" not in state:
            state["leaves"] = [t.detach().clone().requires_grad_()
                               for t in (q, k, v)]
        leaves = state["leaves"]
        o = attention.multi_head_attention(*leaves, use_pallas=True)
        return torch.autograd.grad(o, leaves, g)

    def fc2_inputs():
        if "fc2" not in state:
            state["fc2"] = (seeded((b, s, 768), 7, dtype),
                            seeded((768, 3072), 8, dtype) * 0.02,
                            seeded((b, s, 3072), 9, dtype))
        return state["fc2"]

    def fc2_unfused():
        dy, w2, h = fc2_inputs()
        dh = torch.ops.aten.gelu_backward(torch.matmul(dy, w2), h,
                                          approximate="tanh")
        return dh, dh.sum(dim=(0, 1), dtype=torch.float32)

    def sdpa_bwd():
        if "sdpa" not in state:
            state["sdpa"] = \
                torch.nn.functional.scaled_dot_product_attention(*dense)
        return torch.autograd.grad(state["sdpa"], dense, dob.contiguous(),
                                   retain_graph=True)

    return {
        "flash_fwd": lambda: fb.flash_fwd(*heads),
        "flash_fwd_plain": lambda: fb.flash_fwd_reference(*heads, D ** -0.5),
        "flash_bwd_dkdv": lambda: blocked_bwd("dkdv"),
        "flash_bwd_dkdv_plain": lambda: blocked_bwd("dkdv_plain"),
        "flash_bwd_dq": lambda: blocked_bwd("dq"),
        "flash_bwd_dq_plain": lambda: blocked_bwd("dq_plain"),
        "flash_delta": lambda: blocked_bwd("delta"),
        "sdpa_fwd": lambda: torch.nn.functional.scaled_dot_product_attention(
            *dense),
        "sdpa_bwd": sdpa_bwd,
        "attn_fwd": lambda: fa.attn_fwd(qkv, H, with_stats=True),
        "attn_bwd": attn_bwd,
        "attn_bwd_plain": lambda: attn_bwd(plain=True),
        "hp_fwd": lambda: fa.hp_fwd(qkv, H),
        "hp_bwd": lambda: fa.hp_bwd(qkv, do, H),
        "attn_fwd_plain": lambda: fa.attn_fwd_reference(
            qkv, H, D ** -0.5, with_stats=True),
        "fused_fwd": lambda: fa.fused_fwd(q, k, v),
        "fused_fwd_plain": lambda: fa.fused_fwd_reference(q, k, v,
                                                          D ** -0.5),
        "fused_bwd": lambda: fa.fused_bwd(q, k, v, g),
        "fused_bwd_plain": lambda: fa.fused_bwd_reference(q, k, v, g,
                                                          D ** -0.5),
        "qkv_fwd": lambda: fa.qkv_fwd(qkv5),
        "qkv_bwd": lambda: fa.qkv_bwd(qkv5, do),
        "mha_fwd_bwd": mha_fwd_bwd,
        "fc2_bwd": lambda: mf.fc2_bwd(*fc2_inputs()),
        "fc2_unfused": fc2_unfused,
    }


def profile(fn, calls: int = 10):
    """Device time per call, in ms, of each CUDA kernel `fn` launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type.name == "CUDA":
            out[e.key[:80]] = us / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--kernels", nargs="+", default=["hp_fwd", "hp_bwd"])
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--build_all", action="store_true",
                    help="build every library of the tree first (ptxas)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true",
                    help="add each launched CUDA kernel's device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    fa = importlib.import_module(
        "vision_transformers_torch_xla_tpu_torch.ops.flash_attention")
    fb = importlib.import_module(
        "vision_transformers_torch_xla_tpu_torch.ops.flash_blocked")
    cuda_build = importlib.import_module(
        "vision_transformers_torch_xla_tpu_torch.ops.cuda_build")
    mf = importlib.import_module(
        "vision_transformers_torch_xla_tpu_torch.ops.mlp_fused")
    if args.build_all:  # one nvcc per library, all started together
        from concurrent.futures import ThreadPoolExecutor

        builds = [getattr(mod, name) for mod in (fa, fb, mf)
                  for name in dir(mod) if name.startswith("build_")]
        with ThreadPoolExecutor(len(builds)) as pool:
            list(pool.map(lambda build: build(), builds))
    fns = calls(fa, fb, mf, args.batch, args.seq, args.heads, args.head_dim,
                getattr(torch, args.dtype))
    unknown = sorted(set(args.kernels) - set(fns))
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; known: {sorted(fns)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    ms, errors = {}, {}
    for name in args.kernels:
        try:
            ms[name] = [cuda_ms(fns[name], args.reps)
                        for _ in range(args.rounds)]
        except (ValueError, RuntimeError, TypeError) as e:
            errors[name] = str(e)[:300]
    out = {"tree": args.repo, "module": fa.__file__, "card": card,
           "shape": [args.batch, args.seq, args.heads, args.head_dim],
           "dtype": args.dtype,
           "ms": ms, "errors": errors}
    if args.profile:
        out["device_ms_per_call"] = {n: profile(fns[n]) for n in ms}
    out["ptxas"] = {name: [line.strip() for line in log.splitlines()
                    if "Function properties" in line or "registers" in line
                    or "spill" in line]
             for name, log in cuda_build.BUILD_LOGS.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
