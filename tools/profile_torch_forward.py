"""Time and profile the PyTorch port's my_vit_b forward on one NVIDIA GPU.

For each batch size it prints:
  * the median forward time (CUDA events around one forward, host launch
    cost included), with the CUDA attention kernel and with the plain
    PyTorch attention swapped in, in turns (kernel, plain, plain, kernel);
  * from a torch.profiler trace of a few kernel-path forwards, the device
    time by kernel name and the device's busy share of the wall time.

Weights are seeded (core/seeded.py), act_layer gelu_tanh, avg pool, bf16,
and the model is built with use_pallas_attn, as the trainer builds it on
the card (the server builds it without: plain attention).
Run from the root of a checkout:

    python tools/profile_torch_forward.py --batch 1 64
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vision_transformers_torch_xla_tpu_torch.core.seeded import (  # noqa: E402
    seeded_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models import (  # noqa: E402
    create_model,
)
from vision_transformers_torch_xla_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
)


def forward_ms(model, x, reps: int = 30) -> float:
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model(x)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def plain_attention(qkv, num_heads, scale=None, with_stats=False):
    d = qkv.shape[-1] // (3 * num_heads)
    return fa.attn_fwd_reference(qkv, num_heads,
                                 float(scale if scale else d ** -0.5),
                                 with_stats)


def profile(model, x, steps: int = 5):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us()
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_forward": wall_us / steps / 1e3,
            "device_busy_ms_per_forward": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels_ms_per_forward": [
                [name[:90], us / steps / 1e3] for name, us in top]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_forward: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    model = create_model("my_vit_b", act_layer="gelu_tanh", global_pool="avg",
                         use_pallas_attn=True, device=dev)
    sd = seeded_state_dict({k: v.shape for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    model.eval()
    kernel_attention = fa.attn_fwd
    for b in args.batch:
        x = torch.randn((b, 224, 224, 3), generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        times = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            fa.attn_fwd = kernel_attention if which == "kernel" \
                else plain_attention
            times[which].append(forward_ms(model, x))
        fa.attn_fwd = kernel_attention
        row = {"batch": b,
               "forward_ms_kernel": times["kernel"],
               "forward_ms_plain_attention": times["plain"],
               "profile": profile(model, x)}
        print(json.dumps(row))


if __name__ == "__main__":
    main()
