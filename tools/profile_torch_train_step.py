"""Time and profile the PyTorch port's train step on one NVIDIA GPU.

The step is the trainer's own (launch/main.py::setup with the recipe's
flags: mixup/cutmix, label smoothing, drop_path 0.1, AdamW with the wd
mask, EMA), on one fixed device batch of the synthetic stream, so no host
data enters the timed loop. Two models:
  * my_vit_b (default): 224 px, gelu_tanh, avg pool, batch 128; attention
    through K1 and K2 (ops/flash_attention.py);
  * vit_base_patch14_dinov2: 518 px (S = 1370), token pool, its own exact
    GELU, batch 32; attention through K4, K5 and K6 (ops/flash_blocked.py).
The model is built with use_pallas_attn (the trainer's `--pallas_attn
on`, which its default `auto` also means on the card).
`--pallas_mlp` and `--precision` are the trainer's own flags, passed
through: `--pallas_mlp on` runs every tanh-GELU MLP's backward through the
fc2-backward kernel K3 (ops/mlp_fused.py); `--precision fp32` computes in
fp32, on the kernels' fp32 instantiations. `--repo DIR` profiles the port
of another checkout (for example a parent commit unpacked by `git
archive`) with this script, so that an A/B runs one script on both trees.
It prints one JSON line with:
  * the median step time (CUDA events around each step after warm-up) and
    images/s, with the attention kernels and with their plain PyTorch
    versions swapped in, in turns (kernel, plain, plain, kernel);
  * from a torch.profiler trace of a few kernel-path steps: the device's
    busy share of the wall time, the top device operations, and per step
    the attention kernels' and K3's time and the cuBLAS time (`nvjet_*`,
    gemm kernels);
  * the optimizer's (AdamW + EMA) device span per step: CUDA events around
    each `FusedAdamW.fused_update` call of the profiled steps;
  * for my_vit_b, the K2 qkv-bias partials (ROADMAP K2): the time of the
    wrapper's sum of the kernel's (B, 3HD) partials against a plain
    `dqkv.float().sum((0, 1))` over the (B, S, 3HD) gradient;
  * MFU against the bf16 tensor-core peak and, beside it, against the fp32
    CUDA-core peak (67 TFLOP/s), the bound of a `--precision fp32` step;
  * peak device memory, and the card's name and power limit.

Run from the root of a checkout:

    python tools/profile_torch_train_step.py --batch 128 --steps 5
    python tools/profile_torch_train_step.py --batch 128 --pallas_mlp on
    python tools/profile_torch_train_step.py --batch 128 --precision fp32 \
        [--repo build/parent]
    python tools/profile_torch_train_step.py \
        --model vit_base_patch14_dinov2 --batch 32 --steps 3
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

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout whose port is profiled: --repo, read before the imports
_pre = argparse.ArgumentParser(add_help=False)
_pre.add_argument("--repo", default=HERE)
REPO = os.path.abspath(_pre.parse_known_args()[0].repo)
sys.path.insert(0, REPO)

from vision_transformers_torch_xla_tpu_torch.core.config import (  # noqa: E402
    config_from_args,
)
from vision_transformers_torch_xla_tpu_torch.data.loader import (  # noqa: E402
    to_device,
)
from vision_transformers_torch_xla_tpu_torch.launch import (  # noqa: E402
    main as trainer,
)
from vision_transformers_torch_xla_tpu_torch.obs.metrics import (  # noqa: E402
    vit_train_flops_per_image,
)
from vision_transformers_torch_xla_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
    flash_blocked as fb,
)
from vision_transformers_torch_xla_tpu_torch.train.fused import (  # noqa: E402
    FusedAdamW,
)

H100_BF16_PEAK_FLOPS = 989e12  # NVIDIA data sheet, H100 SXM, dense bf16
H100_FP32_PEAK_FLOPS = 67e12   # the same sheet: fp32 on the CUDA cores


# model -> its flags beside the recipe's, its image and patch size
MODELS = {
    "my_vit_b": (["--act_layer", "gelu_tanh"], 224, 16),
    "vit_base_patch14_dinov2": (["--input_size", "518", "--global_pool",
                                 "token"], 518, 14),
}


def recipe_flags(batch: int, model: str = "my_vit_b",
                 pallas_mlp: str = "off", precision: str = "bf16"):
    return ["--model", model, *MODELS[model][0], "--pallas_attn", "on",
            "--pallas_mlp", pallas_mlp, "--precision", precision,
            "--batch_size", str(batch), "--data_set", "synthetic",
            "--model_ema", "true", "--lr", "4e-3", "--min_lr", "1e-6",
            "--warmup_epochs", "20", "--warmup_lr", "1e-6",
            "--weight_decay", "0.05", "--mixup", "0.8", "--cutmix", "1.0",
            "--smoothing", "0.1", "--drop_path", "0.1"]


def plain_fwd(qkv, num_heads, scale=None, with_stats=False):
    d = qkv.shape[-1] // (3 * num_heads)
    return fa.attn_fwd_reference(qkv, num_heads,
                                 float(scale if scale else d ** -0.5),
                                 with_stats)


def plain_bwd(qkv, do, o, st, num_heads, scale=None):
    d = qkv.shape[-1] // (3 * num_heads)
    return fa.attn_bwd_reference(qkv, do, o, st, num_heads,
                                 float(scale if scale else d ** -0.5))


def plain_flash_fwd(q, k, v, scale=None):
    return fb.flash_fwd_reference(q, k, v, fb._scale(q, scale))


def plain_flash_dkdv(q, k, v, do, lse, delta, dk, dv, scale=None):
    dk_r, dv_r = fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                             fb._scale(q, scale))
    return dk.copy_(dk_r), dv.copy_(dv_r)


def plain_flash_dq(q, k, v, do, lse, delta, dq, scale=None):
    return dq.copy_(fb.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                              fb._scale(q, scale)))


KERNELS = ((fa, "attn_fwd", plain_fwd), (fa, "attn_bwd", plain_bwd),
           (fb, "flash_fwd", plain_flash_fwd),
           (fb, "flash_bwd_dkdv", plain_flash_dkdv),
           (fb, "flash_bwd_dq", plain_flash_dq))


def swap_attention(plain: bool, saved) -> None:
    """Put the plain versions (or the saved kernel wrappers) in place."""
    for (mod, name, fn), kernel in zip(KERNELS, saved):
        setattr(mod, name, fn if plain else kernel)


def profile(ctx, images, labels, seed, steps: int):
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    update = FusedAdamW.fused_update
    spans = []

    def traced_update(self, *a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        with record_function("optimizer"):
            out = update(self, *a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    FusedAdamW.fused_update = traced_update
    try:
        step(ctx, images, labels, seed)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(ctx, images, labels, seed)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        FusedAdamW.fused_update = update
    by_kernel = {}
    for ev in prof.events():
        # the "optimizer" range shows on the device too: not a kernel
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.name != "optimizer":
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us()
    spans = spans[1:]  # the first call ran before the profiled steps
    optimizer_ms = statistics.median(a.elapsed_time(b) for a, b in spans)

    def per_step(match) -> float:
        return sum(us for n, us in by_kernel.items() if match(n)) / steps / 1e3

    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        # K1: csrc/attn_fwd_tc.cu (bf16, fp16) or csrc/attn_fwd.cu (fp32:
        # attn_fwd_simt_kernel, and before it attn_fwd_kernel), not K7's
        # fused_attn_fwd_kernel; K2: the launches of csrc/attn_bwd_tc.cu or
        # csrc/attn_bwd.cu
        "attn_fwd_k1_ms_per_step": per_step(
            lambda n: "attn_fwd_tc_kernel" in n
            or "attn_fwd_simt_kernel" in n
            or ("attn_fwd_kernel" in n and "fused_attn" not in n)),
        "attn_bwd_k2_ms_per_step": per_step(lambda n: "attn_bwd_" in n),
        "flash_fwd_k4_ms_per_step": per_step(lambda n: "flash_fwd_" in n),
        "flash_dkdv_k5_ms_per_step": per_step(
            lambda n: "flash_bwd_dkdv_" in n),
        "flash_dq_k6_ms_per_step": per_step(lambda n: "flash_bwd_dq_" in n),
        "fc2_bwd_k3_ms_per_step": per_step(lambda n: "fc2_bwd_" in n),
        "cublas_ms_per_step": per_step(
            lambda n: "nvjet" in n or "gemm" in n.lower()
            or "cutlass" in n.lower()),
        "optimizer_span_ms_per_step": optimizer_ms,
        "top_kernels_ms_per_step": [[name[:90], us / steps / 1e3]
                                    for name, us in top]}


def step(ctx, images, labels, seed) -> None:
    ctx.state, _ = ctx.train_step(ctx.state, images, labels, seed)


def cuda_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of one call of fn, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def bias_partials_ab(batches, dev):
    """K2 per call, and the two ways to finish the qkv-bias gradient."""
    out = {}
    for b in batches:
        g = torch.Generator(device=dev).manual_seed(b)
        qkv = torch.randn((b, 197, 3 * 768), generator=g, device=dev
                          ).bfloat16()
        do = torch.randn((b, 197, 768), generator=g, device=dev).bfloat16()
        o, st = fa.attn_fwd(qkv, 12, with_stats=True)
        dqkv, dbias = fa.attn_bwd(qkv, do, o, st, 12)
        out[f"b{b}"] = {
            "attn_bwd_ms": cuda_ms(lambda: fa.attn_bwd(qkv, do, o, st, 12)),
            "partials_sum_ms": cuda_ms(lambda: dbias.sum(dim=0)),
            "dqkv_sum_ms": cuda_ms(lambda: dqkv.float().sum((0, 1)))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="my_vit_b", choices=sorted(MODELS))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5,
                    help="profiled steps")
    ap.add_argument("--timed_steps", type=int, default=10)
    ap.add_argument("--pallas_mlp", default="off", choices=("on", "off"),
                    help="the trainer's flag: the fused-backward MLP (K3)")
    ap.add_argument("--precision", default="bf16",
                    choices=("bf16", "bf16_pure", "fp32"),
                    help="the trainer's flag: the compute dtype")
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose port is profiled (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train_step: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = config_from_args(recipe_flags(args.batch, args.model,
                                        args.pallas_mlp, args.precision))
    ctx = trainer.setup(cfg)
    images, labels = to_device(next(iter(ctx.train_ds)), dev)
    saved = [getattr(mod, name) for mod, name, _ in KERNELS]
    times = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        swap_attention(which == "plain", saved)
        times[which].append(cuda_ms(lambda: step(ctx, images, labels,
                                                 cfg.seed), args.timed_steps))
    swap_attention(False, saved)
    torch.cuda.reset_peak_memory_stats(dev)
    prof = profile(ctx, images, labels, cfg.seed, args.steps)
    ms = statistics.median(times["kernel"])
    ips = args.batch / (ms / 1e3)
    _, img, patch = MODELS[args.model]
    out = {
        "card": card, "tree": REPO, "model": args.model,
        "batch": args.batch, "pallas_mlp": args.pallas_mlp,
        "precision": args.precision,
        "step_ms_kernel": times["kernel"],
        "step_ms_plain_attention": times["plain"],
        "images_per_s": ips,
        "mfu": vit_train_flops_per_image(img, patch) * ips
        / H100_BF16_PEAK_FLOPS,
        # against the fp32 peak: what --precision fp32 can reach at most
        "mfu_fp32_peak": vit_train_flops_per_image(img, patch) * ips
        / H100_FP32_PEAK_FLOPS,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "profile": prof}
    if args.model == "my_vit_b":
        out["k2_bias_partials"] = bias_partials_ab((64, args.batch), dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
