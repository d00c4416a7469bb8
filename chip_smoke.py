#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's serving path and its training path
(vision_transformers_torch_xla_tpu_torch) and imports nothing of JAX. Phases, in order; any failure exits non-zero
and no phase catches its own error:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: csrc/attn_fwd.cu with nvcc into build/kernels/, timed.
3. kernel vs plain: ops/flash_attention.py::attn_fwd (the CUDA kernel)
   against attn_fwd_reference (plain PyTorch) on seeded bf16 qkv at the
   serve path's shapes (B 1 and 64, S 197, H 12, D 64) and a few other
   shapes of the kernel's contract; median CUDA-event time of each.
4. model: full-width my_vit_b (gelu_tanh, avg pool, bf16 compute) on the
   seeded weights, saved and strict-loaded through ckpt/convert.py, against
   the JAX package's fp32 golden logits (tests/data/); one forward must
   launch the kernel exactly once per block (12).
5. serve: the port's HTTP server on 127.0.0.1 with the same weights;
   /healthz, then /predict with the committed JPEGs (tests/data/serve_*.jpg);
   each request must launch the kernel 12 times.
6. build: csrc/attn_bwd.cu (started with the forward's build in phase 2,
   one nvcc per source, in parallel); build time, registers and spills.
7. backward kernel vs plain: ops/flash_attention.py::attn_bwd against
   attn_bwd_reference on seeded bf16 qkv and dO, with o and the row stats
   from the forward kernel, at the train path's shapes (B 64 and 128, S 197,
   H 12, D 64) and a few other shapes of the contract; median CUDA-event
   time of each at B 64 and 128.
8. gradient: full-width my_vit_b (gelu_tanh, avg pool, drop_path 0, bf16)
   on the phase-4 weights, one train-mode forward + backward on 2 seeded
   images with smoothed targets, against the JAX package's fp32 golden
   loss, grad norm and per-parameter grad norms (tests/data/); it must
   launch each attention kernel exactly 12 times.
9. train: the port's trainer, launch/main.py::main, on my_vit_b at batch
   128 with the recipe's flags for 3 steps and 2 eval batches (12 backward
   launches per step); then 10 steps on one fixed batch (mixup off, lr
   1e-4), whose loss must fall; then the recipe's step timed on a fixed
   device batch: median step ms, images/s, MFU and peak memory.

The last two lines of stdout are the kernels JSON and the result JSON.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "vision_transformers_torch_xla_tpu_torch"

# Tolerances, kernel vs plain (same bf16 inputs, same cast order; only the
# fp32 summation order differs): o is bf16, |o| < 1 here, so a flipped
# rounding of bf16(p) or of o itself moves it by a few bf16 ulps (2^-8 at
# 0.5..1); the fp32 row stats differ by summation order only.
O_ATOL = 2e-2
ST_RTOL = 1e-4
# Model vs golden: the port computes in bf16 (bf16 residual stream and
# bf16 logits, as the JAX model's bf16 policy does); the golden is the JAX
# model in fp32. Logits here have std ~0.55 and |max| ~1.8.
LOGIT_ATOL = 0.1
LOGIT_REL_L2 = 0.05

MAIN_SHAPES = ((1, 197, 12, 64), (64, 197, 12, 64))   # (B, S, H, D)
EXTRA_SHAPES = ((2, 17, 12, 64), (1, 512, 4, 64), (1, 1024, 2, 128),
                (3, 77, 3, 48))
N_REQUESTS = 8
# Backward kernel vs plain (same bf16 inputs, same cast order): a flipped
# bf16 rounding of t or of a stored gradient moves dqkv by a few bf16 ulps
# of values up to ~2, so max abs err <= 2e-2 of max |reference|. The fp32
# bias partials sum 197 rows each and a flip moves one term: <= 1e-3 of
# max |reference|.
BWD_MAIN_SHAPES = ((64, 197, 12, 64), (128, 197, 12, 64))
DQKV_REL_ATOL = 2e-2
DBIAS_REL_ATOL = 1e-3
# Gradient vs the JAX fp32 golden, bf16 compute. The same bf16 path run on
# the CPU is off by 4e-4 (loss), 5e-4 (grad norm) and at most 1.6e-3
# (per-parameter grad norm, relative); the limits leave ~10x room for the
# card's other summation orders.
LOSS_ATOL = 0.02
GRAD_NORM_RTOL = 1e-2
PARAM_GRAD_NORM_RTOL = 2e-2
# Train phase: the recipe (scripts/train_vit_b_v4_64.sh, bench.py:110-139)
TRAIN_BATCH = 128
TRAIN_STEPS = 3
EVAL_BATCHES = 2
RECIPE_FLAGS = [
    "--model", "my_vit_b", "--act_layer", "gelu_tanh",
    "--batch_size", str(TRAIN_BATCH), "--data_set", "synthetic",
    "--model_ema", "true", "--epochs", "1",
    "--limit_steps_per_epoch", str(TRAIN_STEPS),
    "--limit_eval_batches", str(EVAL_BATCHES), "--lr", "4e-3",
    "--min_lr", "1e-6", "--warmup_epochs", "20", "--warmup_lr", "1e-6",
    "--weight_decay", "0.05", "--mixup", "0.8", "--cutmix", "1.0",
    "--smoothing", "0.1", "--drop_path", "0.1"]
FIXED_STEPS = 10
WARMUP_STEPS = 3
TIMED_STEPS = 12
# NVIDIA's data sheet, H100 SXM, dense bf16 tensor-core peak
H100_BF16_PEAK_FLOPS = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms (host launch cost included)."""
    import torch

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


def phase_kernel(fa, dev):
    import numpy as np
    import torch

    results = {}
    worst = 0.0
    for shape in MAIN_SHAPES + EXTRA_SHAPES:
        b, s, h, d = shape
        rng = np.random.default_rng(1000 + b * s + h * d)
        qkv = torch.from_numpy(
            rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
        ).to(dev, torch.bfloat16)
        scale = d ** -0.5
        o_k, st_k = fa.attn_fwd(qkv, h, scale, with_stats=True)
        o_r, st_r = fa.attn_fwd_reference(qkv, h, scale, with_stats=True)
        torch.cuda.synchronize()
        o_err = (o_k.float() - o_r.float()).abs().max().item()
        st_err = ((st_k - st_r).abs() / (st_r.abs() + 1e-6)).max().item()
        check(o_k.shape == (b, s, h * d) and st_k.shape == (b, h, s, 2),
              f"{shape}: output shapes {o_k.shape}, {st_k.shape}")
        check(torch.isfinite(o_k.float()).all().item(),
              f"{shape}: o not finite")
        check(o_err <= O_ATOL, f"{shape}: o max abs err {o_err} > {O_ATOL}")
        check(st_err <= ST_RTOL, f"{shape}: stats rel err {st_err} > {ST_RTOL}")
        worst = max(worst, o_err)
        row = {"o_max_abs_err": o_err, "stats_max_rel_err": st_err}
        if shape in MAIN_SHAPES:
            row["ms"] = cuda_ms(lambda: fa.attn_fwd(qkv, h, scale))
            row["plain_ms"] = cuda_ms(
                lambda: fa.attn_fwd_reference(qkv, h, scale))
        results[shape] = row
        log(f"[kernel] B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return results, worst


def phase_model(fa, dev, ckpt_path):
    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        load_checkpoint,
        save_checkpoint,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
        seeded_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model

    with open(os.path.join(REPO, "tests", "data",
                           "torch_port_golden_my_vit_b.json")) as f:
        golden = json.load(f)
    model = create_model("my_vit_b", device=dev, **golden["model_kwargs"])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    save_checkpoint(ckpt_path, seeded_state_dict(shapes, seed=0))
    model.load_state_dict(load_checkpoint(ckpt_path), strict=True)
    model.eval()
    images = torch.from_numpy(seeded_images(2, 224, seed=0)).to(dev)

    fa.ATTN_FWD_LAUNCHES = 0
    with torch.inference_mode():
        logits = model(images)
    torch.cuda.synchronize()
    launches = fa.ATTN_FWD_LAUNCHES

    want = np.asarray(golden["logits"], np.float32)
    got = logits.cpu().numpy()
    check(got.shape == want.shape == (2, 1000), f"logits shape {got.shape}")
    check(np.isfinite(got).all(), "logits not finite")
    max_abs = float(np.abs(got - want).max())
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"[model] my_vit_b bf16 vs JAX fp32 golden: max_abs_err={max_abs!r} "
        f"rel_l2={rel_l2!r} top1 port={got.argmax(1).tolist()} "
        f"golden={want.argmax(1).tolist()} kernel launches={launches}")
    check(launches == 12, f"one forward launched the kernel {launches} times")
    check(max_abs <= LOGIT_ATOL, f"logits max abs err {max_abs} > {LOGIT_ATOL}")
    check(rel_l2 <= LOGIT_REL_L2,
          f"logits rel L2 err {rel_l2} > {LOGIT_REL_L2}")
    return launches


def phase_serve(fa, ckpt_path):
    import numpy as np

    from vision_transformers_torch_xla_tpu_torch.data import native
    from vision_transformers_torch_xla_tpu_torch.launch.serve import (
        InferenceEngine,
        serve,
    )

    jpegs = []
    for i in range(4):
        with open(os.path.join(REPO, "tests", "data", f"serve_{i}.jpg"),
                  "rb") as f:
            jpegs.append(f.read())

    fa.ATTN_FWD_LAUNCHES = 0
    engine = InferenceEngine("my_vit_b", ckpt=ckpt_path,
                             act_layer="gelu_tanh", device="cuda")
    server = serve(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies, replies = [], []
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["model"] == "my_vit_b",
              f"/healthz replied {health}")
        for i in range(N_REQUESTS):
            before = fa.ATTN_FWD_LAUNCHES
            req = urllib.request.Request(url + "/predict", data=jpegs[i % 4],
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as r:
                reply = json.loads(r.read())
            latencies.append((time.perf_counter() - t0) * 1e3)
            topk = reply["topk"]
            probs = [p for _, p in topk]
            check(len(topk) == 5 and all(0.0 <= p <= 1.0 for p in probs)
                  and probs == sorted(probs, reverse=True),
                  f"request {i}: bad top-5 {reply}")
            check(fa.ATTN_FWD_LAUNCHES - before == 12,
                  f"request {i} launched {fa.ATTN_FWD_LAUNCHES - before}")
            replies.append(topk)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    launches = fa.ATTN_FWD_LAUNCHES

    # the served answer is the model's answer on the decoded image
    direct = engine._forward(engine._decode(jpegs[0])[None])[0]
    want = np.argsort(direct)[::-1][:5].tolist()
    check([c for c, _ in replies[0]] == want,
          f"served {replies[0]}, model top-5 {want}")
    check(replies[0] == replies[4], "same JPEG, different answers")
    decoder = "native" if native.available() else "PIL"
    log(f"[serve] decoder={decoder} requests={N_REQUESTS} "
        f"median_ms={statistics.median(latencies)!r} "
        f"latencies_ms={latencies!r} launches={launches} "
        f"(12 warm-up + 12 per request)")
    return launches, statistics.median(latencies)


def build_all(fa):
    """Start every kernel build at once, one nvcc per source; returns each
    library's build (or load) time in seconds. A failed build raises."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    builds = {"attn_fwd": fa.build_kernels, "attn_bwd": fa.build_bwd_kernels}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(timed, fn) for n, fn in builds.items()}
        return {n: f.result() for n, f in futures.items()}


def log_ptxas(cuda_build, name: str, tag: str) -> None:
    """ptxas's registers and spills for each kernel of library `name`."""
    import re

    fn = "?"
    for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"(attn_\w+?_kernel)(?:ILi(\d+)E)?", m.group(1))
            fn = f"{k.group(1)}<{k.group(2) or 0}>" if k else m.group(1)
        elif "registers" in line or "spill" in line:
            log(f"[{tag}] {fn}: {line.strip()}")


def phase_bwd_kernel(fa, dev):
    import numpy as np
    import torch

    results = {}
    worst = 0.0
    for shape in BWD_MAIN_SHAPES + EXTRA_SHAPES:
        b, s, h, d = shape
        rng = np.random.default_rng(2000 + b * s + h * d)
        qkv = torch.from_numpy(
            rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
        ).to(dev, torch.bfloat16)
        do = torch.from_numpy(
            rng.standard_normal((b, s, h * d)).astype(np.float32)
        ).to(dev, torch.bfloat16)
        scale = d ** -0.5
        o, st = fa.attn_fwd(qkv, h, scale, with_stats=True)
        dqkv, dbias = fa.attn_bwd(qkv, do, o, st, h, scale)
        dqkv_r, dbias_r = fa.attn_bwd_reference(qkv, do, o, st, h, scale)
        torch.cuda.synchronize()
        check(dqkv.shape == (b, s, 3 * h * d) and dbias.shape == (b, 3 * h * d),
              f"{shape}: output shapes {dqkv.shape}, {dbias.shape}")
        check(torch.isfinite(dqkv.float()).all().item()
              and torch.isfinite(dbias).all().item(), f"{shape}: not finite")
        err = (dqkv.float() - dqkv_r.float()).abs().max().item()
        ref = dqkv_r.float().abs().max().item()
        b_err = (dbias - dbias_r).abs().max().item()
        b_ref = dbias_r.abs().max().item()
        check(err <= DQKV_REL_ATOL * ref,
              f"{shape}: dqkv max abs err {err} > {DQKV_REL_ATOL} x {ref}")
        check(b_err <= DBIAS_REL_ATOL * b_ref,
              f"{shape}: bias partials err {b_err} > {DBIAS_REL_ATOL} x "
              f"{b_ref}")
        worst = max(worst, err)
        row = {"dqkv_max_abs_err": err, "dqkv_max_abs": ref,
               "dbias_max_abs_err": b_err, "dbias_max_abs": b_ref}
        if shape in BWD_MAIN_SHAPES:
            row["ms"] = cuda_ms(lambda: fa.attn_bwd(qkv, do, o, st, h, scale))
            row["plain_ms"] = cuda_ms(
                lambda: fa.attn_bwd_reference(qkv, do, o, st, h, scale))
        results[shape] = row
        log(f"[bwd kernel] B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return results, worst


def phase_grad(fa, dev, ckpt_path):
    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        load_checkpoint,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model
    from vision_transformers_torch_xla_tpu_torch.train.losses import (
        soft_target_cross_entropy,
    )
    from vision_transformers_torch_xla_tpu_torch.train.mixup import (
        smoothed_one_hot,
    )

    with open(os.path.join(REPO, "tests", "data",
                           "torch_port_train_golden_my_vit_b.json")) as f:
        golden = json.load(f)
    model = create_model("my_vit_b", device=dev, **golden["model_kwargs"])
    model.load_state_dict(load_checkpoint(ckpt_path), strict=True)
    images = torch.from_numpy(seeded_images(2, 224, seed=0)).to(dev)
    targets = smoothed_one_hot(torch.tensor(golden["labels"], device=dev),
                               1000, golden["smoothing"])

    fa.ATTN_FWD_LAUNCHES = fa.ATTN_BWD_LAUNCHES = 0
    logits = model(images, deterministic=False,
                   generator=torch.Generator(device=dev))
    loss = soft_target_cross_entropy(logits, targets)
    loss.backward()
    torch.cuda.synchronize()
    launches = (fa.ATTN_FWD_LAUNCHES, fa.ATTN_BWD_LAUNCHES)

    norms = {k: p.grad.float().norm().item()
             for k, p in model.named_parameters()}
    want = golden["grad_norms"]
    check(set(norms) == set(want), "parameter names differ from the golden")
    check(all(np.isfinite(v) for v in norms.values()), "grads not finite")
    grad_norm = float(np.sqrt(sum(v * v for v in norms.values())))
    rel = {k: abs(norms[k] - want[k]) / want[k] for k in want}
    worst = max(rel, key=rel.get)
    loss_err = abs(loss.item() - golden["loss"])
    gn_err = abs(grad_norm - golden["grad_norm"]) / golden["grad_norm"]
    log(f"[grad] my_vit_b bf16 vs JAX fp32 golden: loss {loss.item()!r} "
        f"(golden {golden['loss']!r}, abs err {loss_err!r}); grad norm "
        f"{grad_norm!r} (golden {golden['grad_norm']!r}, rel err {gn_err!r}); "
        f"per-parameter grad norm worst rel err {rel[worst]!r} ({worst}), "
        f"median {float(np.median(list(rel.values())))!r}; launches "
        f"fwd={launches[0]} bwd={launches[1]}")
    check(launches == (12, 12),
          f"one forward + backward launched {launches} (want 12, 12)")
    check(loss_err <= LOSS_ATOL, f"loss err {loss_err} > {LOSS_ATOL}")
    check(gn_err <= GRAD_NORM_RTOL, f"grad norm rel err {gn_err}")
    check(rel[worst] <= PARAM_GRAD_NORM_RTOL,
          f"{worst}: grad norm rel err {rel[worst]} > {PARAM_GRAD_NORM_RTOL}")
    return {"loss_err": loss_err, "grad_norm_rel_err": gn_err,
            "param_grad_norm_worst_rel_err": rel[worst]}


def phase_train(fa, dev):
    import gc
    import math

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data.loader import to_device
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.obs.metrics import (
        vit_train_flops_per_image,
    )

    # the trainer's entry point, as a user calls it
    cfg = config_from_args(RECIPE_FLAGS)
    fa.ATTN_FWD_LAUNCHES = fa.ATTN_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    stats = trainer.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attn_fwd": fa.ATTN_FWD_LAUNCHES,
                "attn_bwd": fa.ATTN_BWD_LAUNCHES}
    log(f"[train] main(): {wall:.3f} s, stats {stats}, launches {launches}")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in stats.values()), f"stats not finite: {stats}")
    check(stats["count"] == EVAL_BATCHES * cfg.eval_batch_size(),
          f"evaluated {stats['count']} images")
    check(launches["attn_bwd"] == 12 * TRAIN_STEPS,
          f"{launches['attn_bwd']} backward launches for {TRAIN_STEPS} steps")
    check(launches["attn_fwd"] == 12 * (TRAIN_STEPS + EVAL_BATCHES),
          f"{launches['attn_fwd']} forward launches")

    # the loss falls on one fixed batch (mixup off, constant lr 1e-4)
    fixed = config_from_args(RECIPE_FLAGS + [
        "--mixup", "0", "--cutmix", "0", "--lr", "1e-4", "--min_lr", "1e-4",
        "--warmup_epochs", "0"])
    ctx = trainer.setup(fixed)
    images, labels = to_device(next(iter(ctx.train_ds)), dev)
    losses = []
    for _ in range(FIXED_STEPS):
        ctx.state, m = ctx.train_step(ctx.state, images, labels, fixed.seed)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    log(f"[train] fixed batch, {FIXED_STEPS} steps at lr 1e-4: losses "
        f"{losses!r}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    check(last < first, f"loss did not fall: {first} -> {last}")
    del ctx, m
    gc.collect()
    torch.cuda.empty_cache()

    # the recipe's step (mixup, forward, backward, AdamW, EMA) on a fixed
    # device batch; CUDA events around each step, no host data in the loop
    ctx = trainer.setup(cfg)
    images, labels = to_device(next(iter(ctx.train_ds)), dev)
    for _ in range(WARMUP_STEPS):
        ctx.state, m = ctx.train_step(ctx.state, images, labels, cfg.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TIMED_STEPS):
        ctx.state, m = ctx.train_step(ctx.state, images, labels, cfg.seed)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    step_ms = statistics.median(events[i].elapsed_time(events[i + 1])
                                for i in range(TIMED_STEPS))
    check(math.isfinite(m["loss"].item()), "timed steps: loss not finite")
    peak = torch.cuda.max_memory_allocated(dev)
    ips = TRAIN_BATCH / (step_ms / 1e3)
    mfu = vit_train_flops_per_image() * ips / H100_BF16_PEAK_FLOPS
    result = {"step_ms": step_ms, "host_step_ms": host_ms,
              "images_per_s": ips, "mfu": mfu, "peak_mem_gib": peak / 2**30}
    log(f"[train] my_vit_b b{TRAIN_BATCH} recipe step on {nvidia_smi()}: "
        f"median {step_ms!r} ms over {TIMED_STEPS} steps after "
        f"{WARMUP_STEPS} warm-up (host clock {host_ms!r} ms/step), "
        f"{ips!r} images/s, MFU {mfu!r} of the {H100_BF16_PEAK_FLOPS:.0f} "
        f"FLOP/s H100 SXM bf16 dense peak (bench.py's analytic FLOPs), peak "
        f"memory {peak / 2**30!r} GiB")
    del ctx, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches, result


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vision_transformers_torch_xla_tpu_torch.ops import (
        cuda_build,
        flash_attention as fa,
    )

    # the plain versions' fp32 matmuls run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    build_s = build_all(fa)
    log(f"[build] attn_fwd built/loaded in {build_s['attn_fwd']:.3f} s")
    log_ptxas(cuda_build, "attn_fwd", "build")

    kernel, worst = phase_kernel(fa, dev)
    ckpt_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(ckpt_dir, "my_vit_b_seed0.pth")
    phase_model(fa, dev, ckpt_path)
    serve_launches, _ = phase_serve(fa, ckpt_path)

    log(f"[build bwd] attn_bwd built/loaded in {build_s['attn_bwd']:.3f} s "
        f"(in parallel with attn_fwd)")
    log_ptxas(cuda_build, "attn_bwd", "build bwd")
    bwd, bwd_worst = phase_bwd_kernel(fa, dev)
    phase_grad(fa, dev, ckpt_path)
    train_launches, _ = phase_train(fa, dev)
    check(all(n > 0 for n in train_launches.values()),
          f"a kernel of the train path never launched: {train_launches}")

    b1, b64 = kernel[MAIN_SHAPES[0]], kernel[MAIN_SHAPES[1]]
    g64, g128 = bwd[BWD_MAIN_SHAPES[0]], bwd[BWD_MAIN_SHAPES[1]]
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": [{
        "name": "attn_fwd", "route": "cuda",
        "source": f"{PKG}/csrc/attn_fwd.cu",
        "replaces": "vision_transformers_torch_xla_tpu/ops/"
                    "flash_attention.py:291",
        "launches": train_launches["attn_fwd"],
        "launches_serve": serve_launches, "max_abs_err": worst,
        "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "ms_b64": b64["ms"], "plain_ms_b64": b64["plain_ms"]}, {
        "name": "attn_bwd", "route": "cuda",
        "source": f"{PKG}/csrc/attn_bwd.cu",
        "replaces": "vision_transformers_torch_xla_tpu/ops/"
                    "flash_attention.py:495",
        "launches": train_launches["attn_bwd"], "max_abs_err": bwd_worst,
        "ms": g128["ms"], "plain_ms": g128["plain_ms"],
        "ms_b64": g64["ms"], "plain_ms_b64": g64["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
