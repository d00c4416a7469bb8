"""A/B of csrc/hp_bwd_tc.cu (the tensor-core K8, K10 and K12) against
variants of its two launches, on one NVIDIA GPU.

    python tools/time_hp_bwd_variants.py [--batch 128] [--seq 197]
        [--head_dim 64] [--dtype bfloat16] [--variants NAME ...]

Each variant is a text edit of a copy of the checkout's csrc/hp_bwd_tc.cu,
built with the port's nvcc flags under build/variants/<name>/ (all builds
started together) and launched through its `vtx_hp_bwd_tc` on seeded
contiguous (B, H, S, D) q, k, v and dO with 12 heads:

* as_is: the committed kernels;
* dq_two_groups: dq blocks of two consumer warpgroups (128 queries), one
  block an SM (the first design, as csrc/attn_bwd_tc.cu's dq kernel);
* dkdv_two_groups: dk/dv blocks of two consumer warpgroups (128 keys) and
  one block an SM at every head dim (the committed kernel takes that shape
  at D = 128 alone; at D = 64 one warpgroup, two blocks an SM);
* dq_three_stages: a 3-stage ring of key tiles in the dq launch instead
  of 2; dkdv_two_stages: a 2-stage ring of query tiles in the dk/dv launch
  instead of 3;
* mul_not_div: p = exp(s - m) * RN(1 / sum) instead of the correctly
  rounded quotient (times only: p can move by an fp32 ulp).

Per variant: the median CUDA-event time of one call (both launches; 20
calls a sample, 15 samples), the device time per call of each of its two
kernels (torch.profiler over 10 calls), the gradients' max abs error
against ops/flash_attention.py::fused_bwd_reference over the reference's
largest magnitude, and ptxas's registers and spills of each
instantiation. Beside them the port's own `fused_bwd` and torch's
scaled_dot_product_attention backward on the same inputs. One JSON line,
with the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vision_transformers_torch_xla_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    flash_attention as fa,
)

OUT = os.path.join(REPO, "build", "variants")
H = 12
PROB = "return div_rn(exp2f(fmaf(__fmul_rn(s, scale), kLog2e, -ml)), sum, y);"
VARIANTS = {
    "as_is": {},
    "dq_two_groups": {"kDqGroups = 1;": "kDqGroups = 2;"},
    "dkdv_two_groups": {"kGroups = kD <= 64 ? 1 : 2;": "kGroups = 2;",
                        "kBlocks = kD <= 64 ? 2 : 1;": "kBlocks = 1;"},
    "dq_three_stages": {"kDqStages = 2;": "kDqStages = 3;"},
    "dkdv_two_stages": {"kStages = 3;": "kStages = 2;"},
    "mul_not_div": {PROB: "return exp2f(fmaf(__fmul_rn(s, scale), kLog2e, "
                          "-ml)) * y;"},
}


def build(name: str, source: str):
    """nvcc of one source into build/variants/<name>/lib.so; returns the
    library's path and ptxas's output."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, d)
    src = os.path.join(d, "variant.cu")
    with open(src, "w") as f:
        f.write(source)
    so = os.path.join(d, "lib.so")
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                          src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return so, res.stdout + res.stderr


def variant_source(edits) -> str:
    text = (cuda_build.CSRC_DIR / "hp_bwd_tc.cu").read_text()
    for old, new in edits.items():
        if old not in text:
            raise SystemExit(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def ptxas(log: str):
    """Registers and spills of each kernel instantiation (ptxas -v)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(hp_bwd_tc_\w+?_kernel)I(\w+?)Li(\d+)E", line)
        if "Function properties" in line:
            fn = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m else None
        elif fn and ("registers" in line or "spill" in line):
            out.setdefault(fn, []).append(line.split(":")[-1].strip())
    return out


def ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(15):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 20)
    return statistics.median(times)


def device_ms(fn, calls: int = 10):
    """Device time per call, in ms, of each CUDA kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type.name == "CUDA":
            out[e.key[:60]] = us / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"))
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_hp_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sources = {n: variant_source(VARIANTS[n]) for n in args.variants}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b, s, d, dt = args.batch, args.seq, args.head_dim, getattr(torch,
                                                             args.dtype)
    rng = np.random.default_rng(b + s + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, H, s, d)).astype(np.float32)).to("cuda", dt) for _ in range(4))
    scale = d ** -0.5
    want = torch.stack(fa.fused_bwd_reference(q, k, v, do, scale)).float()
    ref = want.abs().max().item()
    layout = [int(t) for t in q.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "shape": [b, s, H, d],
        "dtype": args.dtype, "variants": {}}
    for name in args.variants:
        so, log = built[name]
        fn = ctypes.CDLL(so).vtx_hp_bwd_tc
        fn.restype = ctypes.c_int
        L3, P, I = [ctypes.c_longlong] * 3, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 3 + L3 + [P] + L3 + [P] * 3 + L3 + [
            P, I, I, I, I, ctypes.c_float, I, P]
        grads = torch.empty((3, b, H, s, d), dtype=dt, device="cuda")
        stats = torch.empty((b, H, s, 3), dtype=torch.float32, device="cuda")

        def launch():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *layout,
                    do.data_ptr(), *layout,
                    *(g.data_ptr() for g in grads), *layout,
                    stats.data_ptr(), b, H, s, d, scale,
                    cuda_build.dtype_code(dt), stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        launch()
        torch.cuda.synchronize()
        out["variants"][name] = {
            "ms": ms(launch), "device_ms": device_ms(launch),
            "max_abs_err_over_max": (grads.float() - want).abs().max().item()
            / ref,
            "ptxas": ptxas(log)}
    out["fused_bwd_ms"] = ms(lambda: fa.fused_bwd(q, k, v, do, scale))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves)
    out["sdpa_bwd_ms"] = ms(lambda: torch.autograd.grad(
        o, leaves, do, retain_graph=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
