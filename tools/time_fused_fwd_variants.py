"""A/B of K7's cast order in csrc/attn_fwd_tc.cu against variants of its
softmax, on one NVIDIA GPU, and a bitwise check of its division.

    python tools/time_fused_fwd_variants.py [--batch 128] [--seq 197]
        [--head_dim 64] [--dtype bfloat16]

Each variant is a text edit of a copy of the checkout's
csrc/attn_fwd_tc.cu, built with the port's nvcc flags under
build/variants/<name>/ (all builds started together) and launched through
its `vtx_fused_attn_fwd_tc` on seeded (B, H, S, D) q, k, v with 12 heads:

* as_is: the committed kernel;
* fdiv: every p / sum by __fdiv_rn instead of `div_rn`;
* no_online_sum: the max pass without its online sums (times only: the
  sums, and so o, are wrong);
* two_blocks: `__launch_bounds__(kThreads, 2)` in K7's order, two blocks
  per SM (ptxas's spills are printed).

Per variant: the median CUDA-event time of one launch (20 launches a
sample, 15 samples), o's max abs error against
ops/flash_attention.py::fused_fwd_reference, and ptxas's registers and
spills of K7's instantiations; the launch of `hp_fwd` (K9, K1's order) and
torch's scaled_dot_product_attention on the same q, k, v beside them. Then
`div_rn`, cut from the committed csrc/hopper.cuh, against __fdiv_rn on
2^33 random (p, sum) pairs, sum in [1, 1024) and p in [2^-102, 1], then p
in [2^-126, 1]: the count of quotients that differ. One JSON line, with the card's
name and power limit (nvidia-smi).
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
ONLINE = "online_sum(s, mx0, mx1, m0, m1, l0, l1);"
BOUNDS = "__launch_bounds__(kThreads, 1)"
VARIANTS = {
    "as_is": {},
    "fdiv": {"div_rn(s[": "__fdiv_rn(s[", ", l0, y0)": ", l0)",
             ", l1, y1)": ", l1)"},
    "no_online_sum": {ONLINE: "m0 = mx0; m1 = mx1;"},
    "two_blocks": {BOUNDS: "__launch_bounds__(kThreads, kK7 ? 2 : 1)"},
}
# div_rn against __fdiv_rn, one thread per pair
CHECK = r"""
#include <stdint.h>
#include <cuda_runtime.h>
%s
__device__ uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}
// p = 2^e (1 + m) with e in [lo, -1], or 1; sum in [1, 1024)
__global__ void check(uint64_t n, int lo, unsigned long long* bad) {
  unsigned long long b = 0;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint64_t h = mix(2 * i + 1), g = mix(2 * i + 2);
    const int e = lo + (int)((h >> 40) %% (uint64_t)(-lo));
    const float p = (h & 0xffff) == 0 ? 1.f : __uint_as_float(
        ((uint32_t)(127 + e) << 23) | (uint32_t)(h & 0x7fffff));
    const float s = __uint_as_float(
        ((uint32_t)(127 + (int)((g >> 40) %% 10)) << 23) |
        (uint32_t)(g & 0x7fffff));
    if (div_rn(p, s, __frcp_rn(s)) != __fdiv_rn(p, s)) ++b;
  }
  atomicAdd(bad, b);
}
extern "C" long long vtx_div_check(unsigned long long n, int lo) {
  unsigned long long* bad;
  if (cudaMallocManaged(&bad, sizeof(*bad)) != cudaSuccess) return -1;
  *bad = 0;
  check<<<132 * 16, 256>>>(n, lo, bad);
  const long long out = cudaDeviceSynchronize() == cudaSuccess
                        ? (long long)*bad : -1;
  cudaFree(bad);
  return out;
}
"""


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
    text = (cuda_build.CSRC_DIR / "attn_fwd_tc.cu").read_text()
    for old, new in edits.items():
        if old not in text:
            raise SystemExit(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def k7_ptxas(log: str):
    """Registers and spills of each K7-order instantiation (ptxas -v)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"attn_fwd_tc_kernelI(\w+?)Li(\d+)ELb1E", line)
        if "Function properties" in line:
            fn = f"{m.group(1)}, {m.group(2)}" if m else None
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fused_fwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    text = (cuda_build.CSRC_DIR / "hopper.cuh").read_text()
    div = re.search(r"__device__ __forceinline__ float div_rn\(.*?\n}\n",
                    text, re.S).group(0)
    sources = {n: variant_source(e) for n, e in VARIANTS.items()}
    sources["div_check"] = CHECK % div
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b, s, d, dt = args.batch, args.seq, args.head_dim, getattr(torch,
                                                             args.dtype)
    x = np.random.default_rng(b + s + d).standard_normal(
        (b, s, 3, H, d)).astype(np.float32)
    qkv = torch.from_numpy(x).to("cuda", dt)
    q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
    scale = d ** -0.5
    want = fa.fused_fwd_reference(q, k, v, scale).float()
    layout = [int(t) for t in q.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "shape": [b, s, H, d],
        "dtype": args.dtype, "variants": {}}
    for name in VARIANTS:
        so, log = built[name]
        fn = ctypes.CDLL(so).vtx_fused_attn_fwd_tc
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float] + [ctypes.c_longlong] * 6 + [ctypes.c_int,
                                                         ctypes.c_void_p]
        o = torch.empty_like(q)

        def launch():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, H, s, d, scale, *layout, *layout,
                    cuda_build.dtype_code(dt), stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        launch()
        torch.cuda.synchronize()
        out["variants"][name] = {
            "ms": ms(launch),
            "max_abs_err": (o.float() - want).abs().max().item(),
            "ptxas": k7_ptxas(log)}
    flat = qkv.view(b, s, 3 * H * d)
    out["hp_fwd_ms"] = ms(lambda: fa.hp_fwd(flat, H))
    out["sdpa_ms"] = ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    lib = ctypes.CDLL(built["div_check"][0])
    lib.vtx_div_check.restype = ctypes.c_longlong
    lib.vtx_div_check.argtypes = [ctypes.c_ulonglong, ctypes.c_int]
    n = 1 << 33
    out["div_rn_vs_fdiv_rn"] = {
        "pairs": n, "differ_p_from_2^-102": lib.vtx_div_check(n, -102),
        "differ_p_from_2^-126": lib.vtx_div_check(n, -126)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
