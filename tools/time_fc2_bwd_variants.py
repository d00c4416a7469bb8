"""A/B of csrc/mlp_fused.cu's tensor-core K3 (the fc2 + GELU backward in
bf16 and fp16) against variants of it, on one NVIDIA GPU.

    python tools/time_fc2_bwd_variants.py [--batch 128] [--seq 197]
        [--out 768] [--hidden 3072] [--dtype bfloat16] [--variants NAME ...]

Each variant is a text edit of a copy of the checkout's csrc/mlp_fused.cu,
built with the port's nvcc flags under build/variants/<name>/ (all builds
started together) and launched through its `vtx_fc2_bwd` on seeded dy
(B, S, O), fc2 weight (O, K) at its init scale and h (B, S, K):

* as_is: the committed kernel;
* tanhf: the accurate tanhf in the epilogue instead of 1 - 2 / (2^(2 u
  log2 e) + 1) by ex2.approx and rcp.approx;
* no_gelu: the epilogue's GELU replaced by the identity (times only: dh and
  a are wrong), what the GELU's instructions cost;
* no_store: the epilogue's TMA stores left out (times only), what storing
  dh and a costs;
* four_stages: a 4-stage ring instead of 3 (132 KB of shared memory: one
  block an SM);
* wait_all: each step's products waited for before the next is issued,
  instead of one step in flight.

Per variant: the median CUDA-event time of one launch (20 launches a
sample, 15 samples), the max abs error of dh, a and db1 against
ops/mlp_fused.py::fc2_bwd_reference over the reference's largest
magnitude, and ptxas's registers and spills. Beside them the port's own
`fc2_bwd` and the unfused default path's work for the same result (cuBLAS
da, autograd's GELU backward, the fp32 bias sum). One JSON line, with the
card's name and power limit (nvidia-smi).
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
    mlp_fused as mf,
)

OUT = os.path.join(REPO, "build", "variants")
FAST = "gelu_tanh_val_grad<true>(hf."
VARIANTS = {
    "as_is": {},
    "tanhf": {FAST: "gelu_tanh_val_grad<false>(hf."},
    "no_gelu": {FAST + "x)": "make_float2(hf.x, hf.x)",
                FAST + "y)": "make_float2(hf.y, hf.y)"},
    "no_store": {"tma_store(&tdh,": "if (0) tma_store(&tdh,",
                 "tma_store(&ta,": "if (0) tma_store(&ta,"},
    "four_stages": {"kStages = 3;": "kStages = 4;"},
    "wait_all": {"wg_wait_pending<1>();": "wg_wait_pending<0>();"},
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
    text = (cuda_build.CSRC_DIR / "mlp_fused.cu").read_text()
    for old, new in edits.items():
        if old not in text:
            raise SystemExit(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def ptxas(log: str):
    """Registers and spills of each kernel instantiation (ptxas -v)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(fc2_bwd_\w+?_kernel)(?:I(\w+?)E)?", line)
        if "Function properties" in line:
            fn = f"{m.group(1)}<{m.group(2) or 'float'}>" if m else None
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
    ap.add_argument("--out", type=int, default=768)
    ap.add_argument("--hidden", type=int, default=3072)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"))
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fc2_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sources = {n: variant_source(VARIANTS[n]) for n in args.variants}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b, s, o, k = args.batch, args.seq, args.out, args.hidden
    dt = getattr(torch, args.dtype)
    rng = np.random.default_rng(b + s + o + k)

    def seeded(shape, scale=1.0):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to("cuda", dt)

    dy, w2, h = seeded((b, s, o)), seeded((o, k), 0.02), seeded((b, s, k))
    want = mf.fc2_bwd_reference(dy, w2, h)
    m = b * s
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "shape": [b, s, o, k],
        "dtype": args.dtype, "variants": {}}
    for name in args.variants:
        so, log = built[name]
        fn = ctypes.CDLL(so).vtx_fc2_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        dh, a = torch.empty_like(h), torch.empty_like(h)
        part = torch.empty((-(-m // mf.ROW_TILE), k), dtype=torch.float32,
                           device="cuda")

        def launch():
            rc = fn(dy.data_ptr(), w2.data_ptr(), h.data_ptr(), dh.data_ptr(),
                    a.data_ptr(), part.data_ptr(), m, o, k,
                    cuda_build.dtype_code(dt), stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        launch()
        torch.cuda.synchronize()
        errs = {n: (g.float() - w.float()).abs().max().item()
                / w.float().abs().max().item()
                for n, g, w in zip(("dh", "a", "db1"),
                                   (dh, a, part.sum(dim=0)), want)}
        out["variants"][name] = {"ms": ms(launch),
                                 "max_abs_err_over_max": errs,
                                 "ptxas": ptxas(log)}

    def unfused():
        g = torch.ops.aten.gelu_backward(torch.matmul(dy, w2), h,
                                         approximate="tanh")
        return g, g.sum(dim=(0, 1), dtype=torch.float32)

    out["fc2_bwd_ms"] = ms(lambda: mf.fc2_bwd(dy, w2, h))
    out["unfused_ms"] = ms(unfused)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
