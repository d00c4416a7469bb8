"""A/B of the fp32 K1 (csrc/attn_fwd_simt.cuh::attn_fwd_simt_kernel in K1's
order, built through csrc/attn_fwd.cu) and the fp32 K3
(csrc/mlp_fused.cu::fc2_bwd_simt_kernel) against variants of them, on one
NVIDIA GPU.

    python tools/time_fp32_simt_variants.py [--batch 128] [--variants NAME ...]
        [--seq 197] [--head_dim 64]

Each variant is a text edit of a copy of the checkout's source (K1's: of
the header, which the copy of csrc/attn_fwd.cu includes), built with
the port's nvcc flags under build/variants/<name>/ (all builds started
together) and launched through its host function on seeded fp32 inputs:
K1 (`vtx_attn_fwd`, with the row stats) on qkv (B, S, 3 * 12 * D), K3
(`vtx_fc2_bwd`) on dy (B, 197, 768), the fc2 weight (768, 3072) and h (B,
197, 3072).

* k1_as_is, k3_as_is: the committed kernels;
* k1_no_exp: p = s - m instead of exp(s - m) (times only: what the
  softmax's exponentials cost);
* k1_no_pv: the p v product left out (times only);
* k1_no_scores: the q^ k^T product left out (times only);
* k1_no_skip: every warp computes, also those whose rows all lie past S;
* k1_one_block: one block an SM (no register cap of 128);
* k3_no_gelu: the epilogue's GELU replaced by the identity (times only);
* k3_no_epilogue: the epilogue's loads of h and stores of dh and a left
  out (times only);
* k3_one_block: one block an SM (no register cap of 128);
* k3_sk8, k3_sk32: steps of 8 or 32 over O instead of 16;
* k3_3xtf32: da on the tensor cores as three TF32 products (mma.sync;
  tools/fc2_bwd_3xtf32.cuh), a_lo b_hi + a_hi b_lo + a_hi b_hi, then the
  same epilogue;
* k3_lanes_4x8: a warp's lanes as 4 x 8 threads of the 16 x 16 instead of
  2 x 16 (4 shared-memory wavefronts a step instead of 6);
* k1_unroll4, k1_unroll2: q^ k^T's loop over the head dim unrolled 4 or 2
  times instead of fully;
* k1_pv_unroll1: p v's loop over the keys not unrolled (2 times as is);
* at a head dim over 128 (--head_dim, the wide tiles' stored path):
  k1w_no_pv, k1w_no_scores, k1w_no_exp (p v, q^ k^T or the exponentials
  left out; times only), k1w_no_sync (the ring's block barrier left out;
  times only), k1w_two_slots (a ring of two slots), k1w_unroll1 (the K
  piece's loop over the head dim not unrolled), k1w_big_pieces (K pieces
  of 32 head-dim columns and V pieces of 32 keys, two slots), k1w_kc32 (the
  K pieces alone), k1w_rows32 (32-row blocks of 4 warps, two slots: two
  blocks an SM).

Per variant: the median CUDA-event time of one launch (20 launches a
sample, 15 samples), the max abs error of each output against the plain
version (ops/flash_attention.py::attn_fwd_reference,
ops/mlp_fused.py::fc2_bwd_reference) over its largest magnitude, and
ptxas's registers and spills. Beside them the port's own wrappers, SDPA's
fp32 forward and the unfused default path of K3 (cuBLAS da, autograd's
GELU backward, the fp32 bias sum). One JSON line, with the card's name and
power limit (nvidia-smi).
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
    mlp_fused as mf,
)

OUT = os.path.join(REPO, "build", "variants")
S, H, D, O, K = 197, 12, 64, 768, 3072
# name: (kernel, source, edits)
VARIANTS = {
    "k1_as_is": ("k1", "attn_fwd_simt.cuh", {}),
    "k1_no_exp": ("k1", "attn_fwd_simt.cuh",
                  {"key < nk ? expf(*x - m[i])": "key < nk ? (*x - m[i])"}),
    "k1_no_pv": ("k1", "attn_fwd_simt.cuh",
                 {"pv<kD>(acc, kStore": "if (0) pv<kD>(acc, kStore"}),
    "k1_no_scores": ("k1", "attn_fwd_simt.cuh", {
        "switch (min(4, (S - k0 - 32 * at.wk + 7) >> 3)) {":
            "if (0) switch (min(4, (S - k0 - 32 * at.wk + 7) >> 3)) {"}),
    "k1_no_skip": ("k1", "attn_fwd_simt.cuh", {
        "const bool live = q0 + 16 * at.wr < S;": "const bool live = true;"}),
    "k1_one_block": ("k1", "attn_fwd_simt.cuh", {
        "static constexpr int kMinBlocks = kD > 64 ? 1 : 2;":
            "static constexpr int kMinBlocks = 1;"}),
    "k3_as_is": ("k3", "mlp_fused.cu", {}),
    "k3_no_gelu": ("k3", "mlp_fused.cu", {
        "gelu_tanh_val_grad<false>(hx[e])": "make_float2(hx[e], hx[e])"}),
    "k3_no_epilogue": ("k3", "mlp_fused.cu", {
        "    if (gm >= M) continue;": "    if (gm >= M || vec >= 0) continue;"}),
    "k3_one_block": ("k3", "mlp_fused.cu", {
        "__launch_bounds__(kSThreads, 2)": "__launch_bounds__(kSThreads, 1)"}),
    "k3_sk8": ("k3", "mlp_fused.cu", {
        "constexpr int kSK = 16;": "constexpr int kSK = 8;"}),
    "k3_sk32": ("k3", "mlp_fused.cu", {
        "constexpr int kSK = 16;": "constexpr int kSK = 32;"}),
    "k3_lanes_4x8": ("k3", "mlp_fused.cu", {
        "const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;":
            "const int tid = threadIdx.x, tx = ((tid >> 5) & 1) * 8 + (tid & 7),"
            " ty = (tid >> 6) * 4 + ((tid >> 3) & 3);"}),
    "k3_3xtf32": ("k3", "mlp_fused.cu", {
        "// The dynamic shared memory of the tensor-core kernel: the ring and":
            '#include "fc2_bwd_3xtf32.cuh"\n\n'
            "// The dynamic shared memory of the tensor-core kernel: the ring and",
        "    case kF32: {\n":
            "    case kF32: {\n      if (M > 0) return launch_3xtf32(dy, w2, h,"
            " dh, a, part, M, O, K, tiles * (K / kBN), s);\n"}),
    "k1_unroll4": ("k1", "attn_fwd_simt.cuh", {
        "#pragma unroll\n  for (int d = 0; d < kD; d += 4) {":
            "#pragma unroll 4\n  for (int d = 0; d < kD; d += 4) {"}),
    "k1_unroll2": ("k1", "attn_fwd_simt.cuh", {
        "#pragma unroll\n  for (int d = 0; d < kD; d += 4) {":
            "#pragma unroll 2\n  for (int d = 0; d < kD; d += 4) {"}),
    "k1_pv_unroll1": ("k1", "attn_fwd_simt.cuh", {
        "#pragma unroll 2\n  for (int k = 0; k < depth; k += 4) {":
            "#pragma unroll 1\n  for (int k = 0; k < depth; k += 4) {"}),
    # the wide tiles (--head_dim 129 to 256), stored path
    "k1w_no_pv": ("k1", "attn_fwd_simt.cuh", {
        "        wide_pv<kD>(acc, sc + g * W::kVR,":
            "        if (0) wide_pv<kD>(acc, sc + g * W::kVR,"}),
    "k1w_no_scores": ("k1", "attn_fwd_simt.cuh", {
        "if (live) wide_piece<NJ>(": "if (0) wide_piece<NJ>("}),
    "k1w_no_exp": ("k1", "attn_fwd_simt.cuh", {
        "key < S ? expf(*x - m[i])": "key < S ? (*x - m[i])"}),
    "k1w_no_sync": ("k1", "attn_fwd_simt.cuh", {
        "    cp_async_wait<W::kSlots - 2>();\n    __syncthreads();":
            "    cp_async_wait<W::kSlots - 2>();"}),
    "k1w_two_slots": ("k1", "attn_fwd_simt.cuh", {
        "static constexpr int kSlots = 3;": "static constexpr int kSlots = 2;"}),
    "k1w_big_pieces": ("k1", "attn_fwd_simt.cuh", {
        "static constexpr int kKC = 16;": "static constexpr int kKC = 32;",
        "static constexpr int kVR = 16;": "static constexpr int kVR = 32;",
        "static constexpr int kSlots = 3;": "static constexpr int kSlots = 2;"}),
    "k1w_kc32": ("k1", "attn_fwd_simt.cuh", {
        "static constexpr int kKC = 16;": "static constexpr int kKC = 32;",
        "static constexpr int kSlots = 3;": "static constexpr int kSlots = 2;"}),
    "k1w_rows32": ("k1", "attn_fwd_simt.cuh", {
        "static constexpr int kRows = 64;": "static constexpr int kRows = 32;",
        "static constexpr int kSlots = 3;": "static constexpr int kSlots = 2;"}),
    "k1w_unroll1": ("k1", "attn_fwd_simt.cuh", {
        "#pragma unroll\n  for (int d = 0; d < Wide<256>::kKC; d += 4) {":
            "#pragma unroll 1\n  for (int d = 0; d < Wide<256>::kKC; d += 4) {"}),
}
TIMES_ONLY = {"k1_no_exp", "k1_no_pv", "k1_no_scores", "k3_no_gelu",
              "k3_no_epilogue", "k1w_no_pv", "k1w_no_scores", "k1w_no_exp",
              "k1w_no_sync"}


def build(name: str, files):
    """nvcc of one variant into build/variants/<name>/lib.so: `files`
    {file name: text} written over a copy of csrc/, variant.cu the source
    built; returns the library's path and ptxas's output."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, d)
    shutil.copy(os.path.join(REPO, "tools", "fc2_bwd_3xtf32.cuh"), d)
    for fname, text in files.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    src = os.path.join(d, "variant.cu")
    so = os.path.join(d, "lib.so")
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                          src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return so, res.stdout + res.stderr


def variant_source(source: str, edits):
    """{file name: text} of a variant: the edited source as variant.cu, or
    an edited header beside csrc/attn_fwd.cu (which includes it)."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    for old, new in edits.items():
        if text.count(old) != 1:
            raise SystemExit(f"{source} holds {old!r} {text.count(old)} times")
        text = text.replace(old, new)
    if source.endswith(".cuh"):
        return {source: text,
                "variant.cu": (cuda_build.CSRC_DIR / "attn_fwd.cu").read_text()}
    return {"variant.cu": text}


def ptxas(log: str, kernel: str):
    """Registers and spills of the fp32 kernel's instantiations."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties" in line:
            m = re.search(r"(attn_fwd_simt_kernel|fc2_bwd_simt_kernel)"
                          r"(?:ILi(\d+)E)?", line)
            fn = f"{m.group(1)}<{m.group(2) or ''}>" if m else None
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
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--seq", type=int, default=S)
    ap.add_argument("--head_dim", type=int, default=D)
    args = ap.parse_args()
    s_len, d_head = args.seq, args.head_dim
    if not torch.cuda.is_available():
        print("time_fp32_simt_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {n: variant_source(VARIANTS[n][1], VARIANTS[n][2])
               for n in args.variants}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b = args.batch
    rng = np.random.default_rng(b)

    def seeded(shape, scale=1.0):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to("cuda")

    qkv = seeded((b, s_len, 3 * H * d_head))
    dy, w2, h = seeded((b, S, O)), seeded((O, K), 0.02), seeded((b, S, K))
    want = {"k1": fa.attn_fwd_reference(qkv, H, d_head ** -0.5,
                                        with_stats=True),
            "k3": mf.fc2_bwd_reference(dy, w2, h)}
    m = b * S
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "batch": b, "seq": s_len,
        "head_dim": d_head, "variants": {}}
    for name in args.variants:
        kernel = VARIANTS[name][0]
        so, log = built[name]
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        if kernel == "k1":
            fn = lib.vtx_attn_fwd
            fn.argtypes = [P, P, P, I, I, I, I, ctypes.c_float, I, P]
            o = torch.empty((b, s_len, H * d_head), device="cuda")
            st = torch.empty((b, H, s_len, 2), device="cuda")
            outs = (o, st)
            args_ = (qkv.data_ptr(), o.data_ptr(), st.data_ptr(), b, s_len,
                     H, d_head, d_head ** -0.5, 2, stream)
        else:
            fn = lib.vtx_fc2_bwd
            fn.argtypes = [P] * 6 + [I] * 4 + [P]
            dh, a = torch.empty_like(h), torch.empty_like(h)
            part = torch.empty((-(-m // mf.ROW_TILE), K), device="cuda")
            outs = (dh, a, part)
            args_ = (dy.data_ptr(), w2.data_ptr(), h.data_ptr(),
                     dh.data_ptr(), a.data_ptr(), part.data_ptr(), m, O, K,
                     2, stream)
        fn.restype = I

        def launch():
            rc = fn(*args_)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        launch()
        torch.cuda.synchronize()
        got = outs if kernel == "k1" else (outs[0], outs[1],
                                           outs[2].sum(dim=0))
        row = {"ms": ms(launch), "ptxas": ptxas(log, kernel)}
        if name not in TIMES_ONLY:
            row["max_abs_err_over_max"] = [
                (g - w).abs().max().item() / w.abs().max().item()
                for g, w in zip(got, want[kernel])]
        out["variants"][name] = row

    def unfused():
        g = torch.ops.aten.gelu_backward(torch.matmul(dy, w2), h,
                                         approximate="tanh")
        return g, g.sum(dim=(0, 1), dtype=torch.float32)

    q, k_, v = (t.contiguous() for t in fa.heads(qkv, H))
    out["attn_fwd_ms"] = ms(lambda: fa.attn_fwd(qkv, H, with_stats=True))
    out["sdpa_fwd_ms"] = ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k_, v))
    out["fc2_bwd_ms"] = ms(lambda: mf.fc2_bwd(dy, w2, h))
    out["unfused_ms"] = ms(unfused)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
