"""A/B of the fp32 K5 and K6 (csrc/flash_bwd_simt.cu:
flash_bwd_dkdv_simt_kernel, flash_bwd_dq_simt_kernel and past 128 their
wide kernels) against variants of them, on one NVIDIA GPU.

    python tools/time_fp32_bwd_variants.py [--batch 32] [--heads 12]
        [--head_dim 64] [--variants NAME ...]

Each variant is a text edit of a copy of the checkout's
csrc/flash_bwd_simt.cu (with csrc/simt_wide.cuh and csrc/simt_tiles.cuh,
its tiles, written into it), built with the port's nvcc flags under
build/variants/<name>/ (all builds started together) with a C shim around
its `flash_bwd_simt::dkdv` and `dq`, and launched on seeded fp32 q, k, v
read from a (B, 1370, 3 * H * D) projection, dO a view of (B, 1370, H,
D) memory, and lse and delta of the plain forward (the 518-px model's
shapes at H = 12, D = 64), writing views of one dqkv buffer as
`flash_bwd` does.

* as_is: the committed kernels;
* no_scores: the score products (s = q k^T, dp = dO v^T) left out (times
  only);
* no_sums: the summed products (dv, dk; dq) left out (times only);
* no_exp: p = s scale - lse instead of its exponential (times only);
* expf: the accurate expf instead of __expf (ex2.approx);
* no_stream: the streamed tiles loaded once, not once a tile (times only:
  what waiting for them costs);
* block_sync: block-wide barriers where a row group's two warps (K5) or
  each warp alone (K6) wait for the p and ds they need;
* rows64, rows64_2buf, rows128_1buf: at D <= 64, blocks of 64 rows with
  one streamed buffer (two blocks an SM) or two (one block), or of 128
  rows with one, instead of 128 rows with two;
* unroll1, unroll4: the score and sum loops unrolled 1 or 4 times instead
  of 2.

Past --head_dim 128 the variants that reach the wide kernels count: K5's
(flash_bwd_dkdv_wide_simt_kernel)

* wide_no_scores, wide_no_sums: the score products (s^T, dp^T) or the
  summed ones (dv, dk) left out (times only);
* wide_no_stream: the first query tile loaded alone, the later tiles
  reading what the buffer holds (times only: what waiting for each tile's
  q, dO, lse and delta costs);
* wide_dot_unroll1: keys_dot's loop over the head dim unrolled once
  instead of twice;
* wide_sum_unroll1: keys_sum's loop over the queries unrolled once
  instead of twice (K6's ds k too);

and K6's (flash_bwd_dq_wide_simt_kernel):

* wide_dq_no_scores, wide_dq_no_sums: the score products (s, dp) or the
  sum dq += ds k left out (times only);
* wide_dq_no_stream: only the first pieces loaded, the later steps
  reading what the ring holds (times only: what waiting for the pieces
  costs);
* wide_dq_no_row_copy: the same for the K row pieces of ds k alone
  (times only: what reading K a second time costs);
* wide_dq_copy_twice: every piece copied twice into its slot (the copies'
  own work);
* wide_dq_nj2: 64-key tiles (s and dp on 8 x 2 register tiles, K and V
  pieces of 64 columns) instead of 128;
* wide_dq_dot_unroll4: the score pieces' loop over the head dim unrolled
  4 times instead of fully.

Per variant: the median CUDA-event time of one launch of each kernel (10
launches a sample, 9 samples), the max abs error of each output against
the plain version (ops/flash_blocked.py::flash_bwd_dkdv_reference,
flash_bwd_dq_reference) over the call's largest gradient, and ptxas's
registers and spills. Beside them the port's own wrappers and SDPA's fp32
backward. One JSON line, with the card's name and power limit
(nvidia-smi).
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
    flash_blocked as fb,
)

OUT = os.path.join(REPO, "build", "variants")
SOURCE = "flash_bwd_simt.cu"
S = 1370
K5_SCORES = "score_tiles<kD>(s, dp, ks, bq, vs, bdo, at.r0, at.c);"
K6_SCORES = "score_tiles<kD>(s, dp, qs, bk, dos, bv, at.r0, at.c);"
K5_SUMS = "sum_tile<kD, kTile>(acc,"
K6_SUMS = "sum_tile<kD, kTile / 2>(acc,"
LOOPS = ("#pragma unroll 2\n  for (int d = 0; d < kD; d += 4) {",
         "#pragma unroll 2\n  for (int t = 0; t < kK; t += 4) {")
EXP = "float exp_p(float x) { return __expf(x); }"
SHAPE_64 = "#define VTX_BWD_SIMT_64 64, 128, 2"
# the wide K5's products: s^T or dp^T and the sums, each for a whole and a
# short query tile
WIDE_DOTS = tuple(f"keys_dot<kD, {j}>(x, kv, qd);" for j in (1, 2))
WIDE_SUMS = tuple(f"keys_sum<kD, {n}>(acc, pd, y, lane);"
                  for n in ("kTile / 2", "kTile"))
KEYS_SUM_LOOP = "#pragma unroll 2\n  for (int q = 0; q < kK; q += 4) {"
# the wide K6's products and copies
DQ_DOTS = tuple(f"            nj, x, {a} + c * W::kKC,"
                for a in ("qw", "dow"))
DQ_SUM = "keys_sum<kD, W::kVR, W::kKeys>(acc, dsw"
DQ_PIECE_COPY = ("copy_tile<W::kKC, W::kKeys, W::kThr>(\n            dst, "
                 "(u < W::kKPieces ? kg : vg) + c, in.sr, k0, S, D - c, vec);")
DQ_ROW_COPY = ("copy_tile<kD, W::kVR, W::kThr>(\n            dst, kg, in.sr, "
               "k0 + (u - 2 * W::kKPieces) * W::kVR, S, D, vec);")
DQ_DOT_LOOP = "#pragma unroll\n  for (int d = 0; d < kKC; d += 4) {"


def unrolled(n: str):
    return {loop: loop.replace("unroll 2", n) for loop in LOOPS}


VARIANTS = {
    "as_is": {},
    "no_scores": {K5_SCORES: "if (0) " + K5_SCORES,
                  K6_SCORES: "if (0) " + K6_SCORES},
    "no_sums": {K5_SUMS: "if (0) " + K5_SUMS, K6_SUMS: "if (0) " + K6_SUMS},
    "no_exp": {EXP: "float exp_p(float x) { return x; }"},
    "expf": {EXP: "float exp_p(float x) { return expf(x); }"},
    "no_stream": {
        "    const int u = kBufs == 2 ? t & 1 : 0;\n    const float* bq":
        "    const int u = 0;\n    const float* bq",
        "    const int u = kBufs == 2 ? t & 1 : 0;\n    const float* bk":
        "    const int u = 0;\n    const float* bk",
        "if (kBufs == 2 && q0 + kTile < S) stream(u ^ 1, q0 + kTile);": "",
        "      if (q0 + kTile < S) stream(0, q0 + kTile);": "",
        "if (kBufs == 2 && k0 + kTile < S) stream(u ^ 1, k0 + kTile);": "",
        "      if (k0 + kTile < S) stream(0, k0 + kTile);": ""},
    "block_sync": {"static constexpr bool kOwn = 2 * kGroups == kWarps;":
                   "static constexpr bool kOwn = false;"},
    "rows64": {SHAPE_64: "#define VTX_BWD_SIMT_64 64, 64, 1"},
    "rows64_2buf": {SHAPE_64: "#define VTX_BWD_SIMT_64 64, 64, 2"},
    "rows128_1buf": {SHAPE_64: "#define VTX_BWD_SIMT_64 64, 128, 1"},
    "unroll1": unrolled("unroll 1"),
    "unroll4": unrolled("unroll 4"),
    "wide_no_scores": {call: ";" for call in WIDE_DOTS},
    "wide_no_sums": {call: ";" for call in WIDE_SUMS},
    "wide_no_stream": {"    if (q0 + kTile < S) stream(q0 + kTile);": ""},
    "wide_dot_unroll1": {call: call.replace(">(", ", 1>(")
                         for call in WIDE_DOTS},
    "wide_sum_unroll1": {KEYS_SUM_LOOP: KEYS_SUM_LOOP.replace("unroll 2",
                                                              "unroll 1")},
    "wide_dq_no_scores": {call: "            0, x, " + call[19:]
                          for call in DQ_DOTS},
    "wide_dq_no_sums": {DQ_SUM: "if (0) " + DQ_SUM},
    "wide_dq_no_stream": {"    if (t < n_steps) {":
                          "    if (t < W::kSlots - 1) {"},
    "wide_dq_no_row_copy": {DQ_ROW_COPY: "if (t < W::kSlots - 1) "
                            + DQ_ROW_COPY},
    "wide_dq_copy_twice": {DQ_PIECE_COPY: "{ " + DQ_PIECE_COPY + " "
                           + DQ_PIECE_COPY + " }",
                           DQ_ROW_COPY: "{ " + DQ_ROW_COPY + " " + DQ_ROW_COPY
                           + " }"},
    "wide_dq_nj2": {"constexpr int kDqNJ = 4;": "constexpr int kDqNJ = 2;"},
    "wide_dq_dot_unroll4": {DQ_DOT_LOOP: DQ_DOT_LOOP.replace(
        "unroll\n", "unroll 4\n")},
}
TIMES_ONLY = {"no_scores", "no_sums", "no_exp", "no_stream",
              "wide_no_scores", "wide_no_sums", "wide_no_stream",
              "wide_dq_no_scores", "wide_dq_no_sums", "wide_dq_no_stream",
              "wide_dq_no_row_copy"}
SHIM = """
extern "C" int variant_dkdv(const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, float* dk,
    float* dv, int B, int H, int S, int D, float scale, const long long* in,
    const long long* og, const long long* gr, void* stream) {
  return flash_bwd_simt::dkdv(q, k, v, dout, lse, delta, dk, dv, B, H, S, D,
                              scale, in, og, gr, (cudaStream_t)stream);
}
extern "C" int variant_dq(const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, float* dq,
    int B, int H, int S, int D, float scale, const long long* in,
    const long long* og, const long long* gr, void* stream) {
  return flash_bwd_simt::dq(q, k, v, dout, lse, delta, dq, B, H, S, D,
                            scale, in, og, gr, (cudaStream_t)stream);
}
"""


def variant_source(edits, source: str = SOURCE, shim: str = SHIM) -> str:
    """csrc/`source` with csrc/simt_wide.cuh and csrc/simt_tiles.cuh written
    into it where it includes them (so that an edit may reach the shared
    tiles), each edit made once, and `shim`."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    for header in ("simt_wide.cuh", "simt_tiles.cuh"):
        include = f'#include "{header}"'
        text = text.replace(include,
                            (cuda_build.CSRC_DIR / header).read_text(), 1)
        text = text.replace(include, "")  # once is enough
    for old, new in edits.items():
        if text.count(old) != 1:
            raise SystemExit(f"{source} holds {old!r} {text.count(old)} times")
        text = text.replace(old, new)
    return text + shim


def build(name: str, source: str):
    """nvcc of one variant into build/variants/<name>/lib.so; returns the
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


def ptxas(log: str):
    """Registers, shared memory and spills of each *_simt_kernel<ints>."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties" in line:
            m = re.search(r"\d((?:flash|hp|attn)_[a-z_]*?_simt_kernel)I"
                          r"((?:Li\d+E)+)E", line)
            fn = f"{m.group(1)}<{', '.join(re.findall(r'\d+', m.group(2)))}>" \
                if m else None
        elif fn and ("registers" in line or "spill" in line):
            out.setdefault(fn, []).append(line.split(":")[-1].strip())
    return out


def ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fp32_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    H, D = args.heads, args.head_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {n: variant_source(VARIANTS[n]) for n in args.variants}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b = args.batch
    rng = np.random.default_rng(b)

    def seeded(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to("cuda")

    qkv = seeded((b, S, 3 * H * D))
    q, k, v = fb.heads(qkv, H)
    do = seeded((b, S, H * D)).view(b, S, H, D).transpose(1, 2)
    scale = D ** -0.5
    o, lse = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o, do)
    dq, dk, dv = fb.heads(torch.empty_like(qkv), H)
    want = (fb.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
            *fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale))
    top = max(w.abs().max().item() for w in want)
    del o
    strides = [(ctypes.c_longlong * 3)(*fb._tma_layout(t))
               for t in (q, do, dq)]
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr()]
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "shape": [b, S, H, D], "variants": {}}
    for name in args.variants:
        so, log = built[name]
        lib = ctypes.CDLL(so)
        lib.variant_dkdv.argtypes = [P] * 8 + [I] * 4 + [F] + [P] * 4
        lib.variant_dq.argtypes = [P] * 7 + [I] * 4 + [F] + [P] * 4
        lib.variant_dkdv.restype = lib.variant_dq.restype = I

        def k5():
            rc = lib.variant_dkdv(*common, dk.data_ptr(), dv.data_ptr(), b, H,
                                  S, D, scale, *strides, stream)
            if rc:
                raise RuntimeError(f"{name}: K5 launch failed ({rc})")

        def k6():
            rc = lib.variant_dq(*common, dq.data_ptr(), b, H, S, D, scale,
                                *strides, stream)
            if rc:
                raise RuntimeError(f"{name}: K6 launch failed ({rc})")

        k5()
        k6()
        torch.cuda.synchronize()
        row = {"k5_ms": ms(k5), "k6_ms": ms(k6), "ptxas": ptxas(log)}
        if name not in TIMES_ONLY:
            row["max_abs_err_over_max"] = [
                (g - w).abs().max().item() / top
                for g, w in zip((dq, dk, dv), want)]
        out["variants"][name] = row

    dense = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention(*dense)
    out["flash_bwd_dkdv_ms"] = ms(lambda: fb.flash_bwd_dkdv(
        q, k, v, do, lse, delta, dk, dv, scale))
    out["flash_bwd_dq_ms"] = ms(lambda: fb.flash_bwd_dq(
        q, k, v, do, lse, delta, dq, scale))
    out["sdpa_bwd_ms"] = ms(lambda: torch.autograd.grad(
        sdpa, dense, do.contiguous(), retain_graph=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
