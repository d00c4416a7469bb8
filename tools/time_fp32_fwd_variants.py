"""A/B of the fp32 K4 (csrc/flash_fwd_simt.cu: flash_fwd_simt_kernel)
against variants of it, on one NVIDIA GPU; the forward twin of
tools/time_fp32_bwd_variants.py, whose helpers it uses.

    python tools/time_fp32_fwd_variants.py [--batch 32] [--heads 12]
        [--head_dim 64] [--variants NAME ...]

Each variant is a text edit of a copy of the checkout's
csrc/flash_fwd_simt.cu (with csrc/simt_wide.cuh and csrc/simt_tiles.cuh
written into it), built with the port's nvcc flags under
build/variants/<name>/ (all builds started together) with a C shim around
its `flash_fwd_simt::fwd`, and launched on seeded fp32 q, k, v read from a
(B, 1370, 3 * H * D) projection (the 518-px model's shapes at H = 12, D =
64), writing o into (B, 1370, H, D) memory as `flash_fwd` does.

* as_is: the committed kernel;
* no_scores: the score product (s = q k^T) left out (times only);
* no_pv: the p v product left out (times only);
* no_exp: p = s - m and alpha = m - m' instead of their exponentials
  (times only);
* expf: the accurate expf instead of __expf (ex2.approx);
* no_stream: the K and V tiles loaded once, not once a tile (times only:
  what waiting for them costs);
* late_k: the next tile's K loaded with its V, after p v, instead of
  after the scores (its load then overlaps only the next scores' wait);
* rows16: at D <= 64 warps of 16 rows with 8 x 4 score tiles and 8 x 4
  lanes' worth of p v (8 warps a block, the D = 128 layout) instead of 32
  rows with 8 x 8 score tiles (4 warps);
* unroll1, unroll4: the score and p v loops unrolled 1 or 4 times instead
  of 2.

Past --head_dim 128 the variants that reach the wide register tiles
(flash_fwd_wide_simt_kernel) count:

* wide_no_scores, wide_no_pv: the score product or p v left out (times
  only);
* wide_no_stream: only the first pieces loaded, the later steps reading
  what the slots hold (times only: what the stream's waits cost);
* wide_no_k_copy, wide_no_v_copy: the same for the K or the V pieces
  alone (times only);
* wide_copy_twice: every piece copied twice into its slot (the same
  data: what the copies' own work costs);
* wide_nj8: 256-key score tiles (s on 8 x 8 register tiles, K pieces of
  256 keys x 16 columns) instead of 128-key ones (8 x 4, 128 x 32);
  wide_nj5, wide_nj6: 160- and 192-key tiles with K pieces of 32 columns
  (V pieces of 20 and 24 keys);
* wide_piece8192: pieces of 8192 floats (K 128 keys x 64 columns, V 32
  keys) instead of 4096 (half the stream's steps and barriers);
* wide_rows32: blocks of 32 query rows (4 warps, two blocks an SM)
  instead of 64 (8 warps, one);
* wide_slots4: a ring of 4 slots (3 copies in flight) instead of 3;
* wide_pv_unroll1: p v's loop over a V piece's keys unrolled once instead
  of twice.

Per variant: the median CUDA-event time of one launch (10 launches a
sample, 9 samples), the max abs error of o against the plain version
(ops/flash_blocked.py::flash_fwd_reference) over its largest magnitude
and of lse, and ptxas's registers and spills. Beside them the port's own
wrapper, its plain version and SDPA's fp32 forward. One JSON line, with
the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TOOLS)

from time_fp32_bwd_variants import (  # noqa: E402
    KEYS_SUM_LOOP,
    build,
    fb,
    ms,
    ptxas,
    variant_source,
)

SOURCE = "flash_fwd_simt.cu"
S = 1370
SCORES = "q_kt<kD>(s, qs, ks, r0, lx);"
PV = "p_v<kD>(acc, ps, vs, r0, lx, min(kTile, (S - k0 + 3) & ~3));"
NEXT_K = "if (next) stream(ks, kg, k0 + kTile);"
NEXT_V = "if (next) stream(vs, vg, k0 + kTile);"
LOOPS = ("#pragma unroll 2\n  for (int d = 0; d < kD; d += 4) {\n"
         "    float4 y[F::kNJ];",
         "#pragma unroll 2\n  for (int t = 0; t < n; t += 4) {")
EXP = "float exp_p(float x) { return __expf(x); }"
# the wide kernel's copies of a K and of a V piece into their ring slot
K_COPY = ("copy_tile<W::kKC, W::kKeys, W::kThr>(dst, kg + u * W::kKC, in.sr, "
          "k0,\n                                             S, D - u * "
          "W::kKC, vec);")
V_COPY = ("copy_tile<kD, W::kVR, W::kThr>(\n            dst, vg, in.sr, k0 + "
          "(u - W::kKPieces) * W::kVR, S, D, vec);")


def unrolled(n: str):
    return {loop: loop.replace("unroll 2", n) for loop in LOOPS}


VARIANTS = {
    "as_is": {},
    "no_scores": {SCORES: "if (0) " + SCORES},
    "no_pv": {PV: "if (0) " + PV},
    "no_exp": {EXP: "float exp_p(float x) { return x; }"},
    "expf": {EXP: "float exp_p(float x) { return expf(x); }"},
    "no_stream": {NEXT_K: "", NEXT_V: ""},
    "late_k": {NEXT_K: "",
               NEXT_V: "if (next) { stream(ks, kg, k0 + kTile); "
                       "stream(vs, vg, k0 + kTile); }",
               "cp_async_wait<1>();  // V of": "cp_async_wait<0>();  // V of"},
    "rows16": {"kLX = kD == 64 ? 8 : 16;": "kLX = 16;"},
    "unroll1": unrolled("unroll 1"),
    "unroll4": unrolled("unroll 4"),
    "wide_no_scores": {"      if (live)\n        wide_scores_n<W::kKC,":
                       "      if (0)\n        wide_scores_n<W::kKC,"},
    "wide_no_pv": {"keys_sum<kD, W::kVR, W::kKeys>(acc,":
                   "if (0) keys_sum<kD, W::kVR, W::kKeys>(acc,"},
    "wide_no_stream": {"    if (t < n_steps) {":
                       "    if (t < W::kSlots - 1) {"},
    "wide_no_k_copy": {K_COPY: "{ if (t < W::kSlots - 1) " + K_COPY + " }"},
    "wide_no_v_copy": {V_COPY: "{ if (t < W::kSlots - 1) " + V_COPY + " }"},
    "wide_copy_twice": {K_COPY: "{ " + K_COPY + " " + K_COPY + " }",
                        V_COPY: "{ " + V_COPY + " " + V_COPY + " }"},
    "wide_nj8": {"constexpr int kWideNJ = 4;": "constexpr int kWideNJ = 8;"},
    "wide_nj5": {"kWideNJ = 4;": "kWideNJ = 5;",
                 "kWidePiece = 4096;": "kWidePiece = 5120;"},
    "wide_nj6": {"kWideNJ = 4;": "kWideNJ = 6;",
                 "kWidePiece = 4096;": "kWidePiece = 6144;"},
    "wide_piece8192": {"kWidePiece = 4096;": "kWidePiece = 8192;"},
    "wide_rows32": {"kWideRows = 64;": "kWideRows = 32;"},
    "wide_slots4": {"kWideSlots = 3;": "kWideSlots = 4;"},
    "wide_pv_unroll1": {KEYS_SUM_LOOP: KEYS_SUM_LOOP.replace("unroll 2",
                                                             "unroll 1")},
}
TIMES_ONLY = {"no_scores", "no_pv", "no_exp", "no_stream", "wide_no_scores",
              "wide_no_pv", "wide_no_stream", "wide_no_k_copy",
              "wide_no_v_copy"}
SHIM = """
extern "C" int variant_fwd(const float* q, const float* k, const float* v,
    float* o, float* lse, int B, int H, int S, int D, float scale,
    const long long* in, const long long* out, void* stream) {
  return flash_fwd_simt::fwd(q, k, v, o, lse, B, H, S, D, scale, in, out,
                             (cudaStream_t)stream);
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    H, D = args.heads, args.head_dim
    if not torch.cuda.is_available():
        print("time_fp32_fwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {n: variant_source(VARIANTS[n], SOURCE, SHIM)
               for n in args.variants}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b = args.batch
    rng = np.random.default_rng(b)
    qkv = torch.from_numpy(rng.standard_normal((b, S, 3 * H * D)).astype(
        np.float32)).to("cuda")
    q, k, v = fb.heads(qkv, H)
    scale = D ** -0.5
    want_o, want_lse = fb.flash_fwd_reference(q, k, v, scale)
    top = want_o.abs().max().item()
    o = torch.empty((b, S, H, D), device="cuda").transpose(1, 2)
    lse = torch.empty((b, H, S), device="cuda")
    strides = [(ctypes.c_longlong * 3)(*fb._tma_layout(t)) for t in (q, o)]
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), "shape": [b, S, H, D], "variants": {}}
    for name in args.variants:
        so, log = built[name]
        lib = ctypes.CDLL(so)
        lib.variant_fwd.argtypes = [P] * 5 + [I] * 4 + [F] + [P] * 3
        lib.variant_fwd.restype = I

        def k4():
            rc = lib.variant_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b, H, S, D,
                                 scale, *strides, stream)
            if rc:
                raise RuntimeError(f"{name}: K4 launch failed ({rc})")

        k4()
        torch.cuda.synchronize()
        row = {"k4_ms": ms(k4), "ptxas": ptxas(log)}
        if name not in TIMES_ONLY:
            row["o_max_abs_err_over_max"] = (o - want_o).abs().max().item() \
                / top
            row["lse_max_abs_err"] = (lse - want_lse).abs().max().item()
        out["variants"][name] = row

    dense = [t.contiguous() for t in (q, k, v)]
    out["flash_fwd_ms"] = ms(lambda: fb.flash_fwd(q, k, v, scale))
    out["plain_ms"] = ms(lambda: fb.flash_fwd_reference(q, k, v, scale))
    out["sdpa_fwd_ms"] = ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(*dense))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
