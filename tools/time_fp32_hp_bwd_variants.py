"""A/B of the fp32 backward of K8, K10 and K12 (csrc/hp_bwd_simt.cu:
hp_bwd_stats_simt_kernel, hp_bwd_dkdv_simt_kernel and hp_bwd_dq_sum_kernel)
against variants of it, on
one NVIDIA GPU, with the helpers of tools/time_fp32_bwd_variants.py and
tools/time_hp_bwd_variants.py.

    python tools/time_fp32_hp_bwd_variants.py [--batch 128] [--seq 197]
        [--head_dim 64] [--variants NAME ...]

or, with --kernel attn_bwd, of the fp32 K2 at head dims 129-256
(csrc/attn_bwd_simt.cu, whose dk/dv launch carries over the wide tiles
below, on K1's row stats):

    python tools/time_fp32_hp_bwd_variants.py --kernel attn_bwd --batch 32 \
        --head_dim 256 [--variants NAME ...]

Each variant is a text edit of a copy of the checkout's
csrc/hp_bwd_simt.cu (with csrc/simt_wide.cuh and csrc/simt_tiles.cuh
written into it), built
with the port's nvcc flags under build/variants/<name>/ (all builds
started together) with a C shim around its `hp_bwd_simt::run`, and
launched as K10 is: q, k, v read from a seeded fp32 (B, S, 3 * 12 * D)
qkv buffer, dO from (B, S, 12 * D), dq, dk, dv written into one such
buffer. At D <= 128 (the default 64) the variants below edit the narrow
tiles; past 128 the wide ones (the wide_* variants, the default there):

* as_is: the committed kernels;
* no_scores: every score product (s and dp, in the stats and dk/dv
  launches) left out (times only);
* no_sums: the summed products (dv, dk and the parts of dq) left out
  (times only);
* no_exp: exp(x) = x (times only);
* no_trim: no warp skips a streamed tile's keys or queries past S (times
  only: what trimming the last tile saves);
* stats_1buf: the stats launch with one streamed buffer (107 KB: two
  blocks an SM, at most 128 registers a thread) instead of two;
* stats_rows64: stats blocks of 64 queries and 4 warps instead of 128 and
  8;
* unroll1, unroll4: the score and sum loops unrolled 1 or 4 times instead
  of 2;
* wide_no_scores, wide_no_sums: the wide tiles' score products (rows_dot,
  keys_dot), or their summed ones (keys_sum and the parts of dq), left out
  (times only);
* wide_dq_unroll2, wide_dq_unroll4: the dk/dv launch's part of dq
  unrolled 2 or 4 times over the keys instead of not at all;
* wide_sum_unroll1, wide_dot_unroll1, wide_rows_unroll2: keys_sum and
  keys_dot unrolled once instead of twice, rows_dot twice instead of 4
  times.

For --kernel attn_bwd the variants edit csrc/attn_bwd_simt.cu the same way
(its C shim wraps `attn_bwd_simt::run`, launched on a seeded (B, S, 3 * 12
* D) qkv buffer, dO (B, S, 12 * D) and K1's o and row stats): as_is,
wide_no_scores, wide_no_sums (with the dq launch's sum of the parts),
wide_dq_unroll2, wide_sum_unroll1, wide_dot_unroll1 (at kD 192 too: the
committed source unrolls keys_dot once at 256 alone), wide_hp_loop (kD
256 with kD 192's settings: keys_dot unrolled twice, dq's part in one
pass, as csrc/hp_bwd_simt.cu's loop), dq_one_pass, and no_bias (the dk/dv
launch's column sums and the dq launch's, times only). Its error is
of dqkv against ops/flash_attention.py::attn_bwd_reference, and beside it
stand the port's `attn_bwd`, that plain version and SDPA's fp32 backward.

Per variant: the median CUDA-event time of one call (its launches; 10
calls a sample, 9 samples), the device time per call of each kernel
(torch.profiler over 10 calls), the max abs error of dqkv against the
plain version (ops/flash_attention.py::hp_bwd_reference) over its largest
magnitude, and ptxas's registers and spills. Beside them the port's own
`hp_bwd`, its plain version and SDPA's fp32 backward. One JSON line, with
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
    build,
    fb,
    ms,
    ptxas,
    variant_source,
)
from time_hp_bwd_variants import device_ms, fa  # noqa: E402

SOURCE = "hp_bwd_simt.cu"
H = 12
SCORES = "score_tiles<kD>(s, dp, "
SUMS = "sum_tile<kD, kTile"
LOOPS = ("#pragma unroll 2\n  for (int d = 0; d < kD; d += 4) {",
         "#pragma unroll 2\n  for (int t = 0; t < kK; t += 4) {")
EXP = "float exp_p(float x) { return __expf(x); }"
SHAPE_64 = "#define VTX_HP_BWD_SIMT_64 64, 128, 2, 128, 2"


def unrolled(n: str):
    return {loop: loop.replace("unroll 2", n) for loop in LOOPS}


VARIANTS = {
    "as_is": {},
    "no_scores": {SCORES: "if (0) " + SCORES},
    "no_sums": {SUMS: "if (0) " + SUMS,
                "dq_part_tile<kD>(dqp,": "if (0) dq_part_tile<kD>(dqp,"},
    "no_exp": {EXP: "float exp_p(float x) { return x; }"},
    "no_trim": {"k0 + 32 * at.half < S": "k0 < S",
                "const bool short_tile = q0 + kTile / 2 >= S;":
                "const bool short_tile = false;"},
    "stats_1buf": {SHAPE_64: "#define VTX_HP_BWD_SIMT_64 64, 128, 2, 128, 1"},
    "stats_rows64": {SHAPE_64:
                     "#define VTX_HP_BWD_SIMT_64 64, 128, 2, 64, 2"},
    "unroll1": unrolled("unroll 1"),
    "unroll4": unrolled("unroll 4"),
}
WIDE_DQ = "constexpr int kWideDqUnroll = 1;"
DOT_LOOP = "#pragma unroll 2\n  for (int d = 0; d < kD; d += 4) {\n    "
WIDE_VARIANTS = {
    "wide_no_scores": {
        "keys_dot<kD, 1>(x, kv, qd);": "{}",
        "keys_dot<kD, 2>(x, kv, qd);": "{}",
        "if (rows_live) rows_dot<kD>(s,": "if (0) rows_dot<kD>(s,",
        "if (rows_live) rows_dot<kD>(dp,": "if (0) rows_dot<kD>(dp,"},
    "wide_no_sums": {
        "keys_sum<kD, kTile / 2>(acc, pd, y, lane);": "{}",
        "keys_sum<kD, kTile>(acc, pd, y, lane);": "{}",
        "dq_part_tile<kD, kWideDqUnroll>(dqp,":
        "if (0) dq_part_tile<kD, kWideDqUnroll>(dqp,"},
    "wide_dq_unroll2": {WIDE_DQ: WIDE_DQ.replace("1;", "2;")},
    "wide_dq_unroll4": {WIDE_DQ: WIDE_DQ.replace("1;", "4;")},
    "wide_sum_unroll1": {
        "#pragma unroll 2\n  for (int q = 0; q < kK; q += 4) {":
        "#pragma unroll 1\n  for (int q = 0; q < kK; q += 4) {"},
    "wide_dot_unroll1": {
        "template <int kD, int kJ, int kDotUnroll = 2>":
        "template <int kD, int kJ, int kDotUnroll = 1>"},
    "wide_rows_unroll2": {
        DOT_LOOP.replace("2", "4", 1) + "const float4 y":
        DOT_LOOP + "const float4 y"},
}
VARIANTS.update(WIDE_VARIANTS)
TIMES_ONLY = {"no_scores", "no_sums", "no_exp", "no_trim", "wide_no_scores",
              "wide_no_sums", "no_bias"}
# the fp32 K2 past 128 (csrc/attn_bwd_simt.cu)
K2_SOURCE = "attn_bwd_simt.cu"
K2_SETTINGS = ("  static constexpr int kDotUnroll = kD == 256 ? 1 : 2;\n"
               "  static constexpr int kDqPasses = kD == 256 ? 2 : 1;")
K2_VARIANTS = {
    "as_is": {},
    "wide_no_scores": {
        "keys_dot<kD, 1, K2Wide<kD>::kDotUnroll>(x, kv, qd);": "{}",
        "keys_dot<kD, 2, K2Wide<kD>::kDotUnroll>(x, kv, qd);": "{}"},
    "wide_no_sums": {
        "keys_sum<kD, kTile / 2>(acc, pd, y, lane);": "{}",
        "keys_sum<kD, kTile>(acc, pd, y, lane);": "{}",
        "  dq_part_tile<kD, kWideDqUnroll, kG0, kGn>(dqp,":
        "  if (0) dq_part_tile<kD, kWideDqUnroll, kG0, kGn>(dqp,",
        "    for (int n = 1; n < n_kb; ++n) {":
        "    for (int n = 1; n < 0; ++n) {"},
    "wide_dq_unroll2": WIDE_VARIANTS["wide_dq_unroll2"],
    "wide_sum_unroll1": WIDE_VARIANTS["wide_sum_unroll1"],
    "wide_dot_unroll1": {K2_SETTINGS: K2_SETTINGS.replace("? 1 : 2", "? 1 : 1")},
    # the settings of kD 192 at kD 256 too: hp_bwd_dkdv_wide_simt_kernel's
    # loop (255 registers and 24 bytes of spills at 256)
    "wide_hp_loop": {K2_SETTINGS: K2_SETTINGS.replace("? 1 : 2", "? 2 : 2")
                     .replace("? 2 : 1", "? 1 : 1")},
    "dq_one_pass": {K2_SETTINGS: K2_SETTINGS.replace("? 2 : 1", "? 1 : 1")},
    "no_bias": {
        "  for (int c = threadIdx.x; c < D; c += 256) {":
        "  for (int c = threadIdx.x; c < 0; c += 256) {",
        "  if (threadIdx.x < D)\n    part[": "  if (0)\n    part["},
}
K2_SHIM = """
extern "C" long long variant_scratch(int B, int H, int S, int D) {
  return attn_bwd_simt::scratch_floats(B, H, S, D);
}
extern "C" int variant_bwd(const float* qkv, const float* dout,
    const float* out, const float* st, float* dqkv, float* dbias,
    float* scratch, int B, int S, int H, int D, float scale, void* stream) {
  return attn_bwd_simt::run(qkv, dout, out, st, dqkv, dbias, scratch, B, S,
                            H, D, scale, (cudaStream_t)stream);
}
"""
SHIM = """
extern "C" long long variant_scratch(int B, int H, int S, int D) {
  return hp_bwd_simt::scratch_floats(B, H, S, D);
}
extern "C" int variant_bwd(const void* const* ptrs, const long long* strides,
    float* scratch, int B, int S, int H, int D, float scale, void* stream) {
  return hp_bwd_simt::run(ptrs, strides, scratch, B, S, H, D, scale,
                          (cudaStream_t)stream);
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--head_dim", type=int, default=64)
    ap.add_argument("--kernel", default="hp_bwd",
                    choices=("hp_bwd", "attn_bwd"))
    ap.add_argument("--variants", nargs="+",
                    choices=sorted(set(VARIANTS) | set(K2_VARIANTS)))
    args = ap.parse_args()
    D = args.head_dim
    k2 = args.kernel == "attn_bwd"
    variants, source, shim = ((K2_VARIANTS, K2_SOURCE, K2_SHIM) if k2
                              else (VARIANTS, SOURCE, SHIM))
    if k2 and not 128 < D <= 256:
        raise SystemExit("--kernel attn_bwd takes a head dim in 129-256")
    if not args.variants:
        args.variants = list(K2_VARIANTS) if k2 else ["as_is"] + [
            n for n in VARIANTS if n != "as_is"
            and n.startswith("wide_") == (D > 128)]
    unknown = sorted(set(args.variants) - set(variants))
    if unknown:
        raise SystemExit(f"no variants {unknown} for --kernel {args.kernel}")
    if not torch.cuda.is_available():
        print("time_fp32_hp_bwd_variants: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {}
    for n in args.variants:
        text = variant_source({}, source, shim)
        for old, new in variants[n].items():
            if old not in text:
                raise SystemExit(f"{source} no longer holds {old!r}")
            text = text.replace(old, new)
        sources[n] = text
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))

    b, s = args.batch, args.seq
    rng = np.random.default_rng(b + s)

    def seeded(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to("cuda")

    qkv, do = seeded((b, s, 3 * H * D)), seeded((b, s, H * D))
    scale = D ** -0.5
    if k2:
        return time_k2(args, built, qkv, do, scale)
    want = fa.hp_bwd_reference(qkv, do, H, scale)
    top = want.abs().max().item()
    dqkv = torch.empty_like(qkv)
    ins = (*fb.heads(qkv, H), fa._head_major(do, H))
    outs = fb.heads(dqkv, H)
    ptrs = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in (*ins, *outs)))
    strides = fa._stride_array((*ins, *outs), s, D)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out = {"card": card(), "shape": [b, s, H, D], "variants": {}}
    for name in args.variants:
        so, log = built[name]
        lib = ctypes.CDLL(so)
        lib.variant_bwd.argtypes = [P, P, P] + [I] * 4 + [F, P]
        lib.variant_bwd.restype = I
        lib.variant_scratch.argtypes = [I] * 4
        lib.variant_scratch.restype = ctypes.c_longlong
        scratch = torch.empty(lib.variant_scratch(b, H, s, D), device="cuda")

        def call():
            rc = lib.variant_bwd(ptrs, strides, scratch.data_ptr(), b, s, H,
                                 D, scale, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        call()
        torch.cuda.synchronize()
        row = {"ms": ms(call), "device_ms": device_ms(call),
               "ptxas": ptxas(log)}
        if name not in TIMES_ONLY:
            row["max_abs_err_over_max"] = (dqkv - want).abs().max().item() \
                / top
        out["variants"][name] = row

    q, k, v = (t.detach().contiguous().requires_grad_() for t in ins[:3])
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = ins[3].contiguous()
    out["hp_bwd_ms"] = ms(lambda: fa.hp_bwd(qkv, do, H, scale))
    out["plain_ms"] = ms(lambda: fa.hp_bwd_reference(qkv, do, H, scale))
    out["sdpa_bwd_ms"] = ms(lambda: torch.autograd.grad(
        sdpa, (q, k, v), g, retain_graph=True))
    print(json.dumps(out), flush=True)
    return 0


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def sdpa_bwd_ms(qkv, do, b, s, D) -> float:
    """SDPA's whole fp32 backward on contiguous (B, H, S, D) copies of the
    heads of qkv, with dO from do."""
    q, k, v = (t.detach().contiguous().requires_grad_()
               for t in fb.heads(qkv, H))
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = fa._head_major(do, H).contiguous()
    return ms(lambda: torch.autograd.grad(sdpa, (q, k, v), g,
                                          retain_graph=True))


def time_k2(args, built, qkv, do, scale) -> int:
    """The --kernel attn_bwd variants on K1's o and row stats, beside the
    port's attn_bwd, its plain version and SDPA; prints the JSON line."""
    b, s, D = args.batch, args.seq, args.head_dim
    o, st = fa.attn_fwd(qkv, H, with_stats=True)
    want, want_bias = fa.attn_bwd_reference(qkv, do, o, st, H, scale)
    top = want.abs().max().item()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(want_bias)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out = {"card": card(), "kernel": "attn_bwd", "shape": [b, s, H, D],
           "variants": {}}
    for name in args.variants:
        so, log = built[name]
        lib = ctypes.CDLL(so)
        lib.variant_bwd.argtypes = [P] * 7 + [I] * 4 + [F, P]
        lib.variant_bwd.restype = I
        lib.variant_scratch.argtypes = [I] * 4
        lib.variant_scratch.restype = ctypes.c_longlong
        scratch = torch.empty(lib.variant_scratch(b, H, s, D), device="cuda")

        def call():
            rc = lib.variant_bwd(qkv.data_ptr(), do.data_ptr(), o.data_ptr(),
                                 st.data_ptr(), dqkv.data_ptr(),
                                 dbias.data_ptr(), scratch.data_ptr(), b, s,
                                 H, D, scale, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        call()
        torch.cuda.synchronize()
        row = {"ms": ms(call), "device_ms": device_ms(call),
               "ptxas": ptxas(log)}
        if name not in TIMES_ONLY:
            row["max_abs_err_over_max"] = (dqkv - want).abs().max().item() \
                / top
            row["bias_err_over_max"] = (dbias - want_bias).abs().max().item() \
                / want_bias.abs().max().item()
        out["variants"][name] = row
        del scratch
    out["attn_bwd_ms"] = ms(lambda: fa.attn_bwd(qkv, do, o, st, H, scale))
    out["attn_bwd_device_ms"] = device_ms(
        lambda: fa.attn_bwd(qkv, do, o, st, H, scale))
    out["plain_ms"] = ms(lambda: fa.attn_bwd_reference(qkv, do, o, st, H,
                                                       scale))
    out["sdpa_bwd_ms"] = sdpa_bwd_ms(qkv, do, b, s, D)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
