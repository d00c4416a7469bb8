// The wide fp32 register tiles (head dims 129-256, compile-time kD 192 or
// 256) of the attention backwards that hold 32 keys a block, shared by
// csrc/hp_bwd_simt.cu (K8, K10, K12), csrc/attn_bwd_simt.cu (K2) and
// csrc/flash_bwd_simt.cu (the blocked K5), and the product that forms
// each key block's part of dq, which csrc/hp_bwd_simt.cu's narrow tiles
// use too; and the tiles of the blocked K4 and K6 past 128, whose warps
// own 8 whole query rows (csrc/flash_fwd_simt.cu, csrc/flash_bwd_simt.cu:
// wide_scores scores them, keys_sum sums p v or ds k, store_o writes o
// or dq).
//
// A dk/dv block of 8 warps holds kWideKeys keys, each warp 8 of them, and
// streams 64-query tiles (lane l holding queries l and l + 32): keys_dot
// scores s^T or dp^T of the warp's keys, keys_sum sums dv += p^T dO or dk
// += ds^T q of them (a lane's kD / 32 columns, wide_col), and
// dq_part_tile forms ds k over the block's keys for all 64 queries. Rows
// are staged at pitch kD + 4 (csrc/simt_tiles.cuh), p and ds [key][query]
// at pitch kPS.

#pragma once

#include "simt_tiles.cuh"

namespace {

constexpr int kWideKeys = 32;
// dq's part not unrolled over the keys: unrolled twice or four times, with
// dv or dk live, it takes 255 registers and spills 4-16 bytes at kD 256 (at
// the same time, tools/time_fp32_hp_bwd_variants.py)
constexpr int kWideDqUnroll = 1;

// out[i][4 g + e] = sum_{r < n} ds[r kPS + 4 qg + i] k[r kP + 64 (kG0 + g)
// + 4 dg + e] (i < 4, g < kGn, e < 4): dq's part, over the block's n keys,
// of the tile's 64 queries in the column groups [kG0, kG0 + kGn) of 64
// (by default all kD / 64), thread (qg, dg) = (tid / 16, tid % 16) of 256
// holding 4 queries by 4 columns a group; ds read as float4 along the
// queries, k as float4 along the head dim; the loop over the keys unrolled
// kUnroll times.
template <int kD, int kUnroll = 4, int kG0 = 0, int kGn = kD / 64>
__device__ __forceinline__ void dq_part_tile(float (&out)[4][4 * kGn],
                                             const float* __restrict__ ds,
                                             const float* __restrict__ k,
                                             int n) {
  constexpr int kP = kD + 4;
  const int qg = threadIdx.x >> 4, dg = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGn; ++c) out[i][c] = 0.f;
#pragma unroll kUnroll
  for (int r = 0; r < n; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(ds + r * kPS + 4 * qg);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int g = 0; g < kGn; ++g) {
      const float4 y = *reinterpret_cast<const float4*>(
          k + r * kP + 64 * (kG0 + g) + 4 * dg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i][4 * g] = fmaf(xs[i], y.x, out[i][4 * g]);
        out[i][4 * g + 1] = fmaf(xs[i], y.y, out[i][4 * g + 1]);
        out[i][4 * g + 2] = fmaf(xs[i], y.z, out[i][4 * g + 2]);
        out[i][4 * g + 3] = fmaf(xs[i], y.w, out[i][4 * g + 3]);
      }
    }
  }
}

// x[i][j] += sum_{d < kD} a[i kP + d] b[32 j kP + d] (i < 8, j < kJ): the
// warp's 8 keys of a against the lane's queries b and b + 32 rows, the loop
// over the head dim unrolled kDotUnroll times.
template <int kD, int kJ, int kDotUnroll = 2>
__device__ __forceinline__ void keys_dot(float (&x)[8][2],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b) {
  constexpr int kP = kD + 4;
#pragma unroll kDotUnroll
  for (int d = 0; d < kD; d += 4) {
    float4 y[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 32 * j * kP + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 r = *reinterpret_cast<const float4*>(a + i * kP + d);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        x[i][j] = fmaf(r.x, y[j].x, x[i][j]);
        x[i][j] = fmaf(r.y, y[j].y, x[i][j]);
        x[i][j] = fmaf(r.z, y[j].z, x[i][j]);
        x[i][j] = fmaf(r.w, y[j].w, x[i][j]);
      }
    }
  }
}

// The lane's column c (< kD / 32) of a summed row: 4 lane + c and 128 + 4
// lane + c - 4 at kD 256; 4 lane + c and 128 + 2 lane + c - 4 at 192.
template <int kD>
__device__ __forceinline__ int wide_col(int lane, int c) {
  return c < 4 ? 4 * lane + c
               : 128 + (kD == 256 ? 4 : 2) * lane + c - 4;
}

// acc[i][c] += sum_{t < kK} a[i kAP + t] b[t kP + wide_col(c)]: dv += p^T
// dO or dk += ds^T q of the warp's 8 keys over kK queries, a (p or ds, the
// same for every lane) read as float4 along the queries, b as float4 (and
// float2 at kD 192) along the head dim; also the blocked forward's p v of
// a warp's 8 query rows over kK keys (csrc/flash_fwd_simt.cu: a is p at
// its pitch kAP).
template <int kD, int kK, int kAP = kPS>
__device__ __forceinline__ void keys_sum(float (&acc)[8][kD / 32],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         int lane) {
  constexpr int kP = kD + 4;
  constexpr int kHi = kD == 256 ? 4 : 2;  // the lane's columns past 128
#pragma unroll 2
  for (int q = 0; q < kK; q += 4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * kAP + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = b + (q + e) * kP;
      const float4 y0 = *reinterpret_cast<const float4*>(row + 4 * lane);
      float y1[4];
      if constexpr (kHi == 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + 128 + 4 * lane);
        y1[0] = v.x, y1[1] = v.y, y1[2] = v.z, y1[3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(row + 128 + 2 * lane);
        y1[0] = v.x, y1[1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x_e = e == 0 ? x[i].x : e == 1 ? x[i].y
                        : e == 2 ? x[i].z : x[i].w;
        acc[i][0] = fmaf(x_e, y0.x, acc[i][0]);
        acc[i][1] = fmaf(x_e, y0.y, acc[i][1]);
        acc[i][2] = fmaf(x_e, y0.z, acc[i][2]);
        acc[i][3] = fmaf(x_e, y0.w, acc[i][3]);
#pragma unroll
        for (int c = 0; c < kHi; ++c)
          acc[i][4 + c] = fmaf(x_e, y1[c], acc[i][4 + c]);
      }
    }
  }
}

// s[i][j] += sum_{d < kKC} a[i kAP + d] b[32 j kBP + d] (i < 8, j < NJ):
// one head-dim piece's part of a score tile of a warp's 8 whole rows (a,
// broadcast) and the lane's keys (b, its first row), both read as float4:
// the wide blocked K4's s (csrc/flash_fwd_simt.cu) and K6's s and dp.
template <int kKC, int kAP, int kBP, int NJ, int kNJ>
__device__ __forceinline__ void wide_scores(float (&s)[8][kNJ],
                                            const float* __restrict__ a,
                                            const float* __restrict__ b) {
#pragma unroll
  for (int d = 0; d < kKC; d += 4) {
    float4 y[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 32 * j * kBP + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(a + i * kAP + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
      }
    }
  }
}

// wide_scores for the nj (1 to kNJ) 32-key groups that hold real keys:
// the last key tile scores no group past S.
template <int kKC, int kAP, int kBP, int kNJ, int NJ = kNJ>
__device__ __forceinline__ void wide_scores_n(int nj, float (&s)[8][kNJ],
                                              const float* __restrict__ a,
                                              const float* __restrict__ b) {
  if constexpr (NJ > 1) {
    if (nj < NJ) {
      wide_scores_n<kKC, kAP, kBP, kNJ, NJ - 1>(nj, s, a, b);
      return;
    }
  }
  wide_scores<kKC, kAP, kBP, NJ>(s, a, b);
}

// n (<= 4) values of an output row (K4's o, K6's dq) from column c: one
// 16-byte store where `vec`, n = 4 and every column lies below D, else one
// store each below D.
__device__ __forceinline__ void store_o(float* __restrict__ row, int c,
                                        const float* x, int n, int D,
                                        bool vec) {
  if (vec && n == 4 && c + 4 <= D) {
    *reinterpret_cast<float4*>(row + c) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
  for (int e = 0; e < n; ++e)
    if (c + e < D) row[c + e] = x[e];
}

}  // namespace
