// fp32 register tiles on the CUDA cores of Hopper, shared by the fp32
// attention kernels at head dims up to 128 that stage whole rows:
// csrc/flash_bwd_simt.cu (the blocked K5, K6), csrc/flash_fwd_simt.cu (the
// blocked K4) and csrc/hp_bwd_simt.cu (K8, K10, K12); the wide tiles past
// 128 (csrc/simt_wide.cuh: K8, K10, K12 and K2) stage their rows and
// stream their tiles with its copy_tile and pitches too.
//
// Rows are staged row-major in shared memory at pitch kD + 4 (kD the
// compile-time head dim, 64 or 128) and read as float4 along the head dim;
// the streamed operand comes in 64-row tiles. On the CUDA cores an SM does
// 128 FMAs and moves 128 bytes from shared memory into registers a clock,
// so a product nears the FMA rate only if each thread reads about one byte
// of shared memory an FMA: register tiles of 8 x 8 (or 2 x 8 x 4), every
// operand read as float4.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

#include "cp_async.cuh"

namespace {

constexpr int kTile = 64;        // rows of a streamed tile
constexpr int kPS = kTile + 8;   // pitch of p and ds [kRows][72]

// The widths of the backward kernels at compile-time head dim kD, with
// kRows rows of the block's own side (64 or 128) and kBufs buffers (1 or 2)
// of the streamed side. Warps: 2 kRows / 32 take the score products (32
// rows and 32 columns of the tile each), and all of them the summed ones
// (kD / 64 column halves).
template <int kD, int kRows, int kBufs>
struct Bwd {
  static constexpr int kGroups = kRows / 32;  // 32-row groups
  static constexpr int kWarps = 2 * kGroups * (kD / 64);
  static constexpr int kThr = 32 * kWarps;
  static constexpr int kP = kD + 4;           // pitch of a staged row tile
  // every warp scores, and then sums what its row group scored
  static constexpr bool kOwn = 2 * kGroups == kWarps;
  // the block's rows (2 tiles), the streamed tiles (2 a buffer), p and ds,
  // and K5's lse and delta of each streamed query tile
  static constexpr size_t kSmem =
      (size_t)(2 * kRows * kP + 2 * kBufs * kTile * kP + 2 * kRows * kPS +
               2 * kBufs * kTile) * sizeof(float);
};

struct Strides {
  long long sb, sh, sr;  // element strides of batch, head and row
};

// A thread's place: warp w, lane (ly, lx) of 4 x 8. Its rows of the block's
// kRows are r0 + 4 i (i < 8), r0 = 32 g + ly with g = w % kGroups, its row
// group. In the score products its columns of the 64-row tile are c + 8 j
// (j < 4), c = 32 half + lx; in the summed ones c0 + e and c0 + 32 + e (e <
// 4), c0 = 64 (w / (2 kGroups)) + 4 lx, and `half` picks what it sums (K5:
// dv or dk; K6: the tile's keys 0-31 or 32-63).
template <int kGroups>
struct Place {
  int w, g, r0, c, c0, half;
  __device__ __forceinline__ Place()
      : w(threadIdx.x >> 5),
        g((threadIdx.x >> 5) % kGroups),
        r0(32 * ((threadIdx.x >> 5) % kGroups) + ((threadIdx.x >> 3) & 3)),
        c(32 * (((threadIdx.x >> 5) / kGroups) & 1) + (threadIdx.x & 7)),
        c0(64 * ((threadIdx.x >> 5) / (2 * kGroups)) + 4 * (threadIdx.x & 7)),
        half(((threadIdx.x >> 5) / kGroups) & 1) {}
};

// Named barrier 1 + g over the 64 threads of row group g's two scoring
// warps (barrier 0 is __syncthreads').
__device__ __forceinline__ void pair_sync(int g) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + g) : "memory");
}

template <int NJ>
__device__ __forceinline__ void zero(float (&x)[8][NJ]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[i][j] = 0.f;
}

// cp.async of rows [r0, r0 + kN) by kD columns of one head (rows `sr`
// floats apart) to dst[r * (kD + 4) + c] by kThr threads; rows >= S and
// columns >= D are zero-filled. vec: 16-byte copies (every row 16-byte
// aligned), else one 4-byte copy an element.
template <int kD, int kN, int kThr>
__device__ __forceinline__ void copy_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          long long sr, int r0, int S, int D,
                                          bool vec) {
  constexpr int kQ = kD / 4, kP = kD + 4;  // 16-byte pieces of a row
#pragma unroll
  for (int u = 0; u < kN * kQ / kThr; ++u) {
    const int i = threadIdx.x + u * kThr;
    const int r = i / kQ, c = 4 * (i % kQ);
    const int n = r0 + r < S ? min(4, max(0, D - c)) : 0;  // real floats
    float* d = dst + r * kP + c;
    const float* s = n ? src + (long long)(r0 + r) * sr + c : src;
    if (vec) {
      cp_async_zfill(d, s, 4 * n);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async<4>(d + e, e < n ? s + e : src, e < n);
    }
  }
}

// p = exp(x) on the special-function unit (ex2.approx of x log2 e: within
// 2 + 1.2 |x| ulps, and x <= 0 here, where p is 1 or smaller)
__device__ __forceinline__ float exp_p(float x) { return __expf(x); }

// s[i][j] += sum_{d < kD} a[(r0 + 4 i) kP + d] b[(c + 8 j) kP + d] and t
// the same of a2, b2 (i < 8, j < 4): s = q k^T and dp = dO v^T of the
// thread's 8 rows and 4 columns, every operand read as float4 along the
// head dim (8 rows of b and b2 a step: one wavefront a load).
template <int kD>
__device__ __forceinline__ void score_tiles(float (&s)[8][4],
                                            float (&t)[8][4],
                                            const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            const float* __restrict__ a2,
                                            const float* __restrict__ b2,
                                            int r0, int c) {
  constexpr int kP = kD + 4;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 y[4], y2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = *reinterpret_cast<const float4*>(b + (c + 8 * j) * kP + d);
      y2[j] = *reinterpret_cast<const float4*>(b2 + (c + 8 * j) * kP + d);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(a + (r0 + 4 * i) * kP + d);
      const float4 x2 =
          *reinterpret_cast<const float4*>(a2 + (r0 + 4 * i) * kP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
        t[i][j] = fmaf(x2.x, y2[j].x, t[i][j]);
        t[i][j] = fmaf(x2.y, y2[j].y, t[i][j]);
        t[i][j] = fmaf(x2.z, y2[j].z, t[i][j]);
        t[i][j] = fmaf(x2.w, y2[j].w, t[i][j]);
      }
    }
  }
}

// acc[i][4 g + e] += sum_{t < kK} a[(r0 + 4 i) * kPS + t] b[t * kP + c0 +
// 32 g + e] (g < 2, e < 4): dv += p^T dO, dk += ds^T q or dq += ds k over
// kK rows, a (p or ds) read as float4 along the sum, b as float4 along its
// columns.
template <int kD, int kK>
__device__ __forceinline__ void sum_tile(float (&acc)[8][8],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int r0,
                                         int c0) {
  constexpr int kP = kD + 4;
#pragma unroll 2
  for (int t = 0; t < kK; t += 4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (r0 + 4 * i) * kPS + t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 y0 =
          *reinterpret_cast<const float4*>(b + (t + e) * kP + c0);
      const float4 y1 =
          *reinterpret_cast<const float4*>(b + (t + e) * kP + c0 + 32);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x_e = e == 0 ? x[i].x : e == 1 ? x[i].y
                        : e == 2 ? x[i].z : x[i].w;
        acc[i][0] = fmaf(x_e, y0.x, acc[i][0]);
        acc[i][1] = fmaf(x_e, y0.y, acc[i][1]);
        acc[i][2] = fmaf(x_e, y0.z, acc[i][2]);
        acc[i][3] = fmaf(x_e, y0.w, acc[i][3]);
        acc[i][4] = fmaf(x_e, y1.x, acc[i][4]);
        acc[i][5] = fmaf(x_e, y1.y, acc[i][5]);
        acc[i][6] = fmaf(x_e, y1.z, acc[i][6]);
        acc[i][7] = fmaf(x_e, y1.w, acc[i][7]);
      }
    }
  }
}


// acc * mul to rows row0 + r0 + 4 i (< S) and columns c0 + 32 g + e (< D)
// of one head (rows `sr` floats apart).
template <typename At>
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           long long sr,
                                           const float (&acc)[8][8],
                                           int row0, const At& at, int S,
                                           int D, float mul) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + at.r0 + 4 * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = at.c0 + 32 * (c / 4) + c % 4;
      if (col < D) dst[(long long)r * sr + col] = acc[i][c] * mul;
    }
  }
}

// Whether every row of the tensors at `ptrs`, with strides `a` and `b`,
// starts 16 bytes aligned.
inline bool rows16(std::initializer_list<const void*> ptrs, const Strides& a,
            const Strides& b) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  const long long s = a.sb | a.sh | a.sr | b.sb | b.sh | b.sr;
  return (bits & 15) == 0 && (s & 3) == 0;
}

// The grid over (b h, kRows-row tile), and the kernel's shared memory.
template <typename Kernel>
int prepare(Kernel kernel, size_t bytes, int rows, int B, int H, int S,
            int* n_tiles, unsigned* blocks) {
  *n_tiles = (S + rows - 1) / rows;
  const long long n = (long long)*n_tiles * B * H;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
