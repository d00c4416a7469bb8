// The blocked attention backward in fp32 at head dims up to 128, on the
// CUDA cores of Hopper: flash_bwd_dkdv_simt_kernel<kD> (K5) and
// flash_bwd_dq_simt_kernel<kD> (K6), kD 64 or 128 at compile time (a
// smaller head dim takes the next with its columns zero-filled). Linked
// into csrc/flash_blocked.cu's library, whose dkdv() and dq() launch them
// for float at D <= 128 (fp16, and every dtype past 128, stay there).
//
// Replaces the TPU kernels of vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py in fp32 (the JAX kernels round nothing there):
//   K5 <- _bwd_dkdv_kernel (:109, call :208): per key row, over the query
//      tiles, p = exp((q k^T) scale - lse), keys or queries >= S giving 0;
//      dv += p^T dO; ds = p (dO v^T - delta); dk += ds^T q; dk *= scale.
//   K6 <- _bwd_dq_kernel (:157, call :231): per query row, over the key
//      tiles, the same p and ds; dq += ds k; dq *= scale.
// lse and delta are (B, H, S) fp32 from the caller (ops/flash_blocked.py::
// flash_delta). q, k, v, dO and the gradients are (B, H, S, D) of any
// element strides with a contiguous head dim, so they are read straight
// from a fused (B, S, 3 H D) projection and written into views of one
// dqkv buffer.
//
// What bounds them on an H100: the products. At (B, S, H, D) = (32, 1370,
// 12, 64) K5 does 4 products of B H S^2 D FMAs (369 GFLOP) and K6 3 (277
// GFLOP): 5.51 and 4.13 ms at the 67 TFLOP/s fp32 peak of the CUDA cores,
// against 0.2 GB of operands (0.06 ms at 3.35 TB/s). The tensor cores have
// no fp32 product that keeps the inputs (TF32 rounds them). On the CUDA
// cores an SM does 128 FMAs and moves 128 bytes from shared memory into
// registers a clock, so a product nears the FMA rate only if each thread
// reads about one byte of shared memory an FMA: register tiles of 8 x 8
// (or 2 x 8 x 4), every operand read as float4.
//
// Design. A block per (b, h, kRows-row tile) on a one-dimensional grid (B
// H bounded only by 2^31 / ceil(S / kRows)): at D <= 64 kRows = 128 and 8
// warps (kD = 64), at D <= 128 kRows = 64 and 8 warps (kD = 128).
//   * Staging. The block's own rows (K5: K and V of its keys; K6: q and dO
//     of its queries) are staged once; the other side's 64-row tiles stream
//     through cp.async buffers, two at kD = 64 (the next tile lands while
//     the block works on this one; one barrier a tile in K6, two in K5),
//     one at kD = 128 (two would take 235 KB). All of them lie row-major at
//     pitch kD + 4: 16-byte copies with the columns past D zero-filled when
//     every row is 16-byte aligned (the model's qkv views: 9,216-byte rows,
//     256-byte head offsets), else one 4-byte copy an element (any fp32
//     view with a contiguous head dim: nothing is copied in Python).
//   * Scores. A warp's lanes are 4 x 8 (ly, lx). Each scoring warp (32
//     rows of the block by 32 columns of the tile) computes s = q k^T and
//     dp = dO v^T together, a thread 8 rows by 4 columns of each, every
//     operand read as float4 along the head dim (24 loads feed 256 FMAs),
//     then forms p = exp(s scale - lse) (ex2.approx) and ds = p (dp -
//     delta) in its own registers. K5 stores p and ds [key][query], K6 ds
//     [query][key], at pitch 72 (free of bank conflicts).
//   * Sums. K5's warps sum dv += p^T dO or dk += ds^T q over the tile's 64
//     queries, each for 32 keys in 8 x 8 accumulators (p or ds read as
//     float4 along the sum, dO or q as two float4 of the thread's columns
//     c0 + e, c0 + 32 + e: 16 loads feed 256 FMAs). Their p and ds come
//     from the row group's two scoring warps, which meet at a named
//     barrier of 64 threads. K6's warps sum dq += ds k over the 32 keys
//     they scored: no barrier at all; the two key halves of dq are added
//     once at the end, in a fixed order.
//   * Why: the first design (64 rows, two blocks an SM, one buffer, warps
//     split into s and dp roles with 8 x 8 tiles and two block barriers a
//     tile for p and ds) took 12.49 and 9.90 ms: the exponentials of one
//     role held the other at the barrier (1.9 and 1.7 ms) and the
//     unbuffered stream waited for L2 (1.7 and 1.1). PERF.md §6 has the
//     variants (tools/time_fp32_bwd_variants.py).
//   * Deterministic: every sum runs in a fixed order, no float atomics;
//     K5 and K6 stay two launches (dq is summed in its own block).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6), device ms of one
// call at the 518-px model's shape: K5 9.46-9.53 (58% of its bound), K6
// 7.73-7.77 (53%); with delta (0.28) the pair is 1.24x SDPA's whole fp32
// backward (14.06-14.18). The kD = 128 instantiations spill 48-56 bytes.
//
// Plain C++ interface (namespace flash_bwd_simt), called by
// csrc/flash_blocked.cu's host functions on the caller's stream; each
// returns cudaGetLastError(). The kernels allocate nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

#include "cp_async.cuh"

namespace {

constexpr int kTile = 64;        // rows of a streamed tile
constexpr int kPS = kTile + 8;   // pitch of p and ds [kRows][72]

// The widths of the kernels at compile-time head dim kD, with kRows rows of
// the block's own side (64 or 128) and kBufs buffers (1 or 2) of the
// streamed side. Warps: 2 kRows / 32 take the score products (32 rows and
// 32 columns of the tile each), and all of them the summed ones (kD / 64
// column halves).
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

// K5. grid (B * H * n_tiles) over kRows-key tiles. Shared memory: K, V of
// the block's keys [kRows][kP]; kBufs buffers of a query tile's q, dO
// [64][kP]; p, ds [key][query] [kRows][72]; lse, delta of each buffered
// query tile [64].
template <int kD, int kRows, int kBufs>
__global__ void __launch_bounds__(Bwd<kD, kRows, kBufs>::kThr,
                                  Bwd<kD, kRows, kBufs>::kThr == 128 ? 2 : 1)
flash_bwd_dkdv_simt_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int S, int D, int n_tiles, float scale,
                           Strides in, Strides og, Strides gr, int vec) {
  typedef Bwd<kD, kRows, kBufs> G;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kRows * G::kP;
  float* qs = vs + kRows * G::kP;         // buffer u: qs + 2 u kTile kP
  float* ps = qs + 2 * kBufs * kTile * G::kP;
  float* dss = ps + kRows * kPS;
  float* lse_s = dss + kRows * kPS;       // buffer u: lse_s + 2 u kTile
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  const Place<G::kGroups> at;
  const bool scorer = at.w < 2 * G::kGroups;
  const long long in_off = b * in.sb + h * in.sh;
  const float* qg = q + in_off;
  const float* dog = dout + b * og.sb + h * og.sh;
  const float* lse_g = lse + (long long)bh * S;
  const float* dl_g = delta + (long long)bh * S;
  // the query tile at q0 into buffer u: q, dO, lse and delta, by cp.async
  auto stream = [&](int u, int q0) {
    float* bq = qs + 2 * u * kTile * G::kP;
    copy_tile<kD, kTile, G::kThr>(bq, qg, in.sr, q0, S, D, vec);
    copy_tile<kD, kTile, G::kThr>(bq + kTile * G::kP, dog, og.sr, q0, S, D,
                                  vec);
    if (threadIdx.x < 2 * kTile) {
      const int t = threadIdx.x % kTile;
      const bool ok = q0 + t < S;
      const float* g = threadIdx.x < kTile ? lse_g : dl_g;
      cp_async<4>(lse_s + 2 * u * kTile + threadIdx.x, ok ? g + q0 + t : g,
                  ok);
    }
    cp_async_commit();
  };

  copy_tile<kD, kRows, G::kThr>(ks, k + in_off, in.sr, k0, S, D, vec);
  copy_tile<kD, kRows, G::kThr>(vs, v + in_off, in.sr, k0, S, D, vec);
  stream(0, 0);
  float acc[8][8];  // dv (half 0) or dk (half 1) of the block's keys
  zero(acc);

  for (int t = 0, q0 = 0; q0 < S; ++t, q0 += kTile) {
    const int u = kBufs == 2 ? t & 1 : 0;
    const float* bq = qs + 2 * u * kTile * G::kP;  // q, then dO
    const float* bdo = bq + kTile * G::kP;
    const float* ls_s = lse_s + 2 * u * kTile;     // lse, then delta
    cp_async_wait<0>();
    __syncthreads();  // the query tile (and K, V with the first) landed
    // two buffers: the next tile lands in the one every warp has read
    if (kBufs == 2 && q0 + kTile < S) stream(u ^ 1, q0 + kTile);
    if (scorer) {
      // s^T and dp^T of the warp's 32 keys and 32 queries; then p = exp(s
      // scale - lse) (0 for keys or queries >= S) and ds = p (dp - delta)
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      score_tiles<kD>(s, dp, ks, bq, vs, bdo, at.r0, at.c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = at.c + 8 * j;
        const bool q_ok = q0 + qi < S;
        const float ls = ls_s[qi], dl = ls_s[kTile + qi];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = q_ok && k0 + at.r0 + 4 * i < S;
          const float p = ok ? exp_p(s[i][j] * scale - ls) : 0.f;
          const int x = (at.r0 + 4 * i) * kPS + qi;
          ps[x] = p;
          dss[x] = p * (dp[i][j] - dl);
        }
      }
    }
    // p and ds of the row group's keys are stored, by its two scoring warps
    if (G::kOwn)
      pair_sync(at.g);
    else
      __syncthreads();
    // dv += p^T dO (half 0), dk += ds^T q (half 1) over the tile's queries
    sum_tile<kD, kTile>(acc, at.half ? dss : ps, at.half ? bq : bdo, at.r0,
                        at.c0);
    if (kBufs == 1) {
      __syncthreads();  // the tile is read: its buffer takes the next one
      if (q0 + kTile < S) stream(0, q0 + kTile);
    }
  }

  const long long g_off = b * gr.sb + h * gr.sh;
  store_tile(at.half ? dk + g_off : dv + g_off, gr.sr, acc, k0, at, S, D,
             at.half ? scale : 1.f);
}

// K6. grid (B * H * n_tiles) over kRows-query tiles. Shared memory: q, dO of
// the block's queries [kRows][kP]; kBufs buffers of a key tile's K, V
// [64][kP]; ds [query][key] [kRows][72] (then the second key half's dq,
// [kRows][kP], over it and the unused p buffer).
template <int kD, int kRows, int kBufs>
__global__ void __launch_bounds__(Bwd<kD, kRows, kBufs>::kThr,
                                  Bwd<kD, kRows, kBufs>::kThr == 128 ? 2 : 1)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int S, int D,
                         int n_tiles, float scale, Strides in, Strides og,
                         Strides gr, int vec) {
  typedef Bwd<kD, kRows, kBufs> G;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * G::kP;
  float* ks = dos + kRows * G::kP;        // buffer u: ks + 2 u kTile kP
  float* dss = ks + 2 * kBufs * kTile * G::kP;
  const int bh = blockIdx.x / n_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const Place<G::kGroups> at;
  const bool scorer = at.w < 2 * G::kGroups;
  const long long in_off = b * in.sb + h * in.sh;
  const float* kg = k + in_off;
  const float* vg = v + in_off;
  // K and V of the key tile at k0 into buffer u
  auto stream = [&](int u, int k0) {
    float* bk = ks + 2 * u * kTile * G::kP;
    copy_tile<kD, kTile, G::kThr>(bk, kg, in.sr, k0, S, D, vec);
    copy_tile<kD, kTile, G::kThr>(bk + kTile * G::kP, vg, in.sr, k0, S, D,
                                  vec);
    cp_async_commit();
  };

  copy_tile<kD, kRows, G::kThr>(qs, q + in_off, in.sr, q0, S, D, vec);
  copy_tile<kD, kRows, G::kThr>(dos, dout + b * og.sb + h * og.sh, og.sr, q0,
                                S, D, vec);
  stream(0, 0);
  // lse and delta of the thread's rows
  float ls[8], dl[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + at.r0 + 4 * i;
    ls[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    dl[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
  }
  float acc[8][8];  // dq over the tile's keys 32 half .. 32 half + 31
  zero(acc);

  for (int t = 0, k0 = 0; k0 < S; ++t, k0 += kTile) {
    const int u = kBufs == 2 ? t & 1 : 0;
    const float* bk = ks + 2 * u * kTile * G::kP;  // K, then V
    const float* bv = bk + kTile * G::kP;
    cp_async_wait<0>();
    __syncthreads();  // the key tile landed
    // two buffers: the next tile lands in the one every warp has read
    if (kBufs == 2 && k0 + kTile < S) stream(u ^ 1, k0 + kTile);
    if (scorer) {
      // s and dp of the warp's 32 queries and 32 keys; then ds = p (dp -
      // delta), p = exp(s scale - lse) (0 for keys >= S)
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      score_tiles<kD>(s, dp, qs, bk, dos, bv, at.r0, at.c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = at.c + 8 * j;
        const bool ok = k0 + kj < S;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = ok ? exp_p(s[i][j] * scale - ls[i]) : 0.f;
          dss[(at.r0 + 4 * i) * kPS + kj] = p * (dp[i][j] - dl[i]);
        }
      }
    }
    // ds is stored: by this warp when every warp scores (it sums the keys
    // it scored), else by the block's scoring warps
    if (G::kOwn)
      __syncwarp();
    else
      __syncthreads();
    // dq += ds k over the keys 32 half .. 32 half + 31 of the tile
    sum_tile<kD, kTile / 2>(acc, dss + 32 * at.half,
                            bk + 32 * at.half * G::kP, at.r0, at.c0);
    if (kBufs == 1) {
      __syncthreads();  // the tile is read: its buffer takes the next one
      if (k0 + kTile < S) stream(0, k0 + kTile);
    }
  }

  // dq = (first half + second half) scale: the second half's through the
  // ds buffer, once every warp is past its last sum
  float* red = dss;
  if (kBufs == 2) __syncthreads();
  if (at.half) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(red + (at.r0 + 4 * i) * G::kP + at.c0 +
                                   32 * g) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
  }
  __syncthreads();
  if (at.half) return;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 y = *reinterpret_cast<const float4*>(
          red + (at.r0 + 4 * i) * G::kP + at.c0 + 32 * g);
      acc[i][4 * g] += y.x;
      acc[i][4 * g + 1] += y.y;
      acc[i][4 * g + 2] += y.z;
      acc[i][4 * g + 3] += y.w;
    }
  store_tile(dq + b * gr.sb + h * gr.sh, gr.sr, acc, q0, at, S, D, scale);
}

// Whether every row of the tensors at `ptrs`, with strides `a` and `b`,
// starts 16 bytes aligned.
bool rows16(std::initializer_list<const void*> ptrs, const Strides& a,
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

template <int kD, int kRows, int kBufs>
int launch_dkdv(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* delta,
                float* dk, float* dv, int B, int H, int S, int D, float scale,
                Strides in, Strides og, Strides gr, cudaStream_t stream) {
  typedef Bwd<kD, kRows, kBufs> G;
  int n_tiles;
  unsigned blocks;
  const int rc =
      prepare(flash_bwd_dkdv_simt_kernel<kD, kRows, kBufs>, G::kSmem, kRows,
              B, H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v, dout}, in, og) ? 1 : 0;
  flash_bwd_dkdv_simt_kernel<kD, kRows, kBufs>
      <<<blocks, G::kThr, G::kSmem, stream>>>(q, k, v, dout, lse, delta, dk,
                                              dv, H, S, D, n_tiles, scale,
                                              in, og, gr, vec);
  return (int)cudaGetLastError();
}

template <int kD, int kRows, int kBufs>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int S, int D, float scale, Strides in,
              Strides og, Strides gr, cudaStream_t stream) {
  typedef Bwd<kD, kRows, kBufs> G;
  int n_tiles;
  unsigned blocks;
  const int rc =
      prepare(flash_bwd_dq_simt_kernel<kD, kRows, kBufs>, G::kSmem, kRows, B,
              H, S, &n_tiles, &blocks);
  if (rc) return rc;
  const int vec = rows16({q, k, v, dout}, in, og) ? 1 : 0;
  flash_bwd_dq_simt_kernel<kD, kRows, kBufs>
      <<<blocks, G::kThr, G::kSmem, stream>>>(q, k, v, dout, lse, delta, dq,
                                              H, S, D, n_tiles, scale, in, og,
                                              gr, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The instantiations: at D <= 64 128 rows a block with both streamed
// buffers (one block an SM); at D <= 128 64 rows with one (two buffers
// would take 235 KB).
#define VTX_BWD_SIMT_64 64, 128, 2
#define VTX_BWD_SIMT_128 128, 64, 1

namespace flash_bwd_simt {

// dk, dv (strides gr) from q, k, v (strides in), dout (og), lse and delta
// (B, H, S) fp32; 1 <= D <= 128.
int dkdv(const float* q, const float* k, const float* v, const float* dout,
         const float* lse, const float* delta, float* dk, float* dv, int B,
         int H, int S, int D, float scale, const long long* in,
         const long long* og, const long long* gr, cudaStream_t stream) {
  const Strides i{in[0], in[1], in[2]}, o{og[0], og[1], og[2]},
      g{gr[0], gr[1], gr[2]};
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  return D <= 64
             ? launch_dkdv<VTX_BWD_SIMT_64>(q, k, v, dout, lse, delta, dk, dv,
                                            B, H, S, D, scale, i, o, g, stream)
             : launch_dkdv<VTX_BWD_SIMT_128>(q, k, v, dout, lse, delta, dk,
                                             dv, B, H, S, D, scale, i, o, g,
                                             stream);
}

// dq (strides gr) from the same inputs.
int dq(const float* q, const float* k, const float* v, const float* dout,
       const float* lse, const float* delta, float* dq, int B, int H, int S,
       int D, float scale, const long long* in, const long long* og,
       const long long* gr, cudaStream_t stream) {
  const Strides i{in[0], in[1], in[2]}, o{og[0], og[1], og[2]},
      g{gr[0], gr[1], gr[2]};
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  return D <= 64
             ? launch_dq<VTX_BWD_SIMT_64>(q, k, v, dout, lse, delta, dq, B, H,
                                          S, D, scale, i, o, g, stream)
             : launch_dq<VTX_BWD_SIMT_128>(q, k, v, dout, lse, delta, dq, B,
                                           H, S, D, scale, i, o, g, stream);
}

}  // namespace flash_bwd_simt
