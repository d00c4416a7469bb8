// Softmax attention forward over a fused (B, S, 3*H*D) qkv buffer on the
// CUDA cores, for Hopper: fp32 at every head dim, and bf16 and fp16 at head
// dims over the tensor-core tiles' 256.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_fwd_stats_kernel (K1), and _hp_fwd_kernel (K9: the same launch
// with the stats pointer null). Same function, per (b, h):
//   q^ = rnd(q * rnd(scale)); s = q^ k^T in fp32 (columns >= S do not exist);
//   m = rowmax(s); p = exp(s - m); rinv = 1 / sum(p);
//   o = (rnd(p) v, accumulated in fp32) * rinv, stored rnd() at (B, S, H*D);
//   optionally st = (B, H, S, 2) fp32 holding [m, rinv] per query row.
// rnd() rounds to the element type (csrc/elem.cuh); in fp32 every rnd() is
// the identity. q, k and v are read by stride straight from the projection
// output: q at column h*D, k at H*D + h*D, v at 2*H*D + h*D. The TPU
// kernel's 128-lane head-pair packing is a TPU layout rule and is not
// carried over.
//
// What bounds it on an H100: the products. At B = 128, S = 197, 12 heads of
// 64, s and p v are 4 B H S^2 D = 15.3 GFLOP: 0.228 ms at the 67 TFLOP/s
// fp32 peak of the CUDA cores, against 312 MB of fp32 qkv, o and stats
// (0.093 ms at 3.35 TB/s). fp32 has no tensor-core product that keeps the
// cast order (TF32 rounds the inputs), so the CUDA cores run it, and what
// limits them is instruction issue and shared-memory bandwidth per FMA.
//
// Design, fp32 at D <= 128 (attn_fwd_simt_kernel<kD>, kD = 32, 64 or 128 at
// compile time; a smaller even head dim takes the next with its columns
// zero-filled): one block of 256 threads per (b, h, 64-row query tile), on
// a one-dimensional grid over (b h, tile), so B and H are bounded only by
// 2^31 / ceil(S / 64) (not by the 65535 of the grid's y and z).
//   * q^ of the tile is staged once, row-major with pitch kD + 4; K and V
//     stream through two shared-memory tiles of 64 keys, row-major with
//     pitch kD + 4: the next tile lands by cp.async while the block works
//     on the current one, one barrier a tile.
//   * Register tiles: the 8 warps are 4 (query rows) x 2 (keys, or o's
//     columns), a warp's lanes 4 x 8. A thread owns 4 query rows (16 wr +
//     ly + 4 i), and 4 keys (32 wk + lx + 8 j) of s or 4 contiguous
//     columns of o (8 at D = 128). Both products read both operands as
//     float4 along their sum: at a step the warp reads 4 rows of q^ (or p)
//     and 8 of K (or 8 float4 of V), each one shared-memory wavefront, so
//     8 loads and 8 wavefronts feed 64 FMAs.
//   * The row max comes from the whole row before any p is formed (the TPU
//     kernel's order; no online rescaling). Pass 1 puts s of every key tile
//     into a score block [64 rows][S rounded up to 16, + 8] in shared
//     memory, each thread keeping its rows' running max; the two key
//     halves of a row meet by shuffles and one exchange through shared
//     memory. Each thread then turns its own scores into p = exp(s - m) and
//     sums them. The last key tile computes only the 8-key groups that
//     hold real keys, and a warp whose keys all lie past S skips it.
//   * Pass 2: o = p v over each tile's real keys rounded up to 8, then o =
//     (p v) rinv, stored as float4 rows.
//   * The score block fits the 227 KB of a block up to S = 784 (D 32), 688
//     (D 64) or 496 (D 128): 54 KB at S = 197, 106 KB a block in all, so
//     two blocks share an SM at D <= 64. Past that (to S = 1024) pass 1
//     keeps only the row max and pass 2 recomputes s, one 64-key tile of p
//     at a time into a 64 x 72 block, before its p v. Right, and 1.5x the
//     products.
//   * Warps whose 16 query rows all lie past S (the ragged last query
//     tile) copy tiles and wait at the barriers but compute nothing.
// The sums run in a fixed order (no atomics): two calls are bitwise equal.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 0.754 ms of device
// time a call at B = 128 (30% of the bound; the first design 1.38-1.43,
// SDPA's fp32 forward 0.805). Without p v it takes 0.54, without q^ k^T
// 0.49: a 4 x 4 tile moves 2 bytes of shared memory per FMA, so the
// products run near half the FMA rate.
//
// Other element types and fp32 past D = 128 (attn_fwd_kernel<T, 0>): the
// first design, with the head dim a run-time value. One block per (b, h,
// 64-row query tile); K and V of the head staged in shared memory (rows
// padded to an odd number of 32-bit words), or read from L2 when they do
// not fit (long S with a wide D); each warp owns one query row at a time:
// lanes split the keys for q^ k^T, warp shuffles give the row max and sum,
// lanes split the head dim for p v. bf16 and fp16 keep the cast order
// through csrc/elem.cuh (q^ and p rounded to the element type, o stored in
// it); they reach it only past the tensor-core tiles (csrc/attn_fwd_tc.cu
// takes D <= 256).
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function takes the element type's
// code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cfloat>
#include <climits>

#include <cuda_runtime.h>

#include "cc_tiles.cuh"
#include "elem.cuh"

namespace {

constexpr int kWarps = 8;          // query rows in flight per block
constexpr int kRowsPerBlock = 64;  // query tile of one block
constexpr int kMaxHeadDim = 1024;  // the port's MAX_CUDA_CORE_HEAD_DIM
constexpr int kMaxTiledHeadDim = 128;  // attn_fwd_simt_kernel's, fp32
constexpr int kMaxSeq = 1024;
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have
constexpr size_t kSmemMax = 232448;         // a block's 227 KB

// ---- fp32 at D <= 128: attn_fwd_simt_kernel<kD>

// Widths of the fp32 kernel at compile-time head dim kD.
template <int kD>
struct Simt {
  static constexpr int kP = kD + 4;  // pitch of q^ and of a K or V tile
  static constexpr int kNC = kD < 64 ? 1 : kD / 64;  // 64-column groups of o
};

// The thread's place in a block: warp (wr, wk) of 4 x 2, lane (ly, lx) of
// 4 x 8. Its query rows are 16 wr + ly + 4 i (i < 4): the four rows a warp
// reads at one step are consecutive, so 4 float4 of q^ (or p) hit
// different banks; its keys of a 64-key tile are 32 wk + lx + 8 j (j < 4),
// and its head-dim columns of o 64 n + 32 wk + 4 lx + e (e < 4): 8
// distinct float4 of K (or V) a step, one wavefront.
struct Place {
  int wr, wk, ly, lx;
  __device__ __forceinline__ Place()
      : wr(threadIdx.x >> 6), wk((threadIdx.x >> 5) & 1),
        ly((threadIdx.x >> 3) & 3), lx(threadIdx.x & 7) {}
  __device__ __forceinline__ int row(int i) const {
    return 16 * wr + ly + 4 * i;
  }
  __device__ __forceinline__ int key(int j) const {
    return 32 * wk + lx + 8 * j;
  }
};

// The pitch of the fp32 kernel's score block (`store`: every key's score,
// to S rounded up to 16, else one 64-key tile of p); 8 mod 16, so that the
// 4 x 8 scores a warp stores at once, and the 4 rows it reads, hit
// different banks.
__host__ __device__ constexpr int simt_pitch(int S, bool store) {
  return (store ? (S + 15) / 16 * 16 : kTile) + 8;
}

// The fp32 kernel's shared memory in bytes: q^, two K or V tiles, the
// score block, the row exchange.
template <int kD>
constexpr size_t simt_smem(int S, bool store) {
  typedef Simt<kD> Dm;
  return ((size_t)kTile * (3 * Dm::kP + simt_pitch(S, store)) +
          2 * kTile) * sizeof(float);
}

// Stage rows [r0, r0 + kTile) by W columns of one head (rows `sr` floats
// apart), times `mul`, row-major at dst[r * pitch + c], as pairs: rows >= S
// and columns >= D read as 0. Every load is issued before the stores.
template <int W>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int pitch,
                                           const float* __restrict__ src,
                                           long long sr, int r0, int S, int D,
                                           float mul) {
  float2 x[W / 8];
#pragma unroll
  for (int u = 0; u < W / 8; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / (W / 2), c = 2 * (i % (W / 2));
    x[u] = (r0 + r < S && c < D)
               ? *reinterpret_cast<const float2*>(src + (r0 + r) * sr + c)
               : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < W / 8; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / (W / 2), c = 2 * (i % (W / 2));
    *reinterpret_cast<float2*>(dst + r * pitch + c) =
        make_float2(x[u].x * mul, x[u].y * mul);
  }
}

// The same rows copied by cp.async, as pairs, row-major at dst[r * pitch +
// c]; rows >= S and columns >= D are zero-filled.
template <int W>
__device__ __forceinline__ void copy_rows(float* __restrict__ dst, int pitch,
                                          const float* __restrict__ src,
                                          long long sr, int r0, int S,
                                          int D) {
#pragma unroll
  for (int u = 0; u < W / 8; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / (W / 2), c = 2 * (i % (W / 2));
    const bool ok = r0 + r < S && c < D;
    cp_async<8>(dst + r * pitch + c, ok ? src + (r0 + r) * sr + c : src, ok);
  }
}

// What a key tile's scores are for.
enum ScoreUse {
  kKeep,     // into the score block, raw, and the row max
  kMaxOnly,  // the row max alone (the first pass when s is recomputed)
  kProb,     // p = exp(s - m) into the tile's block, and the row sums
};

// The scores of this thread's 4 rows and its keys j < NJ of the key tile at
// k0: s = q^ k^T over the head dim, both operands read as float4. `sc` is
// the score block's column of key k0 (kKeep) or the tile's p block (kProb),
// pitch P.
template <int kD, int NJ, ScoreUse kUse>
__device__ __forceinline__ void scores(const float* __restrict__ qs,
                                       const float* __restrict__ ks,
                                       float* __restrict__ sc, int P, int k0,
                                       int S, const Place& at,
                                       float (&m)[4], float (&sum)[4]) {
  typedef Simt<kD> Dm;
  float s[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(ks + at.key(j) * Dm::kP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(qs + at.row(i) * Dm::kP + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const bool ok = k0 + at.key(j) < S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dst = sc + at.row(i) * P + at.key(j);
      if constexpr (kUse == kProb) {
        const float p = ok ? expf(s[i][j] - m[i]) : 0.f;
        sum[i] += p;
        *dst = p;
      } else {
        if constexpr (kUse == kKeep) *dst = s[i][j];
        if (ok) m[i] = fmaxf(m[i], s[i][j]);
      }
    }
  }
}

// scores<kD, NJ, kUse> for the warp's key groups of the tile at k0 (the
// keys 32 wk + 8 j < S - k0): none, or 1 to 4.
template <int kD, ScoreUse kUse>
__device__ __forceinline__ void tile_scores(const float* __restrict__ qs,
                                            const float* __restrict__ ks,
                                            float* __restrict__ sc, int P,
                                            int k0, int S, const Place& at,
                                            float (&m)[4], float (&sum)[4]) {
  switch (min(4, (S - k0 - 32 * at.wk + 7) >> 3)) {
    case 1: scores<kD, 1, kUse>(qs, ks, sc, P, k0, S, at, m, sum); break;
    case 2: scores<kD, 2, kUse>(qs, ks, sc, P, k0, S, at, m, sum); break;
    case 3: scores<kD, 3, kUse>(qs, ks, sc, P, k0, S, at, m, sum); break;
    case 4: scores<kD, 4, kUse>(qs, ks, sc, P, k0, S, at, m, sum); break;
    default: break;  // the warp's keys all lie past S
  }
}

// acc[i][4 n + e] += sum_{k < depth} p[row(i) * P + k] * v[k * kP + 64 n
// + 32 wk + 4 lx + e]: p v over `depth` keys (a multiple of 4), both
// operands read as float4.
template <int kD>
__device__ __forceinline__ void pv(float (&acc)[4][4 * Simt<kD>::kNC],
                                   const float* __restrict__ p, int P,
                                   const float* __restrict__ v, int depth,
                                   const Place& at) {
  typedef Simt<kD> Dm;
  const int c0 = 32 * at.wk + 4 * at.lx;
#pragma unroll 2
  for (int k = 0; k < depth; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(p + at.row(i) * P + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 b[Dm::kNC];
#pragma unroll
      for (int n = 0; n < Dm::kNC; ++n)
        b[n] = *reinterpret_cast<const float4*>(v + (k + e) * Dm::kP +
                                                64 * n + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = e == 0 ? a[i].x : e == 1 ? a[i].y
                      : e == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int n = 0; n < Dm::kNC; ++n) {
          acc[i][4 * n + 0] = fmaf(x, b[n].x, acc[i][4 * n + 0]);
          acc[i][4 * n + 1] = fmaf(x, b[n].y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(x, b[n].z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(x, b[n].w, acc[i][4 * n + 3]);
        }
      }
    }
  }
}

// Combine the two key halves' (wk's) values of each row: over the warp's
// 8 lx lanes by shuffles, then through `red` ([2][64]) with the other
// warp of the row; max or sum. Every thread of the block calls it.
template <bool kMax>
__device__ __forceinline__ void combine_rows(float (&x)[4], float* red,
                                             const Place& at) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[i], off);
      x[i] = kMax ? fmaxf(x[i], y) : x[i] + y;
    }
    if (at.lx == 0) red[at.wk * kTile + at.row(i)] = x[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = red[at.row(i)], b = red[kTile + at.row(i)];
    x[i] = kMax ? fmaxf(a, b) : a + b;  // the same order in every thread
  }
  __syncthreads();  // red is read: it may be written again
}

// grid (B * H * n_kt), n_kt = ceil(S / 64): block x is query tile x % n_kt
// of (b, h) = x / n_kt. Shared memory: q^ [64][kP], two K or V tiles
// [64][kP] (the next one lands by cp.async while the block works on the
// current one), the score block [64][P], the row exchange [2][64]. The
// block streams tiles: with `store`, K_0 .. K_{n-1} (scores kept) and V_0
// .. V_{n-1}; without, K_0 .. K_{n-1} (row max only), then K_0, V_0, K_1,
// V_1, ... (p of the tile, p v).
template <int kD>
__global__ void __launch_bounds__(kThreads, kD > 64 ? 1 : 2)
attn_fwd_simt_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                     float* __restrict__ st, int S, int H, int D,
                     float scale, int store) {
  typedef Simt<kD> Dm;
  extern __shared__ __align__(16) float smem[];
  const int n_kt = (S + kTile - 1) / kTile;
  const int P = simt_pitch(S, store);
  float* qs = smem;
  float* kvs = qs + kTile * Dm::kP;
  float* sc = kvs + 2 * kTile * Dm::kP;
  float* red = sc + kTile * P;
  const int bh = blockIdx.x / n_kt, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % n_kt) * kTile;
  const Place at;
  // the warp's 16 rows hold a real one; its columns of o hold a real one
  const bool live = q0 + 16 * at.wr < S;
  const bool cols = 32 * at.wk < kD;
  const long long C = 3LL * H * D, HD = (long long)H * D;
  const float* qg = qkv + (long long)b * S * C + (long long)h * D;
  const float* kg = qg + HD;
  const float* vg = qg + 2 * HD;
  const int n_steps = (store ? 2 : 3) * n_kt;
  // step t of the stream: a V tile or not, and which
  auto step = [&](int t, bool& is_v) {
    if (t < n_kt) {
      is_v = false;
      return t;
    }
    t -= n_kt;
    if (store) {
      is_v = true;
      return t;
    }
    is_v = t & 1;
    return t >> 1;
  };
  // wait for step t's tile, start step t + 1's copy, return t's tile; every
  // thread is past step t - 1, so its buffer and a tile's p block are free
  auto tile_of = [&](int t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_steps) {
      bool v;
      const int nt = step(t + 1, v);
      copy_rows<kD>(kvs + ((t + 1) & 1) * kTile * Dm::kP, Dm::kP,
                    v ? vg : kg, C, nt * kTile, S, D);
      cp_async_commit();
    }
    return static_cast<const float*>(kvs + (t & 1) * kTile * Dm::kP);
  };

  stage_rows<kD>(qs, Dm::kP, qg, C, q0, S, D, scale);
  copy_rows<kD>(kvs, Dm::kP, kg, C, 0, S, D);
  cp_async_commit();

  // pass 1: every key tile's scores (kept, or only their row max)
  float m[4], sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    sum[i] = 0.f;
  }
  int t = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const float* ks = tile_of(t++);
    if (!live) continue;
    if (store)
      tile_scores<kD, kKeep>(qs, ks, sc + kt * kTile, P, kt * kTile, S, at,
                             m, sum);
    else
      tile_scores<kD, kMaxOnly>(qs, ks, sc, P, kt * kTile, S, at, m, sum);
  }
  combine_rows<true>(m, red, at);
  if (store && live) {
    // p = exp(s - m) of this thread's own scores, and their sums
    for (int kt = 0; kt < n_kt; ++kt) {
      const int nk = S - kt * kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = at.key(j);
        if (32 * at.wk + 8 * j >= nk) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* x = sc + at.row(i) * P + kt * kTile + key;
          const float p = key < nk ? expf(*x - m[i]) : 0.f;
          sum[i] += p;
          *x = p;
        }
      }
    }
  }

  // pass 2: o = p v (p of each tile formed first, when s was not kept)
  float acc[4][4 * Dm::kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * Dm::kNC; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    if (!store) {
      const float* ks = tile_of(t++);
      if (live) tile_scores<kD, kProb>(qs, ks, sc, P, k0, S, at, m, sum);
    }
    const float* vs = tile_of(t++);
    // over the tile's real keys, rounded up to 8 (p and V are 0 past S)
    if (live && cols)
      pv<kD>(acc, store ? sc + k0 : sc, P, vs, min(kTile, (S - k0 + 7) & ~7),
             at);
  }
  combine_rows<false>(sum, red, at);

  if (!live || !cols) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + at.row(i);
    if (r >= S) continue;
    const float rinv = 1.f / sum[i];
    float* orow = out + ((long long)b * S + r) * HD + (long long)h * D;
#pragma unroll
    for (int n = 0; n < Dm::kNC; ++n) {
      const int col = 64 * n + 32 * at.wk + 4 * at.lx;
      const float4 o = make_float4(acc[i][4 * n] * rinv,
                                   acc[i][4 * n + 1] * rinv,
                                   acc[i][4 * n + 2] * rinv,
                                   acc[i][4 * n + 3] * rinv);
      if ((D & 3) == 0) {  // 16-byte rows: o is the wrapper's own tensor
        if (col < D) *reinterpret_cast<float4*>(orow + col) = o;
      } else {
        const float x[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) orow[col + e] = x[e];
      }
    }
    if (st != nullptr && at.wk == 0 && at.lx == 0) {
      float* sp = st + ((long long)bh * S + r) * 2;
      sp[0] = m[i];
      sp[1] = rinv;
    }
  }
}

template <int kD>
int launch_simt(const void* qkv, void* out, void* st, int B, int S, int H,
                int D, float scale, cudaStream_t stream) {
  const int n_kt = (S + kTile - 1) / kTile;
  const long long blocks = (long long)n_kt * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int store = simt_smem<kD>(S, true) <= kSmemMax ? 1 : 0;
  const size_t smem = simt_smem<kD>(S, store);
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_simt_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_fwd_simt_kernel<kD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out),
      static_cast<float*>(st), S, H, D, scale, store);
  return (int)cudaGetLastError();
}

// ---- any element type at a run-time head dim: attn_fwd_kernel<T, 0>

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Floats of one warp's scratch: q^ (D) then scores (S), padded to 16 bytes.
__host__ __device__ inline int warp_floats(int D, int S) {
  return (D + S + 3) & ~3;
}

// Shared memory: per warp [q^: D][scores: S] (16-byte aligned), then
// [K: S x kv_words][V: S x kv_words] (pairs) when kv_in_smem. kD is 0: the
// head dim is d_rt.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                float* __restrict__ st, int S, int H, int d_rt, float scale,
                int kv_in_smem, int kv_words) {
  static_assert(kD == 0, "the run-time head-dim loops");
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = d_rt;
  const int n_tiles = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (blockIdx.x % n_tiles) * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D2 = D >> 1;        // pairs in a head row
  const int C = 3 * H * D;      // elements in a qkv row
  const int C2 = C >> 1;        // pairs in a qkv row

  const T* base = qkv + (long long)b * S * C;
  const T* qg = base + h * D;
  const Pair* kg = reinterpret_cast<const Pair*>(base + H * D + h * D);
  const Pair* vg = reinterpret_cast<const Pair*>(base + 2 * H * D + h * D);

  const int wf = warp_floats(D, S);
  float* qs = smem + warp * wf;
  float* sc = qs + D;
  const Pair* kp;
  const Pair* vp;
  int kv_stride;  // in pairs
  if (kv_in_smem) {
    Pair* ks = reinterpret_cast<Pair*>(smem + kWarps * wf);
    Pair* vs = ks + S * kv_words;
    for (int i = threadIdx.x; i < S * D2; i += blockDim.x) {
      const int r = i / D2, c = i - r * D2;
      ks[r * kv_words + c] = kg[r * C2 + c];
      vs[r * kv_words + c] = vg[r * C2 + c];
    }
    kp = ks;
    vp = vs;
    kv_stride = kv_words;
  } else {
    kp = kg;
    vp = vg;
    kv_stride = C2;
  }
  __syncthreads();

  const int row_end = min(row0 + kRowsPerBlock, S);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const T* qrow = qg + r * C;
    for (int d = lane; d < D; d += 32)
      qs[d] = E::round(E::load(qrow[d]) * scale);
    __syncwarp();

    // s = q^ k^T: lane j takes keys j, j + 32, ...
    float mx = -FLT_MAX;
    for (int j = lane; j < S; j += 32) {
      const Pair* kr = kp + j * kv_stride;
      float acc = 0.f;
      for (int c = 0; c < D2; ++c) {
        const float2 kf = E::load2(kr[c]);
        acc = fmaf(qs[2 * c], kf.x, acc);
        acc = fmaf(qs[2 * c + 1], kf.y, acc);
      }
      sc[j] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);

    // p = exp(s - m); the sum is over fp32 p, the p v product takes bf16(p)
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = expf(sc[j] - mx);
      sum += p;
      sc[j] = E::round(p);
    }
    sum = warp_sum(sum);
    const float rinv = 1.f / sum;
    __syncwarp();

    // o = (bf16(p) v) * rinv: lane c takes head-dim pairs c, c + 32
    Pair* orow =
        reinterpret_cast<Pair*>(out + ((long long)b * S + r) * H * D + h * D);
    for (int c = lane; c < D2; c += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float2 vf = E::load2(vp[j * kv_stride + c]);
        ax = fmaf(sc[j], vf.x, ax);
        ay = fmaf(sc[j], vf.y, ay);
      }
      orow[c] = E::store2(ax * rinv, ay * rinv);
    }
    if (st != nullptr && lane == 0) {
      float* sp = st + (((long long)b * H + h) * S + r) * 2;
      sp[0] = mx;
      sp[1] = rinv;
    }
    __syncwarp();  // qs and sc are rewritten by the warp's next row
  }
}

template <typename T>
int launch(const void* qkv, void* out, void* st, int B, int S, int H, int D,
           float scale, cudaStream_t stream) {
  // pad K/V rows to an odd number of pairs (of 32-bit words for the 16-bit
  // types): conflict-free row reads
  const int d2 = D / 2;
  const int kv_words = (d2 % 2 == 0) ? d2 + 1 : d2;
  const size_t warp_bytes = (size_t)kWarps * warp_floats(D, S) * sizeof(float);
  const size_t kv_bytes =
      2 * (size_t)S * kv_words * sizeof(typename Elem<T>::Pair);
  const int kv_in_smem = (kv_bytes + warp_bytes <= kSmemBudget) ? 1 : 0;
  const size_t smem = warp_bytes + (kv_in_smem ? kv_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<T, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks =
      (long long)((S + kRowsPerBlock - 1) / kRowsPerBlock) * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  attn_fwd_kernel<T, 0><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(st), S, H, D, scale, kv_in_smem, kv_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, S, 3HD) and out (B, S, HD) of the element type `dtype` (fp32 at D
// <= 128 on attn_fwd_simt_kernel, past it on the run-time loops; bf16 and
// fp16 on the run-time ones); st (B, H, S, 2) fp32 or null. D even and <=
// 1024. Returns a cudaError_t as int: 0 on a launch that was accepted.
int vtx_attn_fwd(const void* qkv, void* out, void* st, int B, int S, int H,
                 int D, float scale, int dtype, void* stream) {
  // offsets inside one image are 32-bit: S * 3 * H * D must fit
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 ||
      D < 2 || (D & 1) || D > kMaxHeadDim ||
      (long long)S * 3 * H * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (D <= 32)
        return launch_simt<32>(qkv, out, st, B, S, H, D, scale, s);
      if (D <= 64)
        return launch_simt<64>(qkv, out, st, B, S, H, D, scale, s);
      if (D <= kMaxTiledHeadDim)
        return launch_simt<128>(qkv, out, st, B, S, H, D, scale, s);
      return launch<float>(qkv, out, st, B, S, H, D, scale, s);
    case kBf16:  // q^ = T(q * T(scale)), as JAX scales in T
      return launch<__nv_bfloat16>(qkv, out, st, B, S, H, D,
                                   rounded_scale<__nv_bfloat16>(scale), s);
    case kF16:
      return launch<__half>(qkv, out, st, B, S, H, D,
                            rounded_scale<__half>(scale), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
