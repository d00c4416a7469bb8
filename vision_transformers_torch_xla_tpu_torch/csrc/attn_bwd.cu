// Softmax attention backward over a fused (B, S, 3*H*D) qkv buffer on the
// CUDA cores, for Hopper: fp32 at every head dim, and bf16 and fp16 at head
// dims over 256. fp32 at head dims 129-256 is csrc/attn_bwd_simt.cu's
// (register tiles, linked into this library); this file's kernels take the
// rest.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_bwd_pi_kernel (K2) where it runs in fp32, or at a head dim over 256;
// bf16 and fp16 at D <= 256 run on the tensor cores (csrc/attn_bwd_tc.cu,
// its wide tiles past 128).
// Same function, per (b, h), from the forward's (B, H, S, 2) row stats
// [m, rinv] (K1 with stats), T the element type, rnd() its rounding:
//   q^ = rnd(q * rnd(scale)) (JAX multiplies in T); s = q^ k^T over the S
//   real keys; pu = exp(s - m),
//   left unnormalized; do_n = rnd(dO * rinv); dv = rnd(pu)^T do_n;
//   delta = rowsum(dO * O); dp = dO v^T; t = rnd((dp - delta) * pu);
//   dq = (t k) * (rinv * scale); qn = rnd(q^ * rinv); dk = t^T qn.
// That is the TPU kernel's cast order; in fp32 every rnd() is the identity.
// Every product accumulates in fp32. dq, dk and dv are stored, rounded to
// T, into one (B, S, 3*H*D) dqkv buffer at the standard columns h*D, H*D +
// h*D and 2*H*D + h*D, and their fp32 values, before that rounding, summed
// over the sequence go to the (B, 3*H*D) fp32 qkv-bias partials (one row
// per image) in the same column order.
//
// What bounds it on an H100: the products. At B = 128, S = 197, 12 heads of
// 64 the function needs s, dp, dv, dk and dq, 10 B H S^2 D = 38.2 GFLOP:
// 0.57 ms at the 67 TFLOP/s fp32 peak of the CUDA cores, against 313 MB of
// operands and results (0.09 ms at 3.35 TB/s). fp32 has no tensor-core
// product that keeps the cast order (TF32 rounds the inputs; a 3xTF32 split
// is not tried here), so the CUDA cores run it. The 64-row tiles pad S = 197
// to 256; the products that sum over a tile's rows stop at its real rows
// (rounded up to 8), the ones that sum over the head dim cannot.
//
// Design, fp32 at D <= 128 (attn_bwd_kernel): csrc/flash_blocked.cu's
// register tiling of the fp32 K5 and K6, which beat SDPA's fp32 backward, in
// one launch that runs each product once. One block of 256 threads per
// (b, h) walks the 64-row key tiles and, for each, the 64-row query tiles:
//   * s^T = K q^T and dp^T = V dO^T as register tiles: 256 threads as
//     16 x 16, a thread owns 4 contiguous rows (ty * 4 + i) and the columns
//     tx + 16 j, so A operands are read as float4 (broadcast in a
//     half-warp) and B operands as scalars on 16 consecutive banks;
//   * pu = exp(s - m) and t = (dp - delta) pu through shared memory into
//     dv += pu^T do_n and dk += t^T qn, which accumulate over the query
//     tiles in registers; q^ and dO are scaled in place by their rows' rinv
//     for these two (qn, do_n: the JAX order);
//   * t k, summed over the key tiles in key-tile order in an fp32 (B, H, S,
//     D) scratch that the block alone touches, and at the last key tile
//     scaled by rinv scale into dq.
// Operands are staged in shared memory as fp32 (csrc/cc_tiles.cuh's tiles,
// shared with csrc/flash_blocked.cu), the current tiles only (at
// D = 128 172 KB a block, whatever S): an A operand transposed with pitch 68
// (16-byte rows), a B operand transposed with pitch 65 (odd: row and column
// reads both free of bank conflicts). delta = rowsum(dO O) of every query
// is computed once, at the start. The block writes its (b, h)'s columns of
// the qkv-bias gradient itself: its threads' column sums over the head's
// rows, then the 16 row groups' in a fixed order. No float atomics: the
// result is deterministic. The grid is one-dimensional over (b, h), so B
// and H are bounded only by B H < 2^31. The head dim is 32, 64 or 128 at
// compile time; a smaller one takes the next with its columns zero-filled.
//
// Design, every dtype at D > 256 (attn_bwd_wide_kernel<T>): the same
// walk and register tiles, with the head dim a run-time value up to 1024
// in 64-column chunks. A block owns one chunk of one (b, h) (a grid of
// B H ceil(D / 64) blocks) and writes dq, dk, dv and the bias partials of
// its chunk's columns alone. For each (key tile, query tile) it sums s^T
// and dp^T over the whole head dim, staging K, V, q^ and dO 64 columns at a
// time (every block of a (b, h) sums them in the same order, so pu and t
// are bitwise the same in each), then stages its chunk's K, qn and do_n for
// the three products that write columns. Shared memory is the D = 64
// kernel's, 105 KB, so two blocks share an SM; s and dp are computed once
// per chunk (ceil(D / 64) times per (b, h)): right, and recorded as slow
// (PERF.md §6), not fast. In fp32 at (32, 197, 12, 256) it took 10.30-10.35
// ms of device time where csrc/attn_bwd_simt.cu takes 2.045 (H100 80GB HBM3
// at 700 W, PERF.md §6).
//
// Plain C interface, loaded with ctypes. The kernel allocates nothing and
// launches on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>

#include "cc_tiles.cuh"
#include "elem.cuh"

// csrc/attn_bwd_simt.cu, linked into this library: fp32 at 128 < D <= 256.
namespace attn_bwd_simt {
long long scratch_floats(int B, int H, int S, int D);
int run(const float* qkv, const float* dout, const float* out,
        const float* st, float* dqkv, float* dbias, float* scratch, int B,
        int S, int H, int D, float scale, cudaStream_t stream);
}  // namespace attn_bwd_simt

namespace {

constexpr int kMaxSeq = 1024;
constexpr int kMaxHeadDim = 128;        // attn_bwd_kernel's, fp32
constexpr int kMaxSimtHeadDim = 256;    // csrc/attn_bwd_simt.cu's, fp32
constexpr int kMaxWideHeadDim = 1024;   // attn_bwd_wide_kernel's

// The tensors of one call. qkv and dqkv are (B, S, C) with C = 3 H D; dO
// and O (B, S, H D); st (B, H, S, 2) [m, rinv]; dbias (B, C); dq_sum
// (B, H, S, D) is scratch.
struct Args {
  const float *qkv, *dout, *out, *st;
  float *dqkv, *dbias, *dq_sum;
  int H, S, D, n_t;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Write rows r0 + row0 + i (< S) and columns col0 + 16 j (< D) of acc[i][j]
// to one head of a tensor with row stride sr, and add the values of the
// real rows to this thread's column sums.
template <int NJ>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           long long sr,
                                           const float (&acc)[4][NJ], int r0,
                                           int row0, int col0, int S, int D,
                                           float (&csum)[NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + 16 * j;
      const float x = acc[i][j];
      if (c < D) dst[(long long)r * sr + c] = x;
      csum[j] += x;
    }
  }
}

// Sum the 16 row groups' column sums in a fixed order and write the D sums
// to dst. red holds 16 x kD floats; the caller has synchronised
// the block since red's last use.
template <int NJ>
__device__ __forceinline__ void write_sums(float* __restrict__ red,
                                               const float (&csum)[NJ],
                                               float* __restrict__ dst, int D) {
  constexpr int kD = NJ * 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) red[ty * kD + tx + 16 * j] = csum[j];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < 16; ++g) sum += red[g * kD + c];
    dst[c] = sum;
  }
}

// acc[i][j] += sum_{k < K} a[k * kPA + row0 + i] * b[k * BK + (col0 + 16 j) * BC]
// as tile_product, over a run-time depth K <= kTile (a multiple of 8): the
// ragged last tile's real rows, its zero rows past them skipped.
template <int NJ, int BK, int BC>
__device__ __forceinline__ void tile_product_n(float (&acc)[4][NJ],
                                               const float* __restrict__ a,
                                               const float* __restrict__ b,
                                               int row0, int col0, int K) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * kPA + row0);
    float y[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = b[k * BK + (col0 + 16 * j) * BC];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(x.x, y[j], acc[0][j]);
      acc[1][j] = fmaf(x.y, y[j], acc[1][j]);
      acc[2][j] = fmaf(x.z, y[j], acc[2][j]);
      acc[3][j] = fmaf(x.w, y[j], acc[3][j]);
    }
  }
}

// The real rows of the tile at r0, rounded up to 8.
__device__ __forceinline__ int depth(int r0, int S) {
  return min(kTile, (S - r0 + 7) & ~7);
}

// grid (B * H): one block per (b, h) walks the key tiles, and for each the
// query tiles, so every product runs once. Shared memory: kT, vT [kD x kPA]
// (A operands, the key tile), qT, doT [kD x kPB] (the query tile: q^ and
// dO, then qn and do_n), pq, tq [kTile x kPA] (pu and t as [query][key];
// then t as [key][query] in pq for t k), the query tile's m and rinv
// [kTile] each, and delta of every query [kMaxSeq].
template <int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;
  float* vT = kT + kD * kPA;
  float* qT = vT + kD * kPA;
  float* doT = qT + kD * kPB;
  float* pq = doT + kD * kPB;
  float* tq = pq + kTile * kPA;
  float* m_s = tq + kTile * kPA;
  float* ri_s = m_s + kTile;
  float* dl_s = ri_s + kTile;
  constexpr int NO = kD / 16;
  const int H = a.H, S = a.S, D = a.D, n_t = a.n_t;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long C = 3LL * H * D, HD = (long long)H * D;
  const float* base = a.qkv + (long long)b * S * C + (long long)h * D;
  const long long o_off = (long long)b * S * HD + (long long)h * D;
  const float* st = a.st + (long long)bh * S * 2;
  float* drow = a.dqkv + (long long)b * S * C + (long long)h * D;
  float* dq_sum = a.dq_sum + (long long)bh * S * D;

  // delta = rowsum(dO O) of every query: a warp per row, lanes split the
  // head dim
  for (int r = warp; r < S; r += kThreads / 32) {
    const float* g = a.dout + o_off + (long long)r * HD;
    const float* o = a.out + o_off + (long long)r * HD;
    float dl = 0.f;
    for (int d = lane; d < D; d += 32) dl = fmaf(g[d], o[d], dl);
    dl = warp_sum(dl);
    if (lane == 0) dl_s[r] = dl;
  }
  // this thread's column sums of dq, dk and dv over the head's rows
  float cq[NO], ck[NO], cv[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) cq[j] = ck[j] = cv[j] = 0.f;

  for (int kt = 0; kt < n_t; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last key tile's kT and vT are read
    stage_t<float, kD>(kT, kPA, base + HD, C, k0, S, D, 1.f);
    stage_t<float, kD>(vT, kPA, base + 2 * HD, C, k0, S, D, 1.f);
    float dk_acc[4][NO], dv_acc[4][NO];
    zero(dk_acc);
    zero(dv_acc);
    bool key_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) key_ok[i] = k0 + row0 + i < S;

    for (int q0 = 0; q0 < S; q0 += kTile) {
      __syncthreads();  // the last pair's qT, doT, pq, tq are read
      stage_t<float, kD>(qT, kPB, base, C, q0, S, D, a.scale);
      stage_t<float, kD>(doT, kPB, a.dout + o_off, HD, q0, S, D, 1.f);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool ok = q0 + i < S;
        m_s[i] = ok ? st[(q0 + i) * 2] : 0.f;
        ri_s[i] = ok ? st[(q0 + i) * 2 + 1] : 0.f;
      }
      __syncthreads();
      // s^T [key][query] = K q^T, dp^T = V dO^T
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      tile_product<4, kD, kPB, 1>(s, kT, qT, row0, tx);
      tile_product<4, kD, kPB, 1>(dp, vT, doT, row0, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const bool q_ok = q0 + qi < S;
        const float m = m_s[qi], dl = q_ok ? dl_s[q0 + qi] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = (q_ok && key_ok[i]) ? expf(s[i][j] - m) : 0.f;
          s[i][j] = pu;
          dp[i][j] = (dp[i][j] - dl) * pu;  // t
        }
      }
      store_t(pq, s, row0, tx);
      store_t(tq, dp, row0, tx);
      __syncthreads();
      // qn = q^ rinv and do_n = dO rinv, in place: [d][query] times rinv
      for (int i = threadIdx.x; i < kD * kTile; i += kThreads) {
        const int d = i / kTile, qi = i % kTile;
        const float r = ri_s[qi];
        qT[d * kPB + qi] *= r;
        doT[d * kPB + qi] *= r;
      }
      __syncthreads();
      // dv += pu^T do_n, dk += t^T qn over the tile's real queries: read
      // from doT, qT [d][query] along the query
      const int nq = depth(q0, S);
      tile_product_n<NO, 1, kPB>(dv_acc, pq, doT, row0, tx, nq);
      tile_product_n<NO, 1, kPB>(dk_acc, tq, qT, row0, tx, nq);
      __syncthreads();  // pq is read
      // t as [key][query] into pq: this thread's own values, from tq
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(tq + (tx + 16 * j) * kPA + row0);
        pq[(row0 + 0) * kPA + tx + 16 * j] = t4.x;
        pq[(row0 + 1) * kPA + tx + 16 * j] = t4.y;
        pq[(row0 + 2) * kPA + tx + 16 * j] = t4.z;
        pq[(row0 + 3) * kPA + tx + 16 * j] = t4.w;
      }
      __syncthreads();
      // t k over the tile's real keys: k read from kT [d][key] along the
      // key; summed over the key tiles in order in dq_sum, and at the last
      // one dq = (t k) (rinv scale)
      float dq[4][NO];
      zero(dq);
      tile_product_n<NO, 1, kPA>(dq, pq, kT, row0, tx, depth(k0, S));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + row0 + i;
        if (r >= S) continue;
        const float f = ri_s[row0 + i] * a.scale;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int c = tx + 16 * j;
          if (c >= D) continue;
          float* sum = dq_sum + (long long)r * D + c;
          const float x = kt > 0 ? *sum + dq[i][j] : dq[i][j];
          if (kt + 1 < n_t) {
            *sum = x;
          } else {
            drow[(long long)r * C + c] = x * f;
            cq[j] += x * f;
          }
        }
      }
    }
    store_rows(drow + HD, C, dk_acc, k0, row0, tx, S, D, ck);
    store_rows(drow + 2 * HD, C, dv_acc, k0, row0, tx, S, D, cv);
  }

  // the bias gradient of (b, h): the column sums of dq, dk and dv over the
  // head's rows, the 16 row groups' in a fixed order
  __syncthreads();  // pq, tq and qT are read
  float* db = a.dbias + (long long)b * C + (long long)h * D;
  write_sums(pq, cq, db, D);
  write_sums(tq, ck, db + HD, D);
  write_sums(qT, cv, db + 2 * HD, D);
}

// The kernel's dynamic shared memory.
template <int kD>
constexpr size_t smem_bytes() {
  return (2 * kD * kPA + 2 * kD * kPB + 2 * kTile * kPA + 2 * kTile +
          kMaxSeq) * sizeof(float);
}

// ---- head dims over 128: attn_bwd_wide_kernel<T> (the wrappers send it
// fp32 past 128, bf16 and fp16 past 256)

// The tensors of one wide call, as Args, of element type T.
template <typename T>
struct WideArgs {
  const T *qkv, *dout, *out;
  const float* st;
  T* dqkv;
  float *dbias, *dq_sum;
  int H, S, D, n_t, n_c;
  float scale, q_scale;  // q_scale: rnd(scale), q^'s
};

// Stage columns [c0, c0 + kTile) of rows [r0, r0 + kTile) of one head (rows
// `sr` elements apart) into shared memory as fp32, transposed: dst[d * pitch
// + r] = f(value, r). Rows >= S and columns >= D read as 0.
template <typename T, typename F>
__device__ __forceinline__ void stage_cols(float* __restrict__ dst, int pitch,
                                           const T* __restrict__ src,
                                           long long sr, int r0, int c0,
                                           int S, int D, F f) {
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, d = i % kTile;
    float x = 0.f;
    if (r0 + r < S && c0 + d < D)
      x = f(Elem<T>::load(src[(long long)(r0 + r) * sr + c0 + d]), r);
    dst[d * pitch + r] = x;
  }
}

// Write rows r0 + row0 + i (< S) and columns col0 + 16 j (< D) of acc * mul,
// rounded to T, to one head of a tensor with row stride sr, and add the
// fp32 values of the real rows to this thread's column sums.
template <typename T>
__device__ __forceinline__ void store_rows_t(T* __restrict__ dst, long long sr,
                                             const float (&acc)[4][4], int r0,
                                             int row0, int col0, int S, int D,
                                             float (&csum)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + 16 * j;
      const float x = acc[i][j];
      if (c < D) dst[(long long)r * sr + c] = Elem<T>::store(x);
      csum[j] += x;
    }
  }
}

// grid (B * H * n_c): block x is the 64-column chunk x % n_c of (b, h) =
// x / n_c. Shared memory as attn_bwd_kernel<64>: kT, vT [kTile x kPA], qT,
// doT [kTile x kPB] (a 64-column panel of K, V, q^, dO for s and dp; then
// the chunk's K, qn, do_n), pq, tq [kTile x kPA] (rnd(pu) and t as
// [query][key]; then t as [key][query] in pq for t k), the query tile's m
// and rinv [kTile] each, and delta of every query [kMaxSeq].
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_wide_kernel(WideArgs<T> a) {
  typedef Elem<T> E;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;
  float* vT = kT + kTile * kPA;
  float* qT = vT + kTile * kPA;
  float* doT = qT + kTile * kPB;
  float* pq = doT + kTile * kPB;
  float* tq = pq + kTile * kPA;
  float* m_s = tq + kTile * kPA;
  float* ri_s = m_s + kTile;
  float* dl_s = ri_s + kTile;
  const int H = a.H, S = a.S, D = a.D, n_t = a.n_t;
  const int bh = blockIdx.x / a.n_c, b = bh / H, h = bh % H;
  const int c0 = (blockIdx.x % a.n_c) * kTile;  // the chunk's first column
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long C = 3LL * H * D, HD = (long long)H * D;
  const T* base = a.qkv + (long long)b * S * C + (long long)h * D;
  const long long o_off = (long long)b * S * HD + (long long)h * D;
  const T* gb = a.dout + o_off;
  const float* st = a.st + (long long)bh * S * 2;
  T* drow = a.dqkv + (long long)b * S * C + (long long)h * D + c0;
  float* dq_sum = a.dq_sum + (long long)bh * S * D + c0;
  const int dc = min(kTile, D - c0);  // the chunk's real columns
  const float scale = a.scale, q_scale = a.q_scale;
  const auto ident = [](float x, int) { return x; };
  const auto q_hat = [q_scale](float x, int) {
    return E::round(x * q_scale);
  };

  // delta = rowsum(dO O) of every query: a warp per row, lanes split the
  // head dim
  for (int r = warp; r < S; r += kThreads / 32) {
    const T* g = gb + (long long)r * HD;
    const T* o = a.out + o_off + (long long)r * HD;
    float dl = 0.f;
    for (int d = lane; d < D; d += 32)
      dl = fmaf(E::load(g[d]), E::load(o[d]), dl);
    dl = warp_sum(dl);
    if (lane == 0) dl_s[r] = dl;
  }
  // this thread's column sums of dq, dk and dv over the head's rows
  float cq[4] = {0.f, 0.f, 0.f, 0.f}, ck[4] = {0.f, 0.f, 0.f, 0.f},
        cv[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kt = 0; kt < n_t; ++kt) {
    const int k0 = kt * kTile;
    float dk_acc[4][4], dv_acc[4][4];
    zero(dk_acc);
    zero(dv_acc);
    bool key_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) key_ok[i] = k0 + row0 + i < S;

    for (int q0 = 0; q0 < S; q0 += kTile) {
      // s^T [key][query] = K q^T, dp^T = V dO^T over the head dim, 64
      // columns at a time
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      for (int p0 = 0; p0 < D; p0 += kTile) {
        __syncthreads();  // the last panel (or chunk) is read
        stage_cols(kT, kPA, base + HD, C, k0, p0, S, D, ident);
        stage_cols(vT, kPA, base + 2 * HD, C, k0, p0, S, D, ident);
        stage_cols(qT, kPB, base, C, q0, p0, S, D, q_hat);
        stage_cols(doT, kPB, gb, HD, q0, p0, S, D, ident);
        if (p0 == 0)
          for (int i = threadIdx.x; i < kTile; i += kThreads) {
            const bool ok = q0 + i < S;
            m_s[i] = ok ? st[(q0 + i) * 2] : 0.f;
            ri_s[i] = ok ? st[(q0 + i) * 2 + 1] : 0.f;
          }
        __syncthreads();
        tile_product<4, kTile, kPB, 1>(s, kT, qT, row0, tx);
        tile_product<4, kTile, kPB, 1>(dp, vT, doT, row0, tx);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const bool q_ok = q0 + qi < S;
        const float m = m_s[qi], dl = q_ok ? dl_s[q0 + qi] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = (q_ok && key_ok[i]) ? expf(s[i][j] - m) : 0.f;
          s[i][j] = E::round(pu);
          dp[i][j] = E::round((dp[i][j] - dl) * pu);  // t
        }
      }
      __syncthreads();  // the last panel is read
      store_t(pq, s, row0, tx);
      store_t(tq, dp, row0, tx);
      // the chunk's K, qn = rnd(q^ rinv) and do_n = rnd(dO rinv), [d][row]
      stage_cols(kT, kPA, base + HD, C, k0, c0, S, D, ident);
      stage_cols(qT, kPB, base, C, q0, c0, S, D,
                 [q_scale, ri_s](float x, int r) {
                   return E::round(E::round(x * q_scale) * ri_s[r]);
                 });
      stage_cols(doT, kPB, gb, HD, q0, c0, S, D, [ri_s](float x, int r) {
        return E::round(x * ri_s[r]);
      });
      __syncthreads();
      // dv += rnd(pu)^T do_n, dk += t^T qn over the tile's real queries
      const int nq = depth(q0, S);
      tile_product_n<4, 1, kPB>(dv_acc, pq, doT, row0, tx, nq);
      tile_product_n<4, 1, kPB>(dk_acc, tq, qT, row0, tx, nq);
      __syncthreads();  // pq is read
      // t as [key][query] into pq: this thread's own values, from tq
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(tq + (tx + 16 * j) * kPA + row0);
        pq[(row0 + 0) * kPA + tx + 16 * j] = t4.x;
        pq[(row0 + 1) * kPA + tx + 16 * j] = t4.y;
        pq[(row0 + 2) * kPA + tx + 16 * j] = t4.z;
        pq[(row0 + 3) * kPA + tx + 16 * j] = t4.w;
      }
      __syncthreads();
      // t k over the tile's real keys, summed over the key tiles in order
      // in dq_sum; at the last one dq = (t k) (rinv scale)
      float dq[4][4];
      zero(dq);
      tile_product_n<4, 1, kPA>(dq, pq, kT, row0, tx, depth(k0, S));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + row0 + i;
        if (r >= S) continue;
        const float f = ri_s[row0 + i] * scale;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c >= dc) continue;
          float* sum = dq_sum + (long long)r * D + c;
          const float x = kt > 0 ? *sum + dq[i][j] : dq[i][j];
          if (kt + 1 < n_t) {
            *sum = x;
          } else {
            drow[(long long)r * C + c] = E::store(x * f);
            cq[j] += x * f;
          }
        }
      }
    }
    store_rows_t(drow + HD, C, dk_acc, k0, row0, tx, S, dc, ck);
    store_rows_t(drow + 2 * HD, C, dv_acc, k0, row0, tx, S, dc, cv);
  }

  // the bias gradient of the chunk's columns: the column sums of dq, dk and
  // dv over the head's rows, the 16 row groups' in a fixed order
  __syncthreads();  // pq, tq and qT are read
  float* db = a.dbias + (long long)b * C + (long long)h * D + c0;
  write_sums(pq, cq, db, dc);
  write_sums(tq, ck, db + HD, dc);
  write_sums(qT, cv, db + 2 * HD, dc);
}

template <typename T>
int launch_wide(const void* qkv, const void* dout, const void* out,
                const void* st, void* dqkv, void* dbias, void* dq_sum, int B,
                int S, int H, int D, float scale, cudaStream_t stream) {
  WideArgs<T> a;
  a.qkv = static_cast<const T*>(qkv);
  a.dout = static_cast<const T*>(dout);
  a.out = static_cast<const T*>(out);
  a.st = static_cast<const float*>(st);
  a.dqkv = static_cast<T*>(dqkv);
  a.dbias = static_cast<float*>(dbias);
  a.dq_sum = static_cast<float*>(dq_sum);
  a.H = H, a.S = S, a.D = D, a.n_t = (S + kTile - 1) / kTile;
  a.n_c = (D + kTile - 1) / kTile;
  a.scale = scale;
  a.q_scale = rounded_scale<T>(scale);
  const long long blocks = (long long)B * H * a.n_c;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<kTile>();
  const int rc = (int)cudaFuncSetAttribute(
      attn_bwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  attn_bwd_wide_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const long long blocks = (long long)B * a.H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem_bytes<kD>() > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        attn_bwd_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<kD>());
    if (rc) return rc;
  }
  attn_bwd_kernel<kD><<<(unsigned)blocks, kThreads, smem_bytes<kD>(),
                        stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The fp32 scratch vtx_attn_bwd takes at these sizes and element type, in
// floats: csrc/attn_bwd_simt.cu's (its rows' records, dq's parts, the bias
// partials) for fp32 at 128 < D <= 256, else dq_sum (B, H, S, D).
long long vtx_attn_bwd_scratch(int B, int S, int H, int D, int dtype) {
  if (dtype == kF32 && D > kMaxHeadDim && D <= kMaxSimtHeadDim)
    return attn_bwd_simt::scratch_floats(B, H, S, D);
  return (long long)B * H * S * D;
}

// dqkv (B, S, 3HD) and dbias (B, 3HD) fp32 out, from qkv (B, S, 3HD), dout
// and out (B, S, HD), all of the element type `dtype` (elem.cuh's code) and
// contiguous, and the forward's (B, H, S, 2) fp32 stats. Scratch: fp32 of
// vtx_attn_bwd_scratch floats, 16-byte aligned. fp32 at D <= 128 runs
// attn_bwd_kernel, fp32 at 128 < D <= 256 csrc/attn_bwd_simt.cu's four
// launches, every other call attn_bwd_wide_kernel (ops/flash_attention.py
// sends bf16 and fp16 here only past 256). 1 <= S <= 1024, 1 <= D <= 1024.
// Returns a cudaError_t as int: 0 when every launch was accepted.
int vtx_attn_bwd(const void* qkv, const void* dout, const void* out,
                 const void* st, void* dqkv, void* dbias, void* dq_sum, int B,
                 int S, int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 || D < 1 ||
      D > kMaxWideHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D > kMaxHeadDim && D <= kMaxSimtHeadDim)
    return attn_bwd_simt::run(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<const float*>(out), static_cast<const float*>(st),
        static_cast<float*>(dqkv), static_cast<float*>(dbias),
        static_cast<float*>(dq_sum), B, S, H, D, scale, s);
  if (dtype != kF32 || D > kMaxHeadDim) {
    switch (dtype) {
      case kF32:
        return launch_wide<float>(qkv, dout, out, st, dqkv, dbias, dq_sum, B,
                                  S, H, D, scale, s);
      case kBf16:
        return launch_wide<__nv_bfloat16>(qkv, dout, out, st, dqkv, dbias,
                                          dq_sum, B, S, H, D, scale, s);
      case kF16:
        return launch_wide<__half>(qkv, dout, out, st, dqkv, dbias, dq_sum,
                                   B, S, H, D, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  Args a;
  a.qkv = static_cast<const float*>(qkv);
  a.dout = static_cast<const float*>(dout);
  a.out = static_cast<const float*>(out);
  a.st = static_cast<const float*>(st);
  a.dqkv = static_cast<float*>(dqkv);
  a.dbias = static_cast<float*>(dbias);
  a.dq_sum = static_cast<float*>(dq_sum);
  a.H = H, a.S = S, a.D = D, a.n_t = (S + kTile - 1) / kTile;
  a.scale = scale;
  if (D <= 32) return launch<32>(a, B, s);
  if (D <= 64) return launch<64>(a, B, s);
  return launch<128>(a, B, s);
}

// The fp32 kernel's dynamic shared memory at head dim D, in bytes (over 128
// also the wide kernel's, in every element type).
int vtx_attn_bwd_smem(int D) {
  if (D <= 32) return (int)smem_bytes<32>();
  if (D <= 64) return (int)smem_bytes<64>();
  if (D <= kMaxHeadDim) return (int)smem_bytes<128>();
  return (int)smem_bytes<kTile>();
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
