// Blocked flash attention (online softmax) on the CUDA cores: float inputs
// at every head dim, and every type past the tensor-core kernels' head
// dims.
//
// Which kernel serves which dtype and head dim D (ops/flash_blocked.py::
// TENSOR_CORE_RULE decides):
//   bf16 and fp16, D <= 256: K4, K5 and K6 on the tensor cores,
//     csrc/flash_fwd.cu and csrc/flash_bwd.cu, libraries of their own;
//   fp32, D <= 128: K4 in csrc/flash_fwd_simt.cu (flash_fwd_simt_kernel:
//     128-row blocks of 8 warps that own whole rows, s on 8 x 4 register
//     tiles, p v on 8 x 4 or 8 x 8, cp.async double buffers at D <= 64), K5
//     and K6 in csrc/flash_bwd_simt.cu (flash_bwd_dkdv_simt_kernel and
//     flash_bwd_dq_simt_kernel: s and dp scored together on 8 x 4 register
//     tiles, the sums on 8 x 8, cp.async double buffers at D <= 64), both
//     linked into this library (the register tiles live in
//     csrc/simt_tiles.cuh);
//   fp32, 129-256: K4, K5 and K6 on the wide register tiles of the same
//     two files (flash_fwd_wide_simt_kernel and flash_bwd_dq_wide_simt_
//     kernel: 64-row blocks of 8 warps that own 8 whole rows each, K and V
//     streamed in pieces through one cp.async ring; K4 an online softmax
//     over 128-key score tiles, K6 s and dp over 128-key tiles and ds k
//     from the warp's own rows; flash_bwd_dkdv_wide_simt_kernel: 32-key
//     blocks on csrc/simt_wide.cuh's tiles): fwd(), dkdv() and dq() hand
//     them float at every D <= 256;
//   every dtype past 256 (to 1024): the *_wide_kernel<T> below (bf16 and
//     fp16 also at 129-256 when called here, which ops/flash_blocked.py
//     does not do).
// Measured on an H100 80GB HBM3 at 700 W, device ms of one call at (B, S,
// H, D) = (32, 1370, 12, 64) (PERF.md §6): fp32 K4 5.204-5.207 (this
// file's flash_fwd_kernel<float, 64> before it: 7.19-7.20 in the same
// call; SDPA's fp32 forward 5.62-5.65); fp32 K5 and K6 9.46-9.53 and
// 7.73-7.77 (this file's loops before them: 12.44 and 10.74-10.75; SDPA's
// whole fp32 backward 14.06-14.18). The fp16 K4, K5 and K6 loops this file
// had at D <= 128 took 7.03-7.07, 12.47-12.54 and 11.47-11.56 device ms
// where csrc/flash_fwd.cu and csrc/flash_bwd.cu take 0.7145-0.7149,
// 1.229-1.230 and 1.055 (PERF.md §6).
//
// Replaces the TPU kernels of vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py, the long-sequence path (S > 1024), where they run in a
// dtype or at a head dim the tensor-core kernels do not take (the JAX
// kernels take any float dtype and head dim):
//   K4 flash_fwd_wide_kernel       <- _fwd_kernel (:33): per query row, over key
//      tiles, a running max m, sum l and fp32 accumulator acc:
//        s = (fp32 q * scale) k^T, keys >= S masked to -1e30;
//        m' = max(m, rowmax s); alpha = exp(m - m'); p = exp(s - m');
//        l = l alpha + sum(p over fp32 p); acc = acc alpha + rnd(p) v;
//      then o = rnd(acc / max(l, 1e-30)), lse = m + log(max(l, 1e-30)).
//   K5 flash_bwd_dkdv_wide_kernel  <- _bwd_dkdv_kernel (:109): per key row,
//      over query tiles, p = exp((q k^T) scale - lse), dv += rnd(p)^T dO,
//      ds = p (dO v^T - delta), dk += rnd(ds)^T q; dk *= scale.
//   K6 flash_bwd_dq_wide_kernel    <- _bwd_dq_kernel (:157): per query row,
//      over key tiles, the same p and ds, dq += rnd(ds) k; dq *= scale.
// rnd(x) rounds to the inputs' dtype, the JAX kernels' astype: an identity
// for float, round-to-nearest-even for half (csrc/elem.cuh). delta =
// rowsum(fp32 dO * fp32 O) comes from the caller. Every product
// accumulates in fp32, from the inputs' values.
//
// Tensors are (B, H, S, D) of any element strides with a contiguous head
// dim: a Layout gives the batch, head and row strides, so q, k and v are
// read straight from a fused (B, S, 3*H*D) projection and o, do, dq, dk, dv
// may live in (B, S, H*D)-style buffers. lse and delta are (B, H, S) fp32.
//
// What bounds them on an H100: the products, as for the bf16 kernels
// (csrc/flash_bwd.cu), here against the 67 TFLOP/s fp32 peak of the CUDA
// cores, since the tensor cores have no fp32 product (TF32 rounds the
// inputs, which the JAX kernels in fp32 do not). FMA and shared-memory
// issue hold these loops back.
//
// Design: 64-row query tiles and 64-row key tiles, 256 threads as 16 x 16
// (csrc/cc_tiles.cuh's register tiles, shared with csrc/attn_bwd.cu).
// A thread owns 4 contiguous rows (ty * 4 + i) and the columns tx + 16 j of
// each tile product, so that A operands are read as float4 (broadcast in a
// half-warp) and B operands as scalars on 16 consecutive banks. Operands
// are staged in shared memory as fp32: an A operand transposed with pitch
// 68 (16-byte rows), a B operand transposed with pitch 65 (an odd pitch:
// row and column reads are both free of bank conflicts). One block works
// on one (b, h) and one tile and loops over the other side's tiles, so
// every sum stays in one block: no float atomics, a deterministic result.
//   K4: block (b*H + h, query tile); q staged once, K and V per key tile;
//       rnd(p) goes through shared memory into the p v product.
//   K5: block (b*H + h, key tile); K and V staged once, q, dO, lse and
//       delta per query tile; dk and dv accumulate in registers (fp16).
//   K6: block (b*H + h, query tile); q, dO, lse and delta once, K and V per
//       key tile; dq accumulates in registers.
// The grid is one-dimensional over (b h, tile), so B H is bounded only by
// 2^31 / ceil(S / 64).
//
// Head dims past 256 (the *_wide_kernel<T>, every dtype): the same tiles
// and loops with the head dim a run-time value up to 1024, in 64-column
// chunks. A block owns one chunk of one (b, h) and tile (a grid ceil(D /
// 64) times as large): it sums s (and dp) over the whole head dim, staging
// 64 columns of each operand at a time in the same order in every block of
// the tile (so m, l, p and ds are bitwise the same in each), then stages
// its chunk of V (K4), of q and dO (K5) or of K (K6) and accumulates the
// chunk's 64 output columns in registers, in the shared memory of a D = 64
// tile. s and dp are computed once per chunk: right, and recorded as slow
// (PERF.md §6), not fast: at D 256 K6 makes 9 full-head-dim products where
// the function needs 3, and at (B, S, H, D) = (32, 1370, 12, 256) the fp32
// K4, K5 and K6 took 86.1, 249.9 and 155.0 device ms here, against 21.9,
// 48.2 and 35.4 on the wide register tiles that run them now (H100 80GB
// HBM3 at 700 W). K4's lse is written by chunk 0.
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; each host function takes the element type
// as a csrc/elem.cuh code (kF32 at every head dim; kBf16 or kF16 past 128)
// and returns cudaGetLastError(), or cudaErrorInvalidValue for another
// code. The caller (ops/flash_blocked.py) checks the shapes: 1 <= D <=
// 1024.

#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

#include "cc_tiles.cuh"
#include "elem.cuh"

// csrc/flash_fwd_simt.cu and csrc/flash_bwd_simt.cu, linked into this
// library: the fp32 K4, K5 and K6 at D <= 256; strides are {batch, head,
// row} in elements.
namespace flash_fwd_simt {
int fwd(const float* q, const float* k, const float* v, float* o,
        float* lse, int B, int H, int S, int D, float scale,
        const long long* in, const long long* out, cudaStream_t stream);
}  // namespace flash_fwd_simt

namespace flash_bwd_simt {
int dkdv(const float* q, const float* k, const float* v, const float* dout,
         const float* lse, const float* delta, float* dk, float* dv, int B,
         int H, int S, int D, float scale, const long long* in,
         const long long* og, const long long* gr, cudaStream_t stream);
int dq(const float* q, const float* k, const float* v, const float* dout,
       const float* lse, const float* delta, float* dq, int B, int H, int S,
       int D, float scale, const long long* in, const long long* og,
       const long long* gr, cudaStream_t stream);
}  // namespace flash_bwd_simt

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

struct Layout {
  long long sb, sh, sr;  // element strides of batch, head and row
};

// Write rows row0 + i (< S) and columns col0 + 16 j (< D) of acc * mul in
// the element type to one head of a tensor with row stride sr.
template <typename T, int NJ>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long sr,
                                           const float (&acc)[4][NJ], int r0,
                                           int row0, int col0, int S, int D,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + row0 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + 16 * j;
      if (c < D) dst[(long long)r * sr + c] = Elem<T>::store(acc[i][j] * mul);
    }
  }
}

// ---- head dims over 128: one 64-column chunk of the outputs per block

constexpr int kWide = 0;  // the kD of a host template that runs these
constexpr int kSimt = 1;  // and of one that runs the linked-in fp32 kernels

// grid (B * H * n_tiles * n_c): block x is chunk x % n_c (its first column
// c0) of tile (x / n_c) % n_tiles of (b, h) = x / (n_c n_tiles).
struct WideBlock {
  int bh, tile, c0;
};

__device__ __forceinline__ WideBlock wide_block(int n_tiles, int n_c) {
  return WideBlock{(int)blockIdx.x / (n_c * n_tiles),
                   ((int)blockIdx.x / n_c) % n_tiles,
                   ((int)blockIdx.x % n_c) * kTile};
}

// K4 at a run-time head dim. Shared memory: qT [kTile x kPA] (a panel of
// q * scale), kT [kTile x kPB] (a panel of K), vT [kTile x kPB] (the chunk
// of V), pT [kTile x kPA] (rnd(p), [key][query]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int H, int S, int D,
                      int n_tiles, int n_c, float scale, Layout in,
                      Layout out) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;
  float* kT = qT + kTile * kPA;
  float* vT = kT + kTile * kPB;
  float* pT = vT + kTile * kPB;
  const WideBlock wb = wide_block(n_tiles, n_c);
  const int bh = wb.bh, tile = wb.tile, c0 = wb.c0;
  const int b = bh / H, h = bh % H, q0 = tile * kTile;
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const long long in_off = b * in.sb + h * in.sh;
  float acc[4][4], m[4], l[4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    float s[4][4];
    zero(s);
    for (int p0 = 0; p0 < D; p0 += kTile) {
      __syncthreads();  // the last panel (or pT, vT) is read
      stage_t<T, kTile>(qT, kPA, q + in_off + p0, in.sr, q0, S, D - p0,
                        scale);
      stage_t<T, kTile>(kT, kPB, k + in_off + p0, in.sr, k0, S, D - p0, 1.f);
      __syncthreads();
      tile_product<4, kTile, kPB, 1>(s, qT, kT, row0, tx);
    }
    stage_t<T, kTile>(vT, kPB, v + in_off + c0, in.sr, k0, S, D - c0, 1.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= S) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = Elem<T>::round(p);
      }
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    store_t(pT, s, row0, tx);
    __syncthreads();
    // acc += rnd(p) v of the chunk: v read from vT [d][key] along the key
    tile_product<4, kTile, 1, kPB>(acc, pT, vT, row0, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lf = fmaxf(l[i], 1e-30f);
    const int r = q0 + row0 + i;
    if (c0 == 0 && tx == 0 && r < S)
      lse[(long long)bh * S + r] = m[i] + logf(lf);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] /= lf;  // o = acc / l, as JAX
  }
  store_rows<T, 4>(o + b * out.sb + h * out.sh + c0, out.sr, acc, q0, row0,
                   tx, S, D - c0, 1.f);
}

// K5 at a run-time head dim. Shared memory: kT, vT [kTile x kPA] (a panel
// of the block's keys), qT, doT [kTile x kPB] (a panel of the query tile;
// then its chunk), pq, dsq [kTile x kPA] (rnd(p), rnd(ds) as [query][key]),
// lse and delta of the query tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int H,
                           int S, int D, int n_tiles, int n_c, float scale,
                           Layout in, Layout og, Layout gr) {
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;
  float* vT = kT + kTile * kPA;
  float* qT = vT + kTile * kPA;
  float* doT = qT + kTile * kPB;
  float* pq = doT + kTile * kPB;
  float* dsq = pq + kTile * kPA;
  float* lse_s = dsq + kTile * kPA;
  float* dl_s = lse_s + kTile;
  const WideBlock wb = wide_block(n_tiles, n_c);
  const int bh = wb.bh, tile = wb.tile, c0 = wb.c0;
  const int b = bh / H, h = bh % H, k0 = tile * kTile;
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const long long in_off = b * in.sb + h * in.sh;
  const T* qg = q + in_off;
  const T* dog = dout + b * og.sb + h * og.sh;
  const float* lse_g = lse + (long long)bh * S;
  const float* dl_g = delta + (long long)bh * S;
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + row0 + i < S;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    // s^T [key][query] = K q^T, dp^T = V dO^T over the head dim
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    for (int p0 = 0; p0 < D; p0 += kTile) {
      __syncthreads();  // the last panel (or chunk, pq, dsq) is read
      stage_t<T, kTile>(kT, kPA, k + in_off + p0, in.sr, k0, S, D - p0, 1.f);
      stage_t<T, kTile>(vT, kPA, v + in_off + p0, in.sr, k0, S, D - p0, 1.f);
      stage_t<T, kTile>(qT, kPB, qg + p0, in.sr, q0, S, D - p0, 1.f);
      stage_t<T, kTile>(doT, kPB, dog + p0, og.sr, q0, S, D - p0, 1.f);
      if (p0 == 0)
        for (int i = threadIdx.x; i < kTile; i += kThreads) {
          const bool ok = q0 + i < S;
          lse_s[i] = ok ? lse_g[q0 + i] : 0.f;
          dl_s[i] = ok ? dl_g[q0 + i] : 0.f;
        }
      __syncthreads();
      tile_product<4, kTile, kPB, 1>(s, kT, qT, row0, tx);
      tile_product<4, kTile, kPB, 1>(dp, vT, doT, row0, tx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = tx + 16 * j;
      const bool q_ok = q0 + qi < S;
      const float ls = lse_s[qi], dl = dl_s[qi];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            (q_ok && key_ok[i]) ? expf(s[i][j] * scale - ls) : 0.f;
        s[i][j] = Elem<T>::round(p);
        dp[i][j] = Elem<T>::round(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();  // the last panel is read
    store_t(pq, s, row0, tx);
    store_t(dsq, dp, row0, tx);
    stage_t<T, kTile>(qT, kPB, qg + c0, in.sr, q0, S, D - c0, 1.f);
    stage_t<T, kTile>(doT, kPB, dog + c0, og.sr, q0, S, D - c0, 1.f);
    __syncthreads();
    // dv += rnd(p)^T dO, dk += rnd(ds)^T q over the chunk's columns
    tile_product<4, kTile, 1, kPB>(dv_acc, pq, doT, row0, tx);
    tile_product<4, kTile, 1, kPB>(dk_acc, dsq, qT, row0, tx);
  }

  const long long g_off = b * gr.sb + h * gr.sh + c0;
  store_rows<T, 4>(dv + g_off, gr.sr, dv_acc, k0, row0, tx, S, D - c0, 1.f);
  store_rows<T, 4>(dk + g_off, gr.sr, dk_acc, k0, row0, tx, S, D - c0,
                   scale);
}

// K6 at a run-time head dim. Shared memory as flash_bwd_dq_kernel<T, 64>:
// qT, doT [kTile x kPA] (a panel of the block's queries), kT, vT [kTile x
// kPB] (a panel of the key tile; then kT its chunk), dsT [kTile x kPA]
// (rnd(ds) as [key][query]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int H, int S, int D, int n_tiles, int n_c,
                         float scale, Layout in, Layout og, Layout gr) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;
  float* doT = qT + kTile * kPA;
  float* kT = doT + kTile * kPA;
  float* vT = kT + kTile * kPB;
  float* dsT = vT + kTile * kPB;
  const WideBlock wb = wide_block(n_tiles, n_c);
  const int bh = wb.bh, tile = wb.tile, c0 = wb.c0;
  const int b = bh / H, h = bh % H, q0 = tile * kTile;
  const int tx = threadIdx.x & 15, row0 = (threadIdx.x >> 4) * 4;
  const long long in_off = b * in.sb + h * in.sh;
  const T* dog = dout + b * og.sb + h * og.sh;
  float ls[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + row0 + i;
    ls[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    dl[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
  }
  float acc[4][4];
  zero(acc);

  for (int k0 = 0; k0 < S; k0 += kTile) {
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    for (int p0 = 0; p0 < D; p0 += kTile) {
      __syncthreads();  // the last panel (or chunk, dsT) is read
      stage_t<T, kTile>(qT, kPA, q + in_off + p0, in.sr, q0, S, D - p0, 1.f);
      stage_t<T, kTile>(doT, kPA, dog + p0, og.sr, q0, S, D - p0, 1.f);
      stage_t<T, kTile>(kT, kPB, k + in_off + p0, in.sr, k0, S, D - p0, 1.f);
      stage_t<T, kTile>(vT, kPB, v + in_off + p0, in.sr, k0, S, D - p0, 1.f);
      __syncthreads();
      tile_product<4, kTile, kPB, 1>(s, qT, kT, row0, tx);
      tile_product<4, kTile, kPB, 1>(dp, doT, vT, row0, tx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = k0 + tx + 16 * j < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key_ok ? expf(s[i][j] * scale - ls[i]) : 0.f;
        dp[i][j] = Elem<T>::round(p * (dp[i][j] - dl[i]));
      }
    }
    __syncthreads();  // the last panel is read
    store_t(dsT, dp, row0, tx);
    stage_t<T, kTile>(kT, kPB, k + in_off + c0, in.sr, k0, S, D - c0, 1.f);
    __syncthreads();
    // dq += rnd(ds) k over the chunk's columns
    tile_product<4, kTile, 1, kPB>(acc, dsT, kT, row0, tx);
  }
  store_rows<T, 4>(dq + b * gr.sb + h * gr.sh + c0, gr.sr, acc, q0, row0, tx,
                   S, D - c0, scale);
}

// n_c: the wide kernels' column chunks per tile (1 for the others).
template <typename Kernel>
int prepare(Kernel kernel, size_t bytes, int B, int H, int S, int* n_tiles,
            dim3* grid, int n_c = 1) {
  *n_tiles = (S + kTile - 1) / kTile;
  const long long blocks = (long long)*n_tiles * B * H * n_c;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)blocks);
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// float at D <= 256 (kD == kSimt: csrc/flash_fwd_simt.cu's and
// csrc/flash_bwd_simt.cu's kernels, which take D themselves), every type
// past that (kD == kWide).
template <typename T, int kD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int S, int D, float scale, Layout in, Layout out,
        cudaStream_t stream) {
  if constexpr (kD == kSimt) {
    static_assert(std::is_same<T, float>::value,
                  "bf16 and fp16 K4 at D <= 256 run in csrc/flash_fwd.cu");
    const long long i[3] = {in.sb, in.sh, in.sr},
                    u[3] = {out.sb, out.sh, out.sr};
    return flash_fwd_simt::fwd(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), B, H, S, D, scale, i, u, stream);
  } else {
    const size_t smem =
        (size_t)(kTile * kPA + 2 * kTile * kPB + kTile * kPA) * sizeof(float);
    const int n_c = (D + kTile - 1) / kTile;
    int n_tiles;
    dim3 grid;
    int rc = prepare(flash_fwd_wide_kernel<T>, smem, B, H, S, &n_tiles,
                     &grid, n_c);
    if (rc) return rc;
    flash_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), H, S, D, n_tiles, n_c, scale, in, out);
    return (int)cudaGetLastError();
  }
}

template <typename T, int kD>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int B,
         int H, int S, int D, float scale, Layout in, Layout og, Layout gr,
         cudaStream_t stream) {
  if constexpr (kD == kSimt) {
    static_assert(std::is_same<T, float>::value,
                  "bf16 and fp16 K5 at D <= 256 run in csrc/flash_bwd.cu");
    const long long i[3] = {in.sb, in.sh, in.sr}, o[3] = {og.sb, og.sh, og.sr},
                    g[3] = {gr.sb, gr.sh, gr.sr};
    return flash_bwd_simt::dkdv(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), B, H, S, D, scale,
        i, o, g, stream);
  } else {
    const size_t smem = (size_t)(2 * kTile * kPA + 2 * kTile * kPB +
                                 2 * kTile * kPA + 2 * kTile) *
                        sizeof(float);
    const int n_c = (D + kTile - 1) / kTile;
    int n_tiles;
    dim3 grid;
    int rc = prepare(flash_bwd_dkdv_wide_kernel<T>, smem, B, H, S, &n_tiles,
                     &grid, n_c);
    if (rc) return rc;
    flash_bwd_dkdv_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, S, D, n_tiles, n_c,
        scale, in, og, gr);
    return (int)cudaGetLastError();
  }
}

template <typename T, int kD>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int H, int S,
       int D, float scale, Layout in, Layout og, Layout gr,
       cudaStream_t stream) {
  if constexpr (kD == kSimt) {
    static_assert(std::is_same<T, float>::value,
                  "bf16 and fp16 K6 at D <= 256 run in csrc/flash_bwd.cu");
    const long long i[3] = {in.sb, in.sh, in.sr}, o[3] = {og.sb, og.sh, og.sr},
                    g[3] = {gr.sb, gr.sh, gr.sr};
    return flash_bwd_simt::dq(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dqp), B, H, S, D, scale, i, o, g, stream);
  } else {
    const size_t smem =
        (size_t)(2 * kTile * kPA + 2 * kTile * kPB + kTile * kPA) *
        sizeof(float);
    const int n_c = (D + kTile - 1) / kTile;
    int n_tiles;
    dim3 grid;
    int rc = prepare(flash_bwd_dq_wide_kernel<T>, smem, B, H, S, &n_tiles,
                     &grid, n_c);
    if (rc) return rc;
    flash_bwd_dq_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dqp), H, S, D, n_tiles, n_c, scale, in, og, gr);
    return (int)cudaGetLastError();
  }
}

// f<float, kSimt>(args...) for kF32 at head dims D up to 256; past it
// f<T, kWide> for the element type `dtype`, the wide kernels in kBf16, kF16
// and kF32 (bf16 and fp16 only past 128).
#define DISPATCH(f, dtype, D, ...)                                          \
  if ((dtype) == kF32 && (D) <= 256)                                       \
    return f<float, kSimt>(__VA_ARGS__);                                    \
  if ((D) <= 128) return (int)cudaErrorInvalidValue;                        \
  switch (dtype) {                                                          \
    case kBf16:                                                             \
      return f<__nv_bfloat16, kWide>(__VA_ARGS__);                          \
    case kF16:                                                              \
      return f<__half, kWide>(__VA_ARGS__);                                 \
    case kF32:                                                              \
      return f<float, kWide>(__VA_ARGS__);                                  \
    default:                                                                \
      return (int)cudaErrorInvalidValue;                                    \
  }

}  // namespace

extern "C" {

// o (out layout) and lse (B, H, S) fp32 from q, k, v (in layout).
int vtx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int S, int D, float scale,
                  long long in_sb, long long in_sh, long long in_sr,
                  long long out_sb, long long out_sh, long long out_sr,
                  int dtype, void* stream) {
  const Layout in{in_sb, in_sh, in_sr}, out{out_sb, out_sh, out_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(fwd, dtype, D, q, k, v, o, lse, B, H, S, D, scale, in, out,
           s)
}

// dk, dv (grad layout) from q, k, v (in layout), dout (its own layout),
// lse and delta (B, H, S) fp32.
int vtx_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int S, int D,
                       float scale, long long in_sb, long long in_sh,
                       long long in_sr, long long og_sb, long long og_sh,
                       long long og_sr, long long gr_sb, long long gr_sh,
                       long long gr_sr, int dtype, void* stream) {
  const Layout in{in_sb, in_sh, in_sr}, og{og_sb, og_sh, og_sr},
      gr{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dkdv, dtype, D, q, k, v, dout, lse, delta, dk, dv, B, H, S,
           D, scale, in, og, gr, s)
}

// dq (grad layout), from the same inputs.
int vtx_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dqp, int B, int H, int S, int D, float scale,
                     long long in_sb, long long in_sh, long long in_sr,
                     long long og_sb, long long og_sh, long long og_sr,
                     long long gr_sb, long long gr_sh, long long gr_sr,
                     int dtype, void* stream) {
  const Layout in{in_sb, in_sh, in_sr}, og{og_sb, og_sh, og_sr},
      gr{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dq, dtype, D, q, k, v, dout, lse, delta, dqp, B, H, S, D,
           scale, in, og, gr, s)
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
