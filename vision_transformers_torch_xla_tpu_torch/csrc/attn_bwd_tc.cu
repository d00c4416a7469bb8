// Softmax attention backward over a fused (B, S, 3*H*D) qkv buffer on
// Hopper's tensor cores, in bf16 and fp16.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_bwd_pi_kernel (:495, ROADMAP K2). Same function, per (b, h), from
// the forward's (B, H, S, 2) row stats [m, rinv] (csrc/attn_fwd_tc.cu),
// with T the element type:
//   q^ = T(q * scale); pu = exp(q^ k^T - m), fp32, left unnormalised;
//   do_n = T(dO * rinv); dv = T(pu)^T do_n;
//   delta = rowsum(dO * O) in fp32; dp = dO v^T; t = T((dp - delta) pu);
//   dq = (t k) * (rinv * scale); qn = T(q^ * rinv); dk = t^T qn.
// Every product is T x T into fp32, what wgmma computes, so the cast order
// is the TPU kernel's. dq, dk and dv are stored as T into one (B, S, 3 H D)
// dqkv buffer at the standard columns h D, H D + h D and 2 H D + h D, and
// their fp32 values (dq with its rinv * scale) summed over the sequence go
// to the (B, 3 H D) qkv-bias partials in the same column order. The
// exponentials run as exp2f(s log2(e) - m log2(e)), which moves pu by a
// relative ~1e-6 (csrc/attn_fwd_tc.cu says why), far below its rounding to
// T. The fp32 version of the same function is csrc/attn_bwd.cu's CUDA-core
// loops.
//
// What bounds it on an H100: at ViT-B shapes (S = 197, D = 64) one (b, h)
// is 10 S^2 D = 25 MFLOP (s, dp, dv, dk, dq) over ~0.2 MB of operands,
// ~120 FLOP per byte, below the ~295 of the ridge: device memory bounds
// the work (at B = 128, 12 heads, 0.0936 ms). The design computes s and dp
// twice (once per stationary side), 14 S^2 D, on short tiles, where
// latency between the TMA loads, the products and the elementwise work
// sets the pace.
//
// Design: four launches, so that no sum crosses blocks and nothing takes a
// float atomic (the result is deterministic, bitwise, run to run):
// 1. prep (CUDA cores, one warp per query row): q^, qn and do_n as T and
//    delta as fp32 into scratch that the caller allocates, (B, H, S, dsc)
//    rows (dsc a multiple of 8, so TMA reads them) and (B, H, S).
// 2. dk/dv (as csrc/flash_bwd.cu's K5): a block holds 128 keys (K and V
//    loaded once by TMA) and streams tiles of 64 queries (q^, dO, qn and
//    do_n through a 2-stage ring, with the tiles' m log2(e) and delta,
//    which the producer's lanes store beside them: 0 for rows >= S, so pu
//    stays finite and, with the zero-filled dO, every term of such a row
//    vanishes). Each of two consumer warpgroups owns 64 keys: S^T = K q^^T
//    and dP^T = V dO^T are SS wgmma m64n64k16, both operands K-major as
//    stored; pu^T (keys >= S masked to 0) and t^T in fp32 registers,
//    packed to T as register A fragments of dV += T(pu)^T do_n and dK +=
//    t^T qn, with do_n and qn MN-major B operands. The producer warpgroup
//    lends the consumers its registers (setmaxnreg), as K5's does.
// 3. dq (as K6): a block holds 128 queries (q^ and dO once) and streams
//    K and V tiles of 64 keys; S = q^ K^T and dP = dO V^T as SS wgmma, t
//    packed as the A fragment of dQ += t K with K MN-major; dq *
//    (rinv * scale) per row in the epilogue.
// 4. bias: each stationary tile's column sums of its fp32 gradients (rows
//    < S, summed in registers, then across lanes and warps in a fixed
//    order) are (B, tiles, 3 H D) partials; one thread per (b, column) adds
//    a column's tiles in order into the (B, 3 H D) result.
// k, v, dO and the scratch are read through 4-D TMA tensor maps (D, S, H,
// B) with their element strides, in [64 rows][64 columns] boxes, zeros past
// S and D; q, dO and O by the prep's loads. TMA needs 16-byte-aligned data
// and strides (D a multiple of 8), which the caller (ops/
// flash_attention.py) arranges, copying once where they are not. Grids are
// one-dimensional.
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function returns
// cudaGetLastError() (the first launch's error that is not 0), or a code
// >= kErrEncodeBase when a tensor map could not be encoded
// (vtx_cuda_error_string says which).

#include <limits.h>

#include "elem.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;          // rows of a streamed tile and of a warpgroup
constexpr int kBlockRows = 128;    // stationary rows of a block
constexpr int kStages = 2;         // ring depth of the streamed tiles
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kDqThreads = kConsumers + 32;     // + the producer warp
constexpr int kDkdvThreads = kConsumers + 128;  // + the producer warpgroup
// dk/dv keeps four accumulators per consumer thread (S^T, dP^T, dK, dV:
// 192 floats at D = 128): launched at 168 registers a thread, the producer
// warpgroup drops to kProducerRegs and the consumers rise to
// kConsumerRegs, 128 x 40 + 256 x 232 = 384 x 168 (as csrc/flash_bwd.cu).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStreamPanel = kRows * kPanel;         // 8 KB
constexpr int kFixedPanel = kBlockRows * kPanel;     // 16 KB
constexpr uint32_t kStreamBytes = kStreamPanel * 2;  // LBO of an MN-major tile
constexpr int kPrepWarps = 8;
constexpr int kBiasThreads = 256;
constexpr int kMaxSeq = 1024;

// Shared tiles of the dk/dv kernel; every panel is a multiple of 1024
// bytes, so each stays aligned to the swizzle atom when the struct is.
template <typename T, int kD>
struct DkdvTiles {
  T k[kD / kPanel][kFixedPanel];
  T v[kD / kPanel][kFixedPanel];
  T qh[kStages][kD / kPanel][kStreamPanel];
  T dout[kStages][kD / kPanel][kStreamPanel];
  T qn[kStages][kD / kPanel][kStreamPanel];
  T don[kStages][kD / kPanel][kStreamPanel];
  float ml[kStages][kRows];  // m log2(e) of the tile's queries
  float delta[kStages][kRows];
  float red[2][kConsumerWarps][kD];  // per-warp column sums of dk, dv
};

// Shared tiles of the dq kernel.
template <typename T, int kD>
struct DqTiles {
  T qh[kD / kPanel][kFixedPanel];
  T dout[kD / kPanel][kFixedPanel];
  T k[kStages][kD / kPanel][kStreamPanel];
  T v[kStages][kD / kPanel][kStreamPanel];
  float red[kConsumerWarps][kD];  // per-warp column sums of dq
};

template <typename Tiles>
__device__ __forceinline__ Tiles& aligned_tiles(uint8_t* raw) {
  // the swizzle atom is 1024 bytes: align the tiles to it
  return *reinterpret_cast<Tiles*>(raw +
                                   ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This warp is done with a stage.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// Write the accumulator of a m64 x kD product, times mul0 (row r0) and
// mul1 (row r0 + 8), as T pairs of rows < S and columns 8 n + col < D of
// one head.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long sr,
                                           const float (&acc)[N], int r0,
                                           int col, int S, int D, float mul0,
                                           float mul1) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int c = 8 * n + col;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dst + r0 * sr + c) =
          pack2<T>(acc[4 * n] * mul0, acc[4 * n + 1] * mul0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dst + r1 * sr + c) =
          pack2<T>(acc[4 * n + 2] * mul1, acc[4 * n + 3] * mul1);
  }
}

// This warp's column sums of acc (times mul0 and mul1 per row, rows < S
// only) into red[kD]: the thread's two rows, then the warp's 8 row groups
// by shuffles; lanes 0-3 write.
template <int N>
__device__ __forceinline__ void column_sums(const float (&acc)[N],
                                            float mul0, float mul1,
                                            float* red, int lane) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    float a = acc[4 * n] * mul0 + acc[4 * n + 2] * mul1;
    float c = acc[4 * n + 1] * mul0 + acc[4 * n + 3] * mul1;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane < 4) {
      red[8 * n + 2 * lane] = a;
      red[8 * n + 2 * lane + 1] = c;
    }
  }
}

// 1. One warp per row r of (B H S): q^, qn, do_n (row stride dsc) and
// delta. q is read with layout in, dO and O with layout og, as pairs.
template <typename T>
__global__ void __launch_bounds__(kPrepWarps * 32)
attn_bwd_tc_prep_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                        const T* __restrict__ out,
                        const float* __restrict__ st, T* __restrict__ qh,
                        T* __restrict__ qn, T* __restrict__ don,
                        float* __restrict__ delta, int H, int S, int D,
                        int dsc, float scale, Layout in, Layout og,
                        long long rows) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  const long long r = (long long)blockIdx.x * kPrepWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // the whole warp leaves together
  const long long bh = r / S;
  const int i = (int)(r % S), b = (int)(bh / H), h = (int)(bh % H);
  const float rinv = st[r * 2 + 1];
  const Pair* qp =
      reinterpret_cast<const Pair*>(q + b * in.sb + h * in.sh + i * in.sr);
  const long long oi = b * og.sb + h * og.sh + i * og.sr;
  const Pair* gp = reinterpret_cast<const Pair*>(dout + oi);
  const Pair* op = reinterpret_cast<const Pair*>(out + oi);
  Pair* qh2 = reinterpret_cast<Pair*>(qh + r * dsc);
  Pair* qn2 = reinterpret_cast<Pair*>(qn + r * dsc);
  Pair* dn2 = reinterpret_cast<Pair*>(don + r * dsc);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 qf = E::load2(qp[c]);
    const Pair qq = E::store2(qf.x * scale, qf.y * scale);
    const float2 qhf = E::load2(qq);
    qh2[c] = qq;
    qn2[c] = E::store2(qhf.x * rinv, qhf.y * rinv);
    const float2 gf = E::load2(gp[c]);
    dn2[c] = E::store2(gf.x * rinv, gf.y * rinv);
    const float2 of = E::load2(op[c]);
    acc = fmaf(gf.x, of.x, acc);
    acc = fmaf(gf.y, of.y, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[r] = acc;
}

// 2. grid (n_t * B * H): block x is key tile x % n_t of (b, h) = x / n_t.
// Accumulator fragments (wgmma m64nN, f32): thread t of a warpgroup, warp
// w = t / 32, lane l, holds d[4n + j] at row 16 w + l / 4 + 8 (j / 2),
// column 8 n + 2 (l % 4) + (j % 2). Rows are keys; columns of S^T and dP^T
// the tile's queries, of dK and dV the head dim. dk and dv point at head
// 0's columns (grad layout gr); part at (B, n_t, C) fp32, dk's partials at
// column off_k + h D, dv's at off_k + H D + h D.
template <typename T, int kD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
attn_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tqh,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tqn,
                        const __grid_constant__ CUtensorMap tdn,
                        const float* __restrict__ st,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ part, int H,
                        int S, int D, int n_t, int C, Layout gr) {
  constexpr int kPanels = kD / kPanel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  DkdvTiles<T, kD>& t = aligned_tiles<DkdvTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_t;
  const int kt = blockIdx.x % n_t, k0 = kt * kBlockRows;
  const int b = bh / H, h = bh % H;
  const int n_qt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);  // the producer warp's lanes
      bar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: its registers go to the consumers; one warp
    // loads K and V once, then the query-side tiles through the ring, and
    // every lane of it stores two of the tile's m log2(e) and delta rows,
    // then arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      bar_expect_tx(&kv_full, 2 * kBlockRows * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        for (int r = 0; r < kBlockRows; r += kRows) {
          tma_load(&t.k[p][r * kPanel], &tk, &kv_full, p * kPanel, k0 + r, h,
                   b);
          tma_load(&t.v[p][r * kPanel], &tv, &kv_full, p * kPanel, k0 + r, h,
                   b);
        }
    }
    const long long rows = (long long)bh * S;
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages;
      const int q0 = j * kRows;
      if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
      for (int i = lane; i < kRows; i += 32) {
        const bool ok = q0 + i < S;
        t.ml[s][i] = ok ? st[(rows + q0 + i) * 2] * kLog2e : 0.f;
        t.delta[s][i] = ok ? delta[rows + q0 + i] : 0.f;
      }
      if (lane == 0) {
        bar_expect_tx(&full[s], 4 * kRows * kD * 2);
        for (int p = 0; p < kPanels; ++p) {
          const int c = p * kPanel;
          tma_load(t.qh[s][p], &tqh, &full[s], c, q0, h, b);
          tma_load(t.dout[s][p], &tdo, &full[s], c, q0, h, b);
          tma_load(t.qn[s][p], &tqn, &full[s], c, q0, h, b);
          tma_load(t.don[s][p], &tdn, &full[s], c, q0, h, b);
        }
      } else {
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  const int key0 = k0 + wg * kRows + row;
  const bool ok0 = key0 < S, ok1 = key0 + 8 < S;
  float dk_acc[kD / 2], dv_acc[kD / 2];
  float s[32], dp[32];
  zero(dk_acc);
  zero(dv_acc);
  zero(s);
  zero(dp);

  bar_wait(&kv_full, 0);
  for (int j = 0; j < n_qt; ++j) {
    const int stg = j % kStages;
    bar_wait(&full[stg], (j / kStages) & 1);

    // S^T = K q^^T and dP^T = V dO^T over kD / 16 steps of 16 columns
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(s, desc(&t.k[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.qh[stg][p][c], 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(dp, desc(&t.v[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.dout[stg][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // pu^T and t^T = (dP^T - delta) pu^T in fp32, packed to T A fragments:
    // queries 16 c .. 16 c + 15 are registers (row, lo 8), (row + 8, lo 8),
    // (row, hi 8), (row + 8, hi 8)
    uint32_t pa[4][4], ta[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = 8 * n + col;
      const float ml0 = t.ml[stg][qc], ml1 = t.ml[stg][qc + 1];
      const float d0 = t.delta[stg][qc], d1 = t.delta[stg][qc + 1];
      const float p0 = ok0 ? exp2f(fmaf(s[4 * n], kLog2e, -ml0)) : 0.f;
      const float p1 = ok0 ? exp2f(fmaf(s[4 * n + 1], kLog2e, -ml1)) : 0.f;
      const float p2 = ok1 ? exp2f(fmaf(s[4 * n + 2], kLog2e, -ml0)) : 0.f;
      const float p3 = ok1 ? exp2f(fmaf(s[4 * n + 3], kLog2e, -ml1)) : 0.f;
      pa[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
      ta[n / 2][(n % 2) * 2] =
          pack2<T>((dp[4 * n] - d0) * p0, (dp[4 * n + 1] - d1) * p1);
      ta[n / 2][(n % 2) * 2 + 1] =
          pack2<T>((dp[4 * n + 2] - d0) * p2, (dp[4 * n + 3] - d1) * p3);
    }

    // dV += T(pu)^T do_n, dK += t^T qn over 4 steps of 16 queries
    pin(dv_acc);
    pin(dk_acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wgmma_rs<T>(dv_acc, pa[c],
                  desc(&t.don[stg][0][c * 16 * kPanel], kStreamBytes, 1024));
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wgmma_rs<T>(dk_acc, ta[c],
                  desc(&t.qn[stg][0][c * 16 * kPanel], kStreamBytes, 1024));
    wg_commit();
    wg_wait();
    pin(dv_acc);
    pin(dk_acc);
    release(&empty[stg], lane);
  }

  const long long g_off = b * gr.sb + h * gr.sh;
  store_rows(dv + g_off, gr.sr, dv_acc, key0, col, S, D, 1.f, 1.f);
  store_rows(dk + g_off, gr.sr, dk_acc, key0, col, S, D, 1.f, 1.f);
  // the bias partials of this key tile: rows < S only
  const float w0 = ok0 ? 1.f : 0.f, w1 = ok1 ? 1.f : 0.f;
  column_sums(dk_acc, w0, w1, t.red[0][warp], lane);
  column_sums(dv_acc, w0, w1, t.red[1][warp], lane);
  named_barrier(1, kConsumers);
  float* pk = part + ((long long)b * n_t + kt) * C + (C / 3) + h * D;
  for (int c = threadIdx.x; c < D; c += kConsumers) {
    float sk = 0.f, sv = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) {
      sk += t.red[0][w][c];
      sv += t.red[1][w][c];
    }
    pk[c] = sk;
    pk[C / 3 + c] = sv;
  }
}

// 3. grid (n_t * B * H): block x is query tile x % n_t of (b, h) = x / n_t.
// Rows of every fragment are queries; columns of S and dP are the tile's
// keys, columns of dQ the head dim. dq points at head 0's columns (grad
// layout gr); dq's partials go to part at column h D.
template <typename T, int kD>
__global__ void __launch_bounds__(kDqThreads, 1)
attn_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tqh,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const float* __restrict__ st,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      float* __restrict__ part, int H, int S, int D, int n_t,
                      int C, float scale, Layout gr) {
  constexpr int kPanels = kD / kPanel;
  constexpr uint32_t kTileBytes = 2 * kRows * kD * 2;  // one K and V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  DqTiles<T, kD>& t = aligned_tiles<DqTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_t;
  const int qt = blockIdx.x % n_t, q0 = qt * kBlockRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: q^ and dO once, then K and V tiles through the ring
    if (lane == 0) {
      bar_expect_tx(&q_full, 2 * kBlockRows * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        for (int r = 0; r < kBlockRows; r += kRows) {
          tma_load(&t.qh[p][r * kPanel], &tqh, &q_full, p * kPanel, q0 + r,
                   h, b);
          tma_load(&t.dout[p][r * kPanel], &tdo, &q_full, p * kPanel,
                   q0 + r, h, b);
        }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
        bar_expect_tx(&full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(t.k[s][p], &tk, &full[s], p * kPanel, j * kRows, h, b);
          tma_load(t.v[s][p], &tv, &full[s], p * kPanel, j * kRows, h, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64);
  // rows >= S take m = rinv = delta = 0
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  const int r0 = q0 + wg * kRows + row, r1 = r0 + 8;
  const long long rows = (long long)bh * S;
  const float ml0 = r0 < S ? st[(rows + r0) * 2] * kLog2e : 0.f;
  const float ml1 = r1 < S ? st[(rows + r1) * 2] * kLog2e : 0.f;
  const float f0 = r0 < S ? st[(rows + r0) * 2 + 1] * scale : 0.f;
  const float f1 = r1 < S ? st[(rows + r1) * 2 + 1] * scale : 0.f;
  const float dl0 = r0 < S ? delta[rows + r0] : 0.f;
  const float dl1 = r1 < S ? delta[rows + r1] : 0.f;
  float dq_acc[kD / 2];
  float s[32], dp[32];
  zero(dq_acc);
  zero(s);
  zero(dp);

  bar_wait(&q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int stg = j % kStages;
    const int kb = j * kRows;
    bar_wait(&full[stg], (j / kStages) & 1);

    // S = q^ K^T and dP = dO V^T over kD / 16 steps of 16 columns
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(s, desc(&t.qh[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.k[stg][p][c], 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n64<T>(dp,
                      desc(&t.dout[p][wg * kRows * kPanel + c], 16, 1024),
                      desc(&t.v[stg][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // t = (dP - delta) pu in fp32, keys >= S masked, packed to T A
    // fragments
    uint32_t ta[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kc = kb + 8 * n + col;
      const bool okc0 = kc < S, okc1 = kc + 1 < S;
      const float p0 = okc0 ? exp2f(fmaf(s[4 * n], kLog2e, -ml0)) : 0.f;
      const float p1 = okc1 ? exp2f(fmaf(s[4 * n + 1], kLog2e, -ml0)) : 0.f;
      const float p2 = okc0 ? exp2f(fmaf(s[4 * n + 2], kLog2e, -ml1)) : 0.f;
      const float p3 = okc1 ? exp2f(fmaf(s[4 * n + 3], kLog2e, -ml1)) : 0.f;
      ta[n / 2][(n % 2) * 2] =
          pack2<T>((dp[4 * n] - dl0) * p0, (dp[4 * n + 1] - dl0) * p1);
      ta[n / 2][(n % 2) * 2 + 1] =
          pack2<T>((dp[4 * n + 2] - dl1) * p2, (dp[4 * n + 3] - dl1) * p3);
    }

    // dQ += t K over 4 steps of 16 keys
    pin(dq_acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wgmma_rs<T>(dq_acc, ta[c],
                  desc(&t.k[stg][0][c * 16 * kPanel], kStreamBytes, 1024));
    wg_commit();
    wg_wait();
    pin(dq_acc);
    release(&empty[stg], lane);
  }

  // dq = (t k) (rinv scale); the bias partials of this query tile sum the
  // same fp32 values (rows >= S have f = 0)
  store_rows(dq + b * gr.sb + h * gr.sh, gr.sr, dq_acc, r0, col, S, D, f0,
             f1);
  column_sums(dq_acc, f0, f1, t.red[warp], lane);
  named_barrier(1, kConsumers);
  float* pq = part + ((long long)b * n_t + qt) * C + h * D;
  for (int c = threadIdx.x; c < D; c += kConsumers) {
    float sq = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) sq += t.red[w][c];
    pq[c] = sq;
  }
}

// 4. dbias[b][c] = the sum over tiles, in order, of part[b][tile][c].
__global__ void __launch_bounds__(kBiasThreads)
attn_bwd_tc_bias_kernel(const float* __restrict__ part,
                        float* __restrict__ dbias, int n_t, int C,
                        long long total) {
  const long long x = (long long)blockIdx.x * kBiasThreads + threadIdx.x;
  if (x >= total) return;
  const long long b = x / C;
  const int c = (int)(x % C);
  float sum = 0.f;
  for (int i = 0; i < n_t; ++i) sum += part[(b * n_t + i) * C + c];
  dbias[x] = sum;
}

// Everything the host function hands the launches.
struct Args {
  const void *q, *k, *v, *dout, *out, *st;
  void *dq, *dk, *dv, *dbias, *qh, *qn, *don, *delta, *part;
  int B, H, S, D, dsc;
  float scale;
  Layout in, og, gr;
};

int blocks_of(long long n, int per, unsigned* grid) {
  const long long blocks = (n + per - 1) / per;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  *grid = (unsigned)blocks;
  return 0;
}

template <typename T, int kD>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.S;
  const int n_t = (a.S + kBlockRows - 1) / kBlockRows;
  const int C = 3 * a.H * a.D;
  unsigned grid;
  int rc = blocks_of(rows, kPrepWarps, &grid);
  if (rc) return rc;
  attn_bwd_tc_prep_kernel<T><<<grid, kPrepWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.dout),
      static_cast<const T*>(a.out), static_cast<const float*>(a.st),
      static_cast<T*>(a.qh), static_cast<T*>(a.qn), static_cast<T*>(a.don),
      static_cast<float*>(a.delta), a.H, a.S, a.D, a.dsc, a.scale, a.in, a.og,
      rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  const CUtensorMapDataType type = map_type<T>();
  const Layout sc{(long long)a.H * a.S * a.dsc, (long long)a.S * a.dsc,
                  a.dsc};
  CUtensorMap tk, tv, tqh, tdo, tqn, tdn;
  const int B = a.B, H = a.H, S = a.S, D = a.D;
  rc = encode(enc, &tk, a.k, B, H, S, D, a.in, kRows, type);
  if (!rc) rc = encode(enc, &tv, a.v, B, H, S, D, a.in, kRows, type);
  if (!rc) rc = encode(enc, &tdo, a.dout, B, H, S, D, a.og, kRows, type);
  if (!rc) rc = encode(enc, &tqh, a.qh, B, H, S, D, sc, kRows, type);
  if (!rc) rc = encode(enc, &tqn, a.qn, B, H, S, D, sc, kRows, type);
  if (!rc) rc = encode(enc, &tdn, a.don, B, H, S, D, sc, kRows, type);
  if (rc) return rc;
  rc = blocks_of((long long)n_t * B * H, 1, &grid);
  if (rc) return rc;
  const float* st = static_cast<const float*>(a.st);
  const float* delta = static_cast<const float*>(a.delta);
  float* part = static_cast<float*>(a.part);

  const size_t dkdv_smem = sizeof(DkdvTiles<T, kD>) + 1024;  // + alignment
  rc = (int)cudaFuncSetAttribute(attn_bwd_tc_dkdv_kernel<T, kD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dkdv_smem);
  if (rc) return rc;
  attn_bwd_tc_dkdv_kernel<T, kD><<<grid, kDkdvThreads, dkdv_smem, stream>>>(
      tk, tv, tqh, tdo, tqn, tdn, st, delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), part, H, S, D, n_t, C, a.gr);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  const size_t dq_smem = sizeof(DqTiles<T, kD>) + 1024;
  rc = (int)cudaFuncSetAttribute(attn_bwd_tc_dq_kernel<T, kD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dq_smem);
  if (rc) return rc;
  attn_bwd_tc_dq_kernel<T, kD><<<grid, kDqThreads, dq_smem, stream>>>(
      tqh, tdo, tk, tv, st, delta, static_cast<T*>(a.dq), part, H, S, D, n_t,
      C, a.scale, a.gr);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  const long long total = (long long)B * C;
  rc = blocks_of(total, kBiasThreads, &grid);
  if (rc) return rc;
  attn_bwd_tc_bias_kernel<<<grid, kBiasThreads, 0, stream>>>(
      part, static_cast<float*>(a.dbias), n_t, C, total);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, cudaStream_t s) {
  return a.D <= 64 ? launch<T, 64>(a, s) : launch<T, 128>(a, s);
}

}  // namespace

extern "C" {

// dq, dk, dv (grad layout, each pointing at head 0's columns of one dqkv
// buffer) of the element type `dtype` (elem.cuh's code: bf16 or fp16; fp32
// is csrc/attn_bwd.cu's) and dbias (B, 3 H D) fp32, from q, k, v (layout
// in), dout and out (layout og) and the forward's (B, H, S, 2) fp32 stats.
// Scratch: qh, qn, don (B, H, S, dsc) of that type (dsc >= D, a multiple of
// 8), delta (B, H, S) fp32 and part (B, n_t, 3 H D) fp32, n_t =
// vtx_attn_bwd_tc_tiles(S). 1 <= S <= 1024, D even and <= 128. Returns a cudaError_t as int (0 when
// every launch was accepted), or a code of vtx_cuda_error_string's own.
int vtx_attn_bwd_tc(const void* q, const void* k, const void* v,
                    long long in_sb, long long in_sh, long long in_sr,
                    const void* dout, const void* out, long long og_sb,
                    long long og_sh, long long og_sr, const void* st,
                    void* dq, void* dk, void* dv, long long gr_sb,
                    long long gr_sh, long long gr_sr, void* dbias, void* qh,
                    void* qn, void* don, int dsc, void* delta, void* part,
                    int B, int H, int S, int D, float scale, int dtype,
                    void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > kMaxSeq || D < 2 || (D & 1) ||
      D > 128 || dsc < D || dsc % 8)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.out = out, a.st = st;
  a.dq = dq, a.dk = dk, a.dv = dv, a.dbias = dbias;
  a.qh = qh, a.qn = qn, a.don = don, a.delta = delta, a.part = part;
  a.B = B, a.H = H, a.S = S, a.D = D, a.dsc = dsc, a.scale = scale;
  a.in = Layout{in_sb, in_sh, in_sr};
  a.og = Layout{og_sb, og_sh, og_sr};
  a.gr = Layout{gr_sb, gr_sh, gr_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: return launch_d<bf16>(a, s);
    case kF16: return launch_d<f16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The row tiles of a sequence of S rows: part's middle dimension.
int vtx_attn_bwd_tc_tiles(int S) { return (S + kBlockRows - 1) / kBlockRows; }

// The dynamic shared memory of the dk/dv launch (dq == 0) or the dq launch
// (dq == 1) at head dim D, in bytes (the same for bf16 and fp16).
int vtx_attn_bwd_tc_smem(int D, int dq) {
  const size_t tiles =
      dq ? (D <= 64 ? sizeof(DqTiles<bf16, 64>) : sizeof(DqTiles<bf16, 128>))
         : (D <= 64 ? sizeof(DkdvTiles<bf16, 64>)
                    : sizeof(DkdvTiles<bf16, 128>));
  return (int)tiles + 1024;
}

const char* vtx_cuda_error_string(int err) { return error_string(err); }

}  // extern "C"
