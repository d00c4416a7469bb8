// Softmax attention backward that recomputes the probabilities from q, k, v
// and dO alone, on Hopper's tensor cores, in bf16 and fp16.
//
// Replaces three TPU kernels of
// vision_transformers_torch_xla_tpu/ops/flash_attention.py that compute one
// function over different layouts:
//   _bwd_kernel (:61, ROADMAP K8), the backward of _fwd_kernel (K7), on
//     separate (B*H, Sp, Dp) q, k, v and dO;
//   _hp_bwd_kernel (:212, K10), the backward of the head-pair attention
//     (K9), on a fused (B, S, 3*H*D) qkv buffer;
//   _qkv_bwd_kernel (:764, K12), the backward of _qkv_fwd_kernel (K11), on
//     a (B, Sp, 3H, D) qkv buffer.
// Per (b, h), with T the element type, in K7's cast order (not K2's):
//   s = (q k^T from the raw T values, fp32 sums) * scale in fp32, keys >= S
//   masked; m = rowmax(s); p = exp(s - m) / sum(exp(s - m)), normalised in
//   fp32; dv = T(p)^T dO; dp = dO v^T; delta = rowsum(dp * p) with the fp32
//   p and dp; ds = T(p (dp - delta)); dq = T((ds k) * scale);
//   dk = T((ds^T q) * scale) with the raw q; dv = T(dv).
// The forward hands over no stats and no o (the JAX VJPs save q, k and v
// alone), so delta is rowsum(dp * p), not K2's rowsum(dO * O). Every
// product is T x T into fp32, what wgmma computes, so every rounding point
// is the TPU kernel's. The scale multiplies the fp32 scores and the fp32 dq
// and dk by __fmul_rn, so the compiler cannot fold it into a neighbouring
// operation; p = exp2(s log2(e) - m log2(e)) and the division is div_rn
// (csrc/hopper.cuh), as in csrc/attn_fwd_tc.cu's K7 order. The fp32 version
// of the same function is csrc/hp_bwd.cu's CUDA-core loops: the TPU kernels
// round nothing in fp32, and a tensor-core product of fp32 operands (TF32)
// would.
//
// What bounds it on an H100: at B = 128, S = 197, H = 12, D = 64 the five
// products the function needs are 10 S^2 D per (b, h), 38.2 GFLOP in all,
// over 271 MB (q, k, v and dO read once, dq, dk and dv written once):
// 0.0809 ms at 3.35 TB/s against 0.039 ms at 989 TFLOP/s, so device memory
// bounds the ideal kernel. This design computes 20 S^2 D (s three times, dp
// twice and dq in the dq launch; s, dp, dv and dk in the dk/dv launch) and
// reads K and V once per query tile, mostly from L2. On rows this short the
// latency between the TMA loads, the products and the softmax between them
// sets the pace.
//
// Design: two launches, so that no sum crosses blocks and nothing takes a
// float atomic (the result is bitwise the same run to run):
// 1. dq and the row stats: one block per 64 queries of one (b, h), one
//    consumer warpgroup and a producer warp, holds its Q and dO rows (TMA,
//    once) and streams 64-key tiles through a 2-stage ring that the
//    producer fills. Three sweeps over the keys, the ring running through
//    all of them:
//    a. S = Q K^T (SS wgmma m64n64k16; K alone in the ring), scaled and
//       masked; the row max with an online sum of exp(s - m), rescaled by
//       exp(m_old - m_new) when the max moves, then combined across the
//       quad of lanes that shares a row (K7's order in attn_fwd_tc.cu);
//    b. S and dP = dO V^T (SS wgmma), p = div_rn(exp(s - m), sum) and
//       delta += dp p in fp32;
//    c. S and dP again, ds = T(p (dp - delta)) packed as the register A
//       fragment of dQ += ds K (RS wgmma, the same K tile read MN-major).
//    The epilogue stores T(dq * scale) and each row's [m, sum, delta] in
//    the (B, H, S, 3) fp32 scratch that the caller allocates. At D = 64
//    three blocks share an SM (128 registers, 49 KB of shared memory
//    each), so one block's loads, sweep a and epilogue overlap another's
//    products: in csrc/attn_bwd_tc.cu's shape, two warpgroups and 128
//    queries a block, one block an SM, this launch took 0.59 ms against
//    0.42 ms at B = 128, S = 197 (H100, tools/time_hp_bwd_variants.py,
//    PERF.md §6).
// 2. dk and dv (the shape of csrc/attn_bwd_tc.cu's dk/dv kernel): one block
//    holds 64 keys at D = 64 (one consumer warpgroup, two blocks an SM) or
//    128 at D = 128 (two, one block an SM), K and V by TMA, once, and
//    streams 64-query tiles of q and dO through a 3-stage ring, with each
//    query's [m log2(e), sum, RN(1 / sum), delta], which the producer's
//    lanes store beside them. Each consumer warpgroup owns 64 keys: S^T = K
//    q^T and dP^T = V dO^T on SS wgmma, both operands K-major as stored;
//    p^T with launch 1's scale, mask, exponent and division, so p is the
//    same function in both; dV += T(p)^T dO and dK += ds^T q on RS wgmma,
//    the same q and dO tiles read MN-major. The producer warpgroup lends
//    its registers to the consumers (setmaxnreg), as K2's does. The
//    epilogue stores T(dv) and T(dk scale).
// Rows >= S: TMA fills q, k, v and dO rows past S with zeros. Keys past S
// take p = 0 in both launches. A query row past S takes m = 0, sum = 1 and
// delta = 0 in launch 2: its p is 1 and its zero dO makes every term it
// adds 0, and finite.
// q, k, v (one layout) and dO (its own) are read in place through 4-D
// tensor maps (D, S, H, B) with the caller's element strides, in [64
// rows][64 columns] boxes; TMA needs 16-byte-aligned data and strides (D a
// multiple of 8), which the caller (ops/flash_attention.py::
// bwd_kernel_route) arranges, copying once where they are not. dq, dk and
// dv (one layout) are written as pairs of columns < D. Grids are
// one-dimensional over (b, h, row tile), so B and H are bound only by
// their product.
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

constexpr int kRows = 64;   // rows of a streamed tile and of a warpgroup
constexpr int kStages = 3;  // ring depth of the streamed tiles (dk/dv)
constexpr int kSweeps = 3;  // launch 1's passes over the keys
// The dq launch: kDqGroups consumer warpgroups of kRows queries each and a
// producer warp; an SM holds as many blocks as registers and shared memory
// allow (three at D = 64).
constexpr int kDqGroups = 1;
constexpr int kDqStages = 2;  // ring depth of the key tiles
constexpr int kDqRows = kDqGroups * kRows;
constexpr int kDqThreads = kDqGroups * 128 + 32;
constexpr int kProducerRegs = 40;  // the dk/dv producer warpgroup's
constexpr int kStreamPanel = kRows * kPanel;         // 8 KB
constexpr int kDqPanel = kDqRows * kPanel;
constexpr uint32_t kStreamBytes = kStreamPanel * 2;  // LBO of an MN-major tile
constexpr int kMaxSeq = 1024;
constexpr float kNegInf = -1e30f;  // the mask value of keys >= S

// Shared tiles of the dq launch; every panel is a multiple of 1024 bytes,
// so each stays aligned to the swizzle atom when the struct is.
template <typename T, int kD>
struct DqTiles {
  T q[kD / kPanel][kDqPanel];
  T dout[kD / kPanel][kDqPanel];
  T k[kDqStages][kD / kPanel][kStreamPanel];
  T v[kDqStages][kD / kPanel][kStreamPanel];
};

// The dk/dv launch at head dim kD: kGroups consumer warpgroups of kRows
// keys each and a producer warpgroup, kBlocks blocks an SM. It keeps four
// accumulators per consumer thread (S^T, dP^T, dK, dV: 128 floats at D =
// 64, 192 at D = 128): launched at kRegs registers a thread, the producer
// warpgroup drops to kProducerRegs and lends the rest to the consumers
// (kConsumerRegs). At D = 64 one group, two blocks an SM: 128 x 40 + 128 x
// 216 = 256 x 128. At D = 128 two groups, one block, as
// csrc/attn_bwd_tc.cu: 128 x 40 + 256 x 232 = 384 x 168 (one group there
// spills; PERF.md §6 has both).
template <int kD>
struct DkdvShape {
  static constexpr int kGroups = kD <= 64 ? 1 : 2;
  static constexpr int kBlocks = kD <= 64 ? 2 : 1;
  static constexpr int kKeys = kGroups * kRows;
  static constexpr int kThreads = kGroups * 128 + 128;
  static constexpr int kRegs = 65536 / (kThreads * kBlocks) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kThreads * kRegs - 128 * kProducerRegs) / (kGroups * 128) / 8 * 8;
  static_assert(kRegs <= 248 && kConsumerRegs <= 256,
                "setmaxnreg takes at most 256 registers a thread");
};

// Shared tiles of the dk/dv launch; st holds each streamed query's
// [m log2(e), sum, RN(1 / sum), delta].
template <typename T, int kD>
struct DkdvTiles {
  T k[kD / kPanel][DkdvShape<kD>::kKeys * kPanel];
  T v[kD / kPanel][DkdvShape<kD>::kKeys * kPanel];
  T q[kStages][kD / kPanel][kStreamPanel];
  T dout[kStages][kD / kPanel][kStreamPanel];
  float4 st[kStages][kRows];
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

// This warp is done with a stage.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// acc (+)= A B^T over kD / 16 steps of 16 columns: A warpgroup wg's 64 rows
// of a stationary tile (panels of kA elements), B a streamed [64][kD]
// tile, both K-major. Issued only: the caller fences, commits and waits.
template <typename T, int kD, int kA>
__device__ __forceinline__ void issue_ss(float (&acc)[32], T (*a)[kA],
                                         T (*b)[kStreamPanel], int wg) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int p = kk / 4, c = (kk % 4) * 16;
    wgmma_ss_n64<T>(acc, desc(&a[p][wg * kRows * kPanel + c], 16, 1024),
                    desc(&b[p][c], 16, 1024), kk > 0);
  }
}

// acc += A B over 4 steps of 16 rows of a streamed [64][kD] tile B read
// MN-major; A the packed register fragments of those rows.
template <typename T, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N],
                                         const uint32_t (&a)[4][4],
                                         T (*b)[kStreamPanel]) {
#pragma unroll
  for (int c = 0; c < kRows / 16; ++c)
    wgmma_rs<T>(acc, a[c], desc(&b[0][c * 16 * kPanel], kStreamBytes, 1024));
}

// p = exp(s scale - m) / sum of an unmasked fp32 score s, from ml = m
// log2(e) and y = RN(1 / sum): the same expression in both launches.
__device__ __forceinline__ float prob(float s, float scale, float ml,
                                      float sum, float y) {
  return div_rn(exp2f(fmaf(__fmul_rn(s, scale), kLog2e, -ml)), sum, y);
}

// S = Q K^T and dP = dO V^T of warpgroup wg's queries against the key tile
// of stage stg, then p = exp(s scale - m) / sum in s, 0 for keys >= S: kb
// is this thread's first key (the tile's first plus its column), ml0, l0,
// y0 and ml1, l1, y1 the stats of its two rows.
template <typename T, int kD>
__device__ __forceinline__ void probs(float (&s)[32], float (&dp)[32],
                                      DqTiles<T, kD>& t, int stg, int wg,
                                      int kb, int S, float scale, float ml0,
                                      float ml1, float l0, float l1,
                                      float y0, float y1) {
  pin(s);
  pin(dp);
  wg_fence();
  issue_ss<T, kD, kDqPanel>(s, t.q, t.k[stg], wg);
  issue_ss<T, kD, kDqPanel>(dp, t.dout, t.v[stg], wg);
  wg_commit();
  wg_wait();
  pin(s);
  pin(dp);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = kb + 8 * n + e < S;
      s[4 * n + e] = ok ? prob(s[4 * n + e], scale, ml0, l0, y0) : 0.f;
      s[4 * n + 2 + e] = ok ? prob(s[4 * n + 2 + e], scale, ml1, l1, y1)
                            : 0.f;
    }
  }
}

// Store T(acc * mul) (rows r0 and r0 + 8 of an m64 x kD accumulator) as
// pairs of rows < S and columns 8 n + col < D of one head.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long sr,
                                           const float (&acc)[N], int r0,
                                           int col, int S, int D, float mul) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int c = 8 * n + col;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dst + r0 * sr + c) = pack2<T>(
          __fmul_rn(acc[4 * n], mul), __fmul_rn(acc[4 * n + 1], mul));
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dst + r1 * sr + c) = pack2<T>(
          __fmul_rn(acc[4 * n + 2], mul), __fmul_rn(acc[4 * n + 3], mul));
  }
}

// 1. grid (n_t * B * H): block x is query tile x % n_t (kDqRows queries)
// of (b, h) = x / n_t.
// Accumulator fragments (wgmma m64nN, f32): thread t of a warpgroup, warp
// w = t / 32, lane l, holds d[4n + j] at row 16 w + l / 4 + 8 (j / 2),
// column 8 n + 2 (l % 4) + (j % 2). Rows are queries; columns of S and dP
// the tile's keys, of dQ the head dim. dq points at head 0 (layout gr);
// stats is (B, H, S, 3) fp32.
template <typename T, int kD>
__global__ void __launch_bounds__(kDqThreads, 1)
hp_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    T* __restrict__ dq, float* __restrict__ stats, int H,
                    int S, int D, int n_t, float scale, Layout gr) {
  constexpr int kPanels = kD / kPanel;
  constexpr uint32_t kTileBytes = kRows * kD * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kDqStages], empty[kDqStages];
  DqTiles<T, kD>& t = aligned_tiles<DqTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_t;
  const int q0 = (blockIdx.x % n_t) * kDqRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * kDqGroups);  // the consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kDqGroups) {
    // producer: Q and dO once, then the key tiles of the three sweeps
    // through the ring, K alone for the first, K and V for the others
    if (lane == 0) {
      bar_expect_tx(&q_full, 2 * kDqRows * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        for (int r = 0; r < kDqRows; r += kRows) {
          tma_load(&t.q[p][r * kPanel], &tq, &q_full, p * kPanel, q0 + r, h,
                   b);
          tma_load(&t.dout[p][r * kPanel], &tdo, &q_full, p * kPanel, q0 + r,
                   h, b);
        }
      for (int i = 0; i < kSweeps * n_kt; ++i) {
        const int s = i % kDqStages;
        const int k0 = (i % n_kt) * kRows;
        const bool with_v = i >= n_kt;
        if (i >= kDqStages) bar_wait(&empty[s], ((i / kDqStages) - 1) & 1);
        bar_expect_tx(&full[s], (with_v ? 2 : 1) * kTileBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(t.k[s][p], &tk, &full[s], p * kPanel, k0, h, b);
          if (with_v)
            tma_load(t.v[s][p], &tv, &full[s], p * kPanel, k0, h, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  const int r0 = q0 + wg * kRows + row, r1 = r0 + 8;
  float dq_acc[kD / 2];
  float s[32], dp[32];
  zero(dq_acc);
  zero(s);
  zero(dp);
  bar_wait(&q_full, 0);

  // a. the row max and the online sum of exp(s - m): this thread's part of
  // rows r0 and r1, over its columns of each key tile
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  int i = 0;  // the ring step, as the producer's
  for (int j = 0; j < n_kt; ++j, ++i) {
    const int stg = i % kDqStages;
    bar_wait(&full[stg], (i / kDqStages) & 1);
    pin(s);
    wg_fence();
    issue_ss<T, kD, kDqPanel>(s, t.q, t.k[stg], wg);
    wg_commit();
    wg_wait();
    pin(s);
    release(&empty[stg], lane);
    const int kb = j * kRows + col;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * n + e] = kb + 8 * n + (e & 1) < S
                           ? __fmul_rn(s[4 * n + e], scale)
                           : kNegInf;
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    const float ml0 = __fmul_rn(mx0, kLog2e), ml1 = __fmul_rn(mx1, kLog2e);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // masked keys add 0, also while this thread has seen no real key
        const bool ok = kb + 8 * n + e < S;
        a0 += ok ? exp2f(fmaf(s[4 * n + e], kLog2e, -ml0)) : 0.f;
        a1 += ok ? exp2f(fmaf(s[4 * n + 2 + e], kLog2e, -ml1)) : 0.f;
      }
    }
    l0 = fmaf(l0, exp2f((m0 - mx0) * kLog2e), a0);
    l1 = fmaf(l1, exp2f((m1 - mx1) * kLog2e), a1);
    m0 = mx0;
    m1 = mx1;
  }
  {
    // the quad's maxima, and its sums moved to them
    const float t0 = quad_max(m0), t1 = quad_max(m1);
    l0 = quad_sum(l0 * exp2f((m0 - t0) * kLog2e));
    l1 = quad_sum(l1 * exp2f((m1 - t1) * kLog2e));
    m0 = t0;
    m1 = t1;
  }
  const float ml0 = __fmul_rn(m0, kLog2e), ml1 = __fmul_rn(m1, kLog2e);
  const float y0 = __frcp_rn(l0), y1 = __frcp_rn(l1);

  // b. delta = rowsum(dp p), fp32
  float d0 = 0.f, d1 = 0.f;
  for (int j = 0; j < n_kt; ++j, ++i) {
    const int stg = i % kDqStages;
    bar_wait(&full[stg], (i / kDqStages) & 1);
    probs<T, kD>(s, dp, t, stg, wg, j * kRows + col, S, scale, ml0, ml1, l0,
                  l1, y0, y1);
    release(&empty[stg], lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      d0 = fmaf(dp[4 * n], s[4 * n], d0);
      d0 = fmaf(dp[4 * n + 1], s[4 * n + 1], d0);
      d1 = fmaf(dp[4 * n + 2], s[4 * n + 2], d1);
      d1 = fmaf(dp[4 * n + 3], s[4 * n + 3], d1);
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);

  // c. ds = T(p (dp - delta)) as the A fragments of dQ += ds K: keys 16 c ..
  // 16 c + 15 are registers (row, lo 8), (row + 8, lo 8), (row, hi 8),
  // (row + 8, hi 8)
  for (int j = 0; j < n_kt; ++j, ++i) {
    const int stg = i % kDqStages;
    bar_wait(&full[stg], (i / kDqStages) & 1);
    probs<T, kD>(s, dp, t, stg, wg, j * kRows + col, S, scale, ml0, ml1, l0,
                  l1, y0, y1);
    uint32_t ta[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      ta[n / 2][(n % 2) * 2] = pack2<T>(s[4 * n] * (dp[4 * n] - d0),
                                        s[4 * n + 1] * (dp[4 * n + 1] - d0));
      ta[n / 2][(n % 2) * 2 + 1] =
          pack2<T>(s[4 * n + 2] * (dp[4 * n + 2] - d1),
                   s[4 * n + 3] * (dp[4 * n + 3] - d1));
    }
    pin(dq_acc);
    wg_fence();
    issue_rs<T>(dq_acc, ta, t.k[stg]);
    wg_commit();
    wg_wait();
    pin(dq_acc);
    release(&empty[stg], lane);
  }

  store_rows(dq + b * gr.sb + h * gr.sh, gr.sr, dq_acc, r0, col, S, D,
             scale);
  if (lane % 4 == 0) {
    float* st = stats + (long long)bh * S * 3;
    if (r0 < S) {
      st[r0 * 3] = m0;
      st[r0 * 3 + 1] = l0;
      st[r0 * 3 + 2] = d0;
    }
    if (r1 < S) {
      st[r1 * 3] = m1;
      st[r1 * 3 + 1] = l1;
      st[r1 * 3 + 2] = d1;
    }
  }
}

// 2. grid (n_t * B * H): block x is key tile x % n_t (kKeys keys) of
// (b, h) = x / n_t.
// Fragments as launch 1's; rows are keys, columns of S^T and dP^T the
// tile's queries, of dK and dV the head dim. dk and dv point at head 0
// (layout gr).
template <typename T, int kD>
__global__ void __launch_bounds__(DkdvShape<kD>::kThreads,
                                  DkdvShape<kD>::kBlocks)
hp_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int S, int D, int n_t,
                      float scale, Layout gr) {
  constexpr int kPanels = kD / kPanel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  constexpr int kGroups = DkdvShape<kD>::kGroups;
  constexpr int kKeys = DkdvShape<kD>::kKeys;
  DkdvTiles<T, kD>& t = aligned_tiles<DkdvTiles<T, kD>>(smem_raw);

  const int bh = blockIdx.x / n_t;
  const int k0 = (blockIdx.x % n_t) * kKeys;
  const int b = bh / H, h = bh % H;
  const int n_qt = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);  // the producer warp's lanes
      bar_init(&empty[s], 4 * kGroups);  // the consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * kGroups) {
    // producer warpgroup: its registers go to the consumers; one warp
    // loads K and V once, then q and dO tiles through the ring, and every
    // lane of it stores two of the tile's query stats, then arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp != 4 * kGroups) return;
    if (lane == 0) {
      bar_expect_tx(&kv_full, 2 * kKeys * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        for (int r = 0; r < kKeys; r += kRows) {
          tma_load(&t.k[p][r * kPanel], &tk, &kv_full, p * kPanel, k0 + r, h,
                   b);
          tma_load(&t.v[p][r * kPanel], &tv, &kv_full, p * kPanel, k0 + r, h,
                   b);
        }
    }
    const float* rows = stats + (long long)bh * S * 3;
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages;
      const int q0 = j * kRows;
      if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
      for (int r = lane; r < kRows; r += 32) {
        if (q0 + r < S) {
          const float* st = rows + (q0 + r) * 3;
          t.st[s][r] = make_float4(__fmul_rn(st[0], kLog2e), st[1],
                                   __frcp_rn(st[1]), st[2]);
        } else {
          t.st[s][r] = make_float4(0.f, 1.f, 1.f, 0.f);
        }
      }
      if (lane == 0) {
        bar_expect_tx(&full[s], 2 * kRows * kD * 2);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(t.q[s][p], &tq, &full[s], p * kPanel, q0, h, b);
          tma_load(t.dout[s][p], &tdo, &full[s], p * kPanel, q0, h, b);
        }
      } else {
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      DkdvShape<kD>::kConsumerRegs));
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

    // S^T = K q^T and dP^T = V dO^T
    pin(s);
    pin(dp);
    wg_fence();
    issue_ss<T, kD, kKeys * kPanel>(s, t.k, t.q[stg], wg);
    issue_ss<T, kD, kKeys * kPanel>(dp, t.v, t.dout[stg], wg);
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // p^T and ds^T = p^T (dP^T - delta) in fp32, packed to T A fragments:
    // queries 16 c .. 16 c + 15 are registers (row, lo 8), (row + 8, lo 8),
    // (row, hi 8), (row + 8, hi 8)
    uint32_t pa[4][4], ta[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = 8 * n + col;
      const float4 c0 = t.st[stg][qc], c1 = t.st[stg][qc + 1];
      const float p0 = ok0 ? prob(s[4 * n], scale, c0.x, c0.y, c0.z) : 0.f;
      const float p1 =
          ok0 ? prob(s[4 * n + 1], scale, c1.x, c1.y, c1.z) : 0.f;
      const float p2 =
          ok1 ? prob(s[4 * n + 2], scale, c0.x, c0.y, c0.z) : 0.f;
      const float p3 =
          ok1 ? prob(s[4 * n + 3], scale, c1.x, c1.y, c1.z) : 0.f;
      pa[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
      ta[n / 2][(n % 2) * 2] =
          pack2<T>(p0 * (dp[4 * n] - c0.w), p1 * (dp[4 * n + 1] - c1.w));
      ta[n / 2][(n % 2) * 2 + 1] =
          pack2<T>(p2 * (dp[4 * n + 2] - c0.w), p3 * (dp[4 * n + 3] - c1.w));
    }

    // dV += T(p)^T dO, dK += ds^T q
    pin(dv_acc);
    pin(dk_acc);
    wg_fence();
    issue_rs<T>(dv_acc, pa, t.dout[stg]);
    issue_rs<T>(dk_acc, ta, t.q[stg]);
    wg_commit();
    wg_wait();
    pin(dv_acc);
    pin(dk_acc);
    release(&empty[stg], lane);
  }

  const long long g_off = b * gr.sb + h * gr.sh;
  store_rows(dv + g_off, gr.sr, dv_acc, key0, col, S, D, 1.f);
  store_rows(dk + g_off, gr.sr, dk_acc, key0, col, S, D, scale);
}

// Everything the host function hands the launches.
struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv, *stats;
  int B, H, S, D;
  float scale;
  Layout in, og, gr;
};

template <typename T, int kD>
int launch(const Args& a, cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  const CUtensorMapDataType type = map_type<T>();
  const int B = a.B, H = a.H, S = a.S, D = a.D;
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode(enc, &tq, a.q, B, H, S, D, a.in, kRows, type);
  if (!rc) rc = encode(enc, &tk, a.k, B, H, S, D, a.in, kRows, type);
  if (!rc) rc = encode(enc, &tv, a.v, B, H, S, D, a.in, kRows, type);
  if (!rc) rc = encode(enc, &tdo, a.dout, B, H, S, D, a.og, kRows, type);
  if (rc) return rc;
  // row tiles of a (b, h): of queries in the dq launch, of keys in dk/dv
  const int n_q = (S + kDqRows - 1) / kDqRows;
  const int n_k = (S + DkdvShape<kD>::kKeys - 1) / DkdvShape<kD>::kKeys;
  if ((long long)(n_q > n_k ? n_q : n_k) * B * H > INT_MAX)
    return (int)cudaErrorInvalidValue;

  const size_t dq_smem = sizeof(DqTiles<T, kD>) + 1024;  // + alignment
  rc = (int)cudaFuncSetAttribute(hp_bwd_tc_dq_kernel<T, kD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dq_smem);
  if (rc) return rc;
  hp_bwd_tc_dq_kernel<T, kD><<<dim3((unsigned)(n_q * B * H)), kDqThreads,
                                dq_smem, stream>>>(
      tq, tk, tv, tdo, static_cast<T*>(a.dq), static_cast<float*>(a.stats),
      H, S, D, n_q, a.scale, a.gr);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  const size_t dkdv_smem = sizeof(DkdvTiles<T, kD>) + 1024;
  rc = (int)cudaFuncSetAttribute(hp_bwd_tc_dkdv_kernel<T, kD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dkdv_smem);
  if (rc) return rc;
  hp_bwd_tc_dkdv_kernel<T, kD><<<dim3((unsigned)(n_k * B * H)),
                                  DkdvShape<kD>::kThreads, dkdv_smem,
                                  stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.stats),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), H, S, D, n_k, a.scale,
      a.gr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, cudaStream_t s) {
  return a.D <= 64 ? launch<T, 64>(a, s) : launch<T, 128>(a, s);
}

}  // namespace

extern "C" {

// dq, dk, dv (layout gr) of the element type `dtype` (elem.cuh's code: bf16
// or fp16; fp32 is csrc/hp_bwd.cu's) from q, k, v (layout in) and dout
// (layout og), all (B, H, S, D) given by base pointer and element strides;
// stats (B, H, S, 3) fp32 is scratch. 1 <= S <= 1024, D even and <= 128.
// Returns a cudaError_t as int (0 when both launches were accepted), or a
// code of vtx_cuda_error_string's own.
int vtx_hp_bwd_tc(const void* q, const void* k, const void* v,
                  long long in_sb, long long in_sh, long long in_sr,
                  const void* dout, long long og_sb, long long og_sh,
                  long long og_sr, void* dq, void* dk, void* dv,
                  long long gr_sb, long long gr_sh, long long gr_sr,
                  void* stats, int B, int H, int S, int D, float scale,
                  int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > kMaxSeq || D < 2 || (D & 1) ||
      D > 128)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q, a.k = k, a.v = v, a.dout = dout;
  a.dq = dq, a.dk = dk, a.dv = dv, a.stats = stats;
  a.B = B, a.H = H, a.S = S, a.D = D, a.scale = scale;
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

// The dynamic shared memory of the dq launch (dq == 1) or the dk/dv launch
// (dq == 0) at head dim D, in bytes (the same for bf16 and fp16).
int vtx_hp_bwd_tc_smem(int D, int dq) {
  const size_t tiles =
      dq ? (D <= 64 ? sizeof(DqTiles<bf16, 64>) : sizeof(DqTiles<bf16, 128>))
         : (D <= 64 ? sizeof(DkdvTiles<bf16, 64>)
                    : sizeof(DkdvTiles<bf16, 128>));
  return (int)tiles + 1024;
}

const char* vtx_cuda_error_string(int err) { return error_string(err); }

}  // extern "C"
