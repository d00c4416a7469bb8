// Softmax attention forward on Hopper's tensor cores, in bf16 and fp16, in
// two cast orders: K1's over a fused (B, S, 3*H*D) qkv buffer, and K7's
// over (B, H, S, D) q, k and v given by strides.
//
// Replaces these TPU kernels of
// vision_transformers_torch_xla_tpu/ops/flash_attention.py, T the element
// type, per (b, h):
// * K1's order (kK7 false): ::_hp_fwd_stats_kernel (:291, ROADMAP K1) and,
//   with the stats pointer null, ::_hp_fwd_kernel (:171, K9), which
//   computes the same o:
//     q^ = T(q * scale); s = q^ k^T in fp32 over the S real keys;
//     m = rowmax(s) over the whole row; p = exp(s - m);
//     rinv = 1 / sum(fp32 p); o = T((T(p) v, fp32 sums) * rinv) at
//     (B, S, H*D); optionally st = (B, H, S, 2) fp32 holding [m, rinv].
// * K7's order (kK7 true): ::_fwd_kernel (:36, K7) on (B*H, Sp, Dp) and
//   ::_qkv_fwd_kernel (:740, K11) on a (B, Sp, 3H, D) buffer, one function
//   over two layouts:
//     s = (q k^T from the raw T values, fp32 sums) * scale in fp32 over the
//     S real keys; m = rowmax(s); p = exp(s - m) / sum(exp(s - m)),
//     normalised in fp32; o = T(T(p) v with fp32 sums); no stats.
// Both products are T x T into fp32, what wgmma computes, so each order
// rounds where its TPU kernel rounds:
// * K1 rounds q^ before the product: the consumers scale and round the Q
//   tile in shared memory after the TMA lands, before the first wgmma (at
//   D = 128 the scale is not a power of two, so scaling the fp32 product,
//   as csrc/flash_fwd.cu does, would be another function). K7 rounds
//   nothing before the product: Q goes from the TMA straight into the first
//   wgmma, and the scale multiplies the fp32 scores (__fmul_rn, so the
//   compiler cannot fold it into the exponent).
// * Both softmaxes are two-pass, not online in p: p is rounded to T at the
//   row's final max, as the TPU kernels, which hold the whole row, round it.
//   With one key tile (S <= 128) the scores stay in registers; with more, a
//   first pass over the key tiles takes the row max, and a second pass
//   computes s again, p and p v.
// * K1 rounds p before it is normalised: the p pass sums fp32 p, and o is
//   scaled by 1 / sum after the product. K7 rounds p after it is
//   normalised, so its sum must be known before p v: with one key tile the
//   p pass takes p, then the sum, then p / sum; with more, the max pass also
//   keeps an online row sum, rescaled by exp(m_old - m_new) when the max
//   moves, and the p pass divides by it, as the TPU kernel divides. The
//   online sum, chosen over a third pass (max, sum, p v) because it keeps
//   the producer's two-pass schedule, differs from the exact sum by a few
//   fp32 ulps of rounding in each term's rescaling, far below the 2^-9
//   (bf16) and 2^-12 (fp16) of p's rounding to T.
// * The division is correctly rounded without __fdiv_rn (div_rn, in
//   csrc/hopper.cuh since csrc/hp_bwd_tc.cu shares it): y = RN(1 / sum)
//   once per row, then q = RN(p y) and two of Markstein's corrections q +=
//   (p - sum q) y, each remainder exact by the FMA. That is the fast path
//   of the IEEE division, and it gives RN(p / sum) wherever p >= 2^-102;
//   below that a remainder can be subnormal and the quotient one fp32 ulp
//   off, which moves o by less than 2^-102 |v|. __fdiv_rn's check for its
//   slow path branches around every quotient, and so split the unrolled
//   loop: at B = 128, S = 197 the kernel took 0.40 ms with it and 0.24 ms
//   with this (H100, tools/time_fused_fwd_variants.py, PERF.md §6).
// * p = exp2(s log2(e) - m log2(e)): the folded product moves the exponent
//   by |m| log2(e) 2^-24 absolute at most (|m| < ~50 here), so p moves by a
//   relative ~1e-6 with exp2f's 2 ulp, far below p's rounding to T. m is
//   stored in natural units, as computed.
// The fp32 versions of both functions are CUDA-core loops, csrc/attn_fwd.cu
// (K1, K9) and csrc/fused_attn_fwd.cu (K7, K11): the TPU kernels round
// nothing in fp32, and every tensor-core product of fp32 operands (TF32)
// would.
//
// What bounds it on an H100: at ViT-B shapes (S = 197, D = 64) one (b, h)
// is 4 S^2 D = 9.9 MFLOP over 2 S 4 D = 0.1 MB, ~100 FLOP per byte,
// below the ~295 of the ridge: device memory bounds the work (at B = 128,
// 12 heads, 0.0462 ms for qkv read once and o written once). At these short
// rows the tiles are small and latency (TMA, wgmma, the softmax between
// them) sets the pace; two warpgroups per block interleave. K7's order
// issues more instructions per score than K1's (the scale, the online sum's
// exponentials in the max pass, a division per p), all on the CUDA cores
// between the products.
//
// Design (warp-specialised, as csrc/flash_fwd.cu, one block of 288 threads
// per 128 query rows of one (b, h), a one-dimensional grid, the same in
// both orders):
// * a producer warp starts TMA loads: the block's Q tile once, then key
//   tiles of 128 rows through a 2-stage ring: K alone for the first pass,
//   K and V for the second (with one tile, K and V once);
// * two consumer warpgroups own 64 query rows each. S = Q K^T is wgmma
//   m64n128k16 with both operands in 128-byte-swizzled shared memory,
//   K-major. Keys >= S are masked to -1e30 after the product (a zero key
//   scores 0, not -inf). P is packed to T in registers and is the register
//   A operand of wgmma for O += P V, V an MN-major B operand.
// * q, k and v are read in place through 4-D tensor maps (D, S, H, B) with
//   one set of the caller's element strides: for K1 views of the (B, S, 3 H
//   D) projection at columns h D, H D + h D and 2 H D + h D; for K7 three
//   (B, H, S, D) tensors of one layout, separate or views of one qkv
//   buffer. TMA needs 16-byte-aligned data and strides (D a multiple of 8),
//   which the caller (ops/flash_attention.py) arranges, copying once where
//   they are not. TMA fills rows >= S and columns >= D with zeros. o is
//   written in the caller's output layout (pairs, columns < D, rows < S).
//
// Plain C interface, loaded with ctypes. The kernel allocates nothing and
// launches on the caller's stream; the host function returns
// cudaGetLastError(), or a code >= kErrEncodeBase when a tensor map could
// not be encoded (vtx_cuda_error_string says which).

#include <limits.h>

#include "elem.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;          // query rows of a block
constexpr int kBlockN = 128;          // keys of a tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kMaxSeq = 1024;
constexpr float kNegInf = -1e30f;     // the mask value of keys >= S

// One block's shared tiles, each kD / 64 panels of [rows][64] in the TMA's
// 128-byte swizzle; every panel is 16 KB, so each stays 1024-byte aligned.
template <typename T, int kD>
struct Tiles {
  T q[kD / kPanel][kBlockM * kPanel];
  T k[kStages][kD / kPanel][kBlockN * kPanel];
  T v[kStages][kD / kPanel][kBlockN * kPanel];
};

// n elements at p (16-byte aligned, n a multiple of 8 x 128) replaced by
// T(x * scale), 128 threads, thread tid.
template <typename T>
__device__ __forceinline__ void round_scaled(T* p, int n, float scale,
                                             int tid) {
  typedef Elem<T> E;
  for (int i = tid * 8; i < n; i += 128 * 8) {
    uint4 w = *reinterpret_cast<uint4*>(p + i);
    typename E::Pair* e = reinterpret_cast<typename E::Pair*>(&w);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = E::load2(e[u]);
      e[u] = E::store2(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(p + i) = w;
  }
}

// s = Q K^T (K1: Q^ K^T) of warpgroup wg's 64 rows against the key tile of
// stage st.
template <typename T, int kD>
__device__ __forceinline__ void scores(float (&s)[64], const Tiles<T, kD>& t,
                                       int wg, int st) {
  pin(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int p = kk / 4, c = (kk % 4) * 16;
    wgmma_ss_n128<T>(s, desc(&t.q[p][wg * 64 * kPanel + c], 16, 1024),
                     desc(&t.k[st][p][c], 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait();
  pin(s);
}

// Keys >= S of the tile at k0 set to kNegInf; mx0 and mx1 take this
// thread's maxima of rows row and row + 8.
__device__ __forceinline__ void mask_max(float (&s)[64], int k0, int col,
                                         int S, float& mx0, float& mx1) {
  const bool ragged = k0 + kBlockN > S;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ragged && k0 + 8 * n + col + (e & 1) >= S) s[4 * n + e] = kNegInf;
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
}

// K7's order: the fp32 scores times the scale, rounded once.
__device__ __forceinline__ void scale_scores(float (&s)[64], float scale) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], scale);
}

// K7's max pass over one masked tile: this thread's sums l0, l1 of exp(s -
// m) over its columns of rows row and row + 8, kept at its running maxima
// m0, m1, move to the tile's new maxima mx0, mx1 (rescaled by exp(m_old -
// m_new)) and take the tile's terms.
__device__ __forceinline__ void online_sum(const float (&s)[64], float mx0,
                                           float mx1, float& m0, float& m1,
                                           float& l0, float& l1) {
  const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    a0 += exp2f(fmaf(s[4 * n], kLog2e, -ml0)) +
          exp2f(fmaf(s[4 * n + 1], kLog2e, -ml0));
    a1 += exp2f(fmaf(s[4 * n + 2], kLog2e, -ml1)) +
          exp2f(fmaf(s[4 * n + 3], kLog2e, -ml1));
  }
  l0 = fmaf(l0, exp2f((m0 - mx0) * kLog2e), a0);
  l1 = fmaf(l1, exp2f((m1 - mx1) * kLog2e), a1);
  m0 = mx0;
  m1 = mx1;
}

// This warp is done with stage st.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// grid (ceil(S / kBlockM) * B * H): block x is query tile x % n_qt of
// (b, h) = x / n_qt. Accumulator fragments (wgmma m64nN, f32): thread t of
// a warpgroup, warp w = t / 32, lane l, holds d[4n + j] at row 16 w + l / 4
// + 8 (j / 2), column 8 n + 2 (l % 4) + (j % 2). kK7 picks the cast order
// (the header): K7's (K7, K11) or K1's (K1, K9).
template <typename T, int kD, bool kK7>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   T* __restrict__ o, float* __restrict__ st, int H, int S,
                   int D, int n_qt, float scale, Layout out) {
  constexpr int kPanels = kD / kPanel;
  constexpr uint32_t kTileBytes = kBlockN * kD * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the swizzle atom is 1024 bytes: align the tiles to it
  Tiles<T, kD>& t = *reinterpret_cast<Tiles<T, kD>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockM;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kBlockN - 1) / kBlockN;
  // one pass over a single key tile; else the max pass, then the p pass
  const int n_steps = n_kt == 1 ? 1 : 2 * n_kt;
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
    // producer: Q once, then the key tiles of both passes through the
    // ring; the last n_kt steps (the p pass) bring V with K
    if (lane == 0) {
      bar_expect_tx(&q_full, kBlockM * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        tma_load(t.q[p], &tq, &q_full, p * kPanel, q0, h, b);
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kStages;
        const int k0 = (i % n_kt) * kBlockN;
        const bool with_v = i >= n_steps - n_kt;
        if (i >= kStages) bar_wait(&empty[s], ((i / kStages) - 1) & 1);
        bar_expect_tx(&full[s], (with_v ? 2 : 1) * kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.k[s][p], &tk, &full[s], p * kPanel, k0, h, b);
        if (with_v)
          for (int p = 0; p < kPanels; ++p)
            tma_load(t.v[s][p], &tv, &full[s], p * kPanel, k0, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);

  bar_wait(&q_full, 0);
  if constexpr (!kK7) {
    // q^ = T(q * scale) in place, the warpgroup's own rows, before any
    // wgmma reads them (the async proxy sees the writes after the fence)
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      round_scaled(&t.q[p][wg * 64 * kPanel], 64 * kPanel, scale,
                   threadIdx.x % 128);
    fence_proxy_async();
    if (wg == 0)  // constant barrier ids: ptxas reserves only those
      named_barrier(1, 128);
    else
      named_barrier(2, 128);
  }

  float acc[kD / 2];
  float s[64];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // the row maxima of rows row, row + 8
  // K1: this thread's part of the row sums, taken in the p pass; K7: the
  // row sums, which the max pass takes when there is more than one tile
  float l0 = 0.f, l1 = 0.f;
  int i = 0;                         // the ring step, as the producer's
  if (n_kt > 1) {
    // the max pass (K7: with the online row sums)
    for (int j = 0; j < n_kt; ++j, ++i) {
      const int stg = i % kStages;
      bar_wait(&full[stg], (i / kStages) & 1);
      scores(s, t, wg, stg);
      release(&empty[stg], lane);
      if constexpr (kK7) {
        scale_scores(s, scale);
        float mx0 = m0, mx1 = m1;
        mask_max(s, j * kBlockN, col, S, mx0, mx1);
        online_sum(s, mx0, mx1, m0, m1, l0, l1);
      } else {
        mask_max(s, j * kBlockN, col, S, m0, m1);
      }
    }
    if constexpr (kK7) {
      // the quad's maxima, and its sums moved to them
      const float t0 = quad_max(m0), t1 = quad_max(m1);
      l0 = quad_sum(l0 * exp2f((m0 - t0) * kLog2e));
      l1 = quad_sum(l1 * exp2f((m1 - t1) * kLog2e));
      m0 = t0;
      m1 = t1;
    } else {
      m0 = quad_max(m0);
      m1 = quad_max(m1);
    }
  }

  // the p pass: p = exp(s - m) in fp32; K1: p into the row sums, T(p) into
  // the A fragments of acc += T(p) v; K7: T(p / sum) into them
  for (int j = 0; j < n_kt; ++j, ++i) {
    const int stg = i % kStages;
    bar_wait(&full[stg], (i / kStages) & 1);
    scores(s, t, wg, stg);
    if constexpr (kK7) scale_scores(s, scale);
    float mx0 = kNegInf, mx1 = kNegInf;
    mask_max(s, j * kBlockN, col, S, mx0, mx1);
    if (n_kt == 1) {
      m0 = quad_max(mx0);
      m1 = quad_max(mx1);
    }
    const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
    // keys 16 c .. 16 c + 15: registers (row, lo 8), (row + 8, lo 8),
    // (row, hi 8), (row + 8, hi 8)
    uint32_t pa[8][4];
    if constexpr (kK7) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        s[4 * n] = exp2f(fmaf(s[4 * n], kLog2e, -ml0));
        s[4 * n + 1] = exp2f(fmaf(s[4 * n + 1], kLog2e, -ml0));
        s[4 * n + 2] = exp2f(fmaf(s[4 * n + 2], kLog2e, -ml1));
        s[4 * n + 3] = exp2f(fmaf(s[4 * n + 3], kLog2e, -ml1));
        a0 += s[4 * n] + s[4 * n + 1];
        a1 += s[4 * n + 2] + s[4 * n + 3];
      }
      if (n_kt == 1) {  // the whole row is in registers: its sums
        l0 = quad_sum(a0);
        l1 = quad_sum(a1);
      }
      const float y0 = __frcp_rn(l0), y1 = __frcp_rn(l1);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        pa[n / 2][(n % 2) * 2] = pack2<T>(div_rn(s[4 * n], l0, y0),
                                          div_rn(s[4 * n + 1], l0, y0));
        pa[n / 2][(n % 2) * 2 + 1] = pack2<T>(div_rn(s[4 * n + 2], l1, y1),
                                              div_rn(s[4 * n + 3], l1, y1));
      }
    } else {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float p0 = exp2f(fmaf(s[4 * n], kLog2e, -ml0));
        const float p1 = exp2f(fmaf(s[4 * n + 1], kLog2e, -ml0));
        const float p2 = exp2f(fmaf(s[4 * n + 2], kLog2e, -ml1));
        const float p3 = exp2f(fmaf(s[4 * n + 3], kLog2e, -ml1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
        pa[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
      }
    }
    pin(acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kBlockN / 16; ++c)
      wgmma_rs<T>(acc, pa[c], desc(&t.v[stg][0][c * 16 * kPanel],
                                   kBlockN * kPanel * 2, 1024));
    wg_commit();
    wg_wait();
    pin(acc);
    release(&empty[stg], lane);
  }

  // K1: o = T(acc * rinv), st = [m, rinv]; K7: o = T(acc), p was normalised
  float rinv0 = 1.f, rinv1 = 1.f;
  const int r0 = q0 + wg * 64 + row, r1 = r0 + 8;
  if constexpr (!kK7) {
    rinv0 = 1.f / quad_sum(l0);
    rinv1 = 1.f / quad_sum(l1);
    if (st != nullptr && lane % 4 == 0) {
      float2* sp = reinterpret_cast<float2*>(st) + (long long)bh * S;
      if (r0 < S) sp[r0] = make_float2(m0, rinv0);
      if (r1 < S) sp[r1] = make_float2(m1, rinv1);
    }
  }
  T* ob = o + b * out.sb + h * out.sh;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + col;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * out.sr + c) =
          pack2<T>(acc[4 * n] * rinv0, acc[4 * n + 1] * rinv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * out.sr + c) =
          pack2<T>(acc[4 * n + 2] * rinv1, acc[4 * n + 3] * rinv1);
  }
}

template <typename T, int kD, bool kK7>
int fwd(const void* q, const void* k, const void* v, void* o, void* st,
        int B, int H, int S, int D, float scale, Layout in, Layout out,
        cudaStream_t stream) {
  static_assert(kBlockM == kBlockN, "one box shape serves Q, K and V");
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType type = map_type<T>();
  int rc = encode(enc, &tq, q, B, H, S, D, in, kBlockN, type);
  if (!rc) rc = encode(enc, &tk, k, B, H, S, D, in, kBlockN, type);
  if (!rc) rc = encode(enc, &tv, v, B, H, S, D, in, kBlockN, type);
  if (rc) return rc;
  const size_t smem = sizeof(Tiles<T, kD>) + 1024;  // + the alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_tc_kernel<T, kD, kK7>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  attn_fwd_tc_kernel<T, kD, kK7><<<dim3((unsigned)blocks), kThreads, smem,
                                   stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(st), H, S, D, n_qt,
      scale, out);
  return (int)cudaGetLastError();
}

template <typename T, bool kK7>
int fwd_d(const void* q, const void* k, const void* v, void* o, void* st,
          int B, int H, int S, int D, float scale, Layout in, Layout out,
          cudaStream_t s) {
  if (D <= 64)
    return fwd<T, 64, kK7>(q, k, v, o, st, B, H, S, D, scale, in, out, s);
  return fwd<T, 128, kK7>(q, k, v, o, st, B, H, S, D, scale, in, out, s);
}

// The launch of cast order kK7 at the element type `dtype`, after the
// contract's checks.
template <bool kK7>
int launch(const void* q, const void* k, const void* v, void* o, void* st,
           int B, int H, int S, int D, float scale, Layout in, Layout out,
           int dtype, cudaStream_t s) {
  if (B < 1 || H < 1 || S < 1 || S > kMaxSeq || D < 2 || (D & 1) ||
      D > 128)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kBf16:
      return fwd_d<bf16, kK7>(q, k, v, o, st, B, H, S, D, scale, in, out, s);
    case kF16:
      return fwd_d<f16, kK7>(q, k, v, o, st, B, H, S, D, scale, in, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1's order: o (out layout) and, when st is not null, the (B, H, S, 2)
// fp32 row stats from q, k, v (in layout), all of the element type `dtype`
// (elem.cuh's code: bf16 or fp16; fp32 is csrc/attn_fwd.cu's). 1 <= S <=
// 1024, D even and <= 128. Returns a cudaError_t as int (0 on a launch that
// was accepted), or a code of vtx_cuda_error_string's own when a tensor map
// could not be made.
int vtx_attn_fwd_tc(const void* q, const void* k, const void* v, void* o,
                    void* st, int B, int H, int S, int D, float scale,
                    long long in_sb, long long in_sh, long long in_sr,
                    long long out_sb, long long out_sh, long long out_sr,
                    int dtype, void* stream) {
  return launch<false>(q, k, v, o, st, B, H, S, D, scale,
                       Layout{in_sb, in_sh, in_sr},
                       Layout{out_sb, out_sh, out_sr}, dtype,
                       static_cast<cudaStream_t>(stream));
}

// K7's order (K7, K11): o (out layout) from q, k, v (in layout), no stats;
// the rest as vtx_attn_fwd_tc (fp32 is csrc/fused_attn_fwd.cu's).
int vtx_fused_attn_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int S, int D, float scale,
                          long long in_sb, long long in_sh, long long in_sr,
                          long long out_sb, long long out_sh,
                          long long out_sr, int dtype, void* stream) {
  return launch<true>(q, k, v, o, nullptr, B, H, S, D, scale,
                      Layout{in_sb, in_sh, in_sr},
                      Layout{out_sb, out_sh, out_sr}, dtype,
                      static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a launch at head dim D, in bytes (the same
// for bf16 and fp16, and in both cast orders).
int vtx_attn_fwd_tc_smem(int D) {
  return (int)(D <= 64 ? sizeof(Tiles<bf16, 64>) : sizeof(Tiles<bf16, 128>)) +
         1024;
}

const char* vtx_cuda_error_string(int err) { return error_string(err); }

}  // extern "C"
