// Blocked flash attention forward (online softmax) on Hopper's tensor cores,
// in bf16 and fp16.
//
// Replaces the TPU kernel vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py::_fwd_kernel (:33, ROADMAP K4), the forward of the
// long-sequence path (S > 1024). T is the element type (bf16 or fp16). Per
// query row, over key tiles, a running max m, sum l and fp32 accumulator
// acc:
//   s = (q k^T) * scale in fp32 (T x T products, fp32 sums), keys >= S
//   masked to -1e30; m' = max(m, rowmax s); alpha = exp(m - m');
//   p = exp(s - m'); l = l alpha + sum(fp32 p); acc = acc alpha + T(p) v;
// then o = T(acc / max(l, 1e-30)) and lse = m + log(max(l, 1e-30)).
// Both products are T x T into fp32, what wgmma computes, so the cast
// order is the TPU kernel's. The scale is applied to the fp32 product, never
// to a rounded q (at D = 128, 1/sqrt(128) is not a power of two). The
// exponentials run as exp2f with log2(e) folded into the scale: s2 = s *
// (scale * log2 e), p = exp2f(s2 - m2). Against expf of the natural-units
// score that moves p by a relative ~1e-6 (the rounding of the folded
// constant and of s2, |s2| < ~30, plus exp2f's 2 ulp), far below the 2^-9
// (bf16) and 2^-12 (fp16) of p's rounding to T; lse = m2 ln 2 + log(l)
// moves by the same ~1e-6. The fp32 version is csrc/flash_fwd_simt.cu's
// (the tensor cores have no fp32 product that rounds nothing); head dims
// over 256 run on csrc/flash_blocked.cu in every dtype.
//
// What bounds it on an H100: at S = 1370, D = 64 one (b, h) is 4 S^2 D =
// 0.48 GFLOP over < 1 MB of operands, hundreds of FLOP per byte: the
// products bound it. At B = 32, 12 heads the least time at the H100 SXM's
// 989 TFLOP/s bf16 and fp16 peak is 0.187 ms; the S^2 exponentials (7.2e8
// a call) on the special-function units are a second floor of about the
// same size. At D = 256 the products grow 4x per score, the exponentials
// not at all.
//
// Design (warp-specialised, one block per 128 query rows of one (b, h)):
// * a producer starts TMA loads: the block's Q tile once, then K and V
//   tiles of kN keys through a 2-stage ring in shared memory, with full
//   (TMA bytes arrived) and empty (both consumers done) mbarriers;
// * two consumer warpgroups own 64 query rows each. S = Q K^T is wgmma
//   m64nNk16 (N = kN) with both operands in 128-byte-swizzled shared
//   memory, K-major (q and k rows are D-contiguous). The online softmax
//   runs in registers on the accumulator fragments, with quad shuffles for
//   the row max; each thread keeps a partial row sum, reduced once at the
//   end. P is packed to T in registers and is the register A operand of
//   wgmma for O += P V; V is read from shared memory as an MN-major B
//   operand (the transpose bit that 16-bit types allow). The two
//   warpgroups' softmax and products interleave on the SM.
// * The head dim is 64, 128, 192 or 256 at compile time (a smaller one
//   takes the next, its columns zero-filled by TMA). Up to 128 the key
//   tiles have kN = 128 rows, Q shares their TMA box, and the producer is
//   one warp (288 threads). At 192 and 256 (the wide tiles,
//   csrc/attn_fwd_tc.cu's) they have kN = 64, so that Q (128 rows, a box
//   of its own) and the 2-stage K and V ring fit a block: at 256, 64 + 2 x
//   (32 + 32) = 192 KB of the 227 KB (at 256 with 128-key tiles they would
//   need 320 KB). A consumer thread then holds the o accumulator, 64 x D
//   fp32 over its warpgroup (128 registers at 256), the 64 x 64 scores
//   (32) and the P fragments (16): more than the 168 a block of 288
//   threads gets. So the wide tiles' producer is a warpgroup (384 threads)
//   that keeps 40 registers a thread and lends the rest to the consumers,
//   232 each (setmaxnreg). O += P V runs as m64n128 products over pairs of
//   64-column panels of V (and one m64n64 for the odd panel at 192).
// * Operand tiles are panels of 64 columns (one 128-byte swizzle row) by the
//   tile's rows; D = 128 is two panels. TMA fills rows >= S and columns >= D
//   with zeros. Keys >= S are still masked: a zero key scores 0, not -inf.
// * q, k and v are read in place through 4-D tensor maps (D, S, H, B) with
//   the caller's element strides, so views of a fused (B, S, 3 H D)
//   projection need no copy; TMA needs 16-byte-aligned strides and data,
//   which the caller (ops/flash_blocked.py) checks. o is written by the
//   consumers in the caller's output layout, lse as (B, H, S) fp32.
// * The grid is one-dimensional over (b h, query tile), so B H is bounded
//   only by 2^31 / ceil(S / 128).
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library links no -lcuda. The
// barriers, TMA and wgmma helpers are csrc/hopper.cuh's, shared with the
// backward (csrc/flash_bwd.cu).
//
// Plain C interface, loaded with ctypes. The kernel allocates nothing and
// launches on the caller's stream; the host function returns
// cudaGetLastError(), or a code >= kErrEncodeBase when a tensor map could
// not be encoded (vtx_cuda_error_string says which). The caller checks the
// shapes: 1 <= D <= 256, D a multiple of 8.

#include <limits.h>

#include "elem.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;          // query rows of a block
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kProducerRegs = 40;       // the wide tiles' producer warpgroup
constexpr int kWideConsumerRegs = 232;  // and its consumers: 128 x 40 +
                                        // 256 x 232 = 384 x 168
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value

// The keys of a tile at head dim kD: 128 up to 128, 64 for the wide tiles.
template <int kD>
__host__ __device__ constexpr int key_tile() {
  return kD <= 128 ? 128 : 64;
}

// The threads of a block: two consumer warpgroups and a producer warp; for
// the wide tiles a producer warpgroup, which lends its registers to the
// consumers.
template <int kD>
__host__ __device__ constexpr int block_threads() {
  return kD <= 128 ? kThreads : kThreads + 96;
}

// One block's shared tiles, each kD / 64 panels of [rows][64] T in the
// TMA's 128-byte swizzle. Every panel is 8 or 16 KB, so each stays
// 1024-byte aligned (the swizzle atom) when the struct is.
template <typename T, int kD>
struct Tiles {
  static constexpr int kN = key_tile<kD>();
  T q[kD / kPanel][kBlockM * kPanel];
  T k[kStages][kD / kPanel][kN * kPanel];
  T v[kStages][kD / kPanel][kN * kPanel];
};

static_assert(sizeof(Tiles<bf16, 256>) + 1024 <= 227 * 1024,
              "the widest tiles fit a block's 227 KB");

// acc += P V for keys 16 c .. 16 c + 15 of the V tile at v (kD / 64 panels
// of kN rows), P the packed A fragment a: up to 128 one m64nD product, the
// wide tiles m64n128 over pairs of panels (and m64n64 for an odd one).
template <typename T, int kD, int kN>
__device__ __forceinline__ void pv(float (&acc)[kD / 2],
                                   const uint32_t (&a)[4], const T* v, int c) {
  constexpr uint32_t kLbo = kN * kPanel * 2;  // bytes between V's panels
  if constexpr (kD <= 128) {
    wgmma_rs<T>(acc, a, desc(v + c * 16 * kPanel, kLbo, 1024));
  } else {
#pragma unroll
    for (int p = 0; p + 2 <= kD / kPanel; p += 2)
      wgmma_rs<T>(*reinterpret_cast<float(*)[64]>(&acc[32 * p]), a,
                  desc(v + p * kN * kPanel + c * 16 * kPanel, kLbo, 1024));
    if constexpr ((kD / kPanel) % 2) {
      constexpr int p = kD / kPanel - 1;
      wgmma_rs<T>(*reinterpret_cast<float(*)[32]>(&acc[32 * p]), a,
                  desc(v + p * kN * kPanel + c * 16 * kPanel, kLbo, 1024));
    }
  }
}

// grid (ceil(S / kBlockM) * B * H): block x is query tile x % n_qt of
// (b, h) = x / n_qt. Accumulator fragments (wgmma m64nN, f32): thread t of
// a warpgroup, warp w = t / 32, lane l, holds d[4n + j] at row 16 w + l / 4
// + 8 (j / 2), column 8 n + 2 (l % 4) + (j % 2).
template <typename T, int kD>
__global__ void __launch_bounds__(block_threads<kD>(), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 T* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int D, int n_qt, float scale_log2, Layout out) {
  constexpr int kPanels = kD / kPanel;
  constexpr int kN = key_tile<kD>();            // keys of a tile
  constexpr int kTileBytes = kN * kD * 2;       // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // the swizzle atom is 1024 bytes: align the tiles to it
  Tiles<T, kD>& t = *reinterpret_cast<Tiles<T, kD>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockM;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kN - 1) / kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (kD > 128 ? warp >= kConsumerWarps : warp == kConsumerWarps) {
    // producer: Q once, then K and V tiles through the ring. The wide
    // tiles' producer warpgroup first gives its registers away, and one
    // warp of it loads.
    if constexpr (kD > 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
      if (warp != kConsumerWarps) return;
    }
    if (lane == 0) {
      bar_expect_tx(&q_full, kBlockM * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        tma_load(t.q[p], &tq, &q_full, p * kPanel, q0, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
        bar_expect_tx(&k_full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.k[s][p], &tk, &k_full[s], p * kPanel, j * kN, h, b);
        bar_expect_tx(&v_full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.v[s][p], &tv, &v_full[s], p * kPanel, j * kN, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  if constexpr (kD > 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kWideConsumerRegs));
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  float acc[kD / 2];
  float s[kN / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of s2, rows row, row + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums

  bar_wait(&q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const int k0 = j * kN;

    // s = q k^T over kD / 16 steps of 16 columns
    bar_wait(&k_full[st], phase);
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      if constexpr (kN == 128)
        wgmma_ss_n128<T>(s, desc(&t.q[p][wg * 64 * kPanel + c], 16, 1024),
                         desc(&t.k[st][p][c], 16, 1024), kk > 0);
      else
        wgmma_ss_n64<T>(s, desc(&t.q[p][wg * 64 * kPanel + c], 16, 1024),
                        desc(&t.k[st][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);

    // scale to log2 units, mask keys >= S, new row maxima
    float mx0 = kNegInf, mx1 = kNegInf;
    const bool ragged = k0 + kN > S;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (ragged && k0 + 8 * n + col + (e & 1) >= S) x = kNegInf;
        s[4 * n + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = exp2(s2 - m2): fp32 into the row sums, T into the A fragments
    uint32_t pa[kN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      const float p0 = exp2f(s[4 * n] - mn0), p1 = exp2f(s[4 * n + 1] - mn0);
      const float p2 = exp2f(s[4 * n + 2] - mn1);
      const float p3 = exp2f(s[4 * n + 3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      // keys 16 c .. 16 c + 15: registers (row, lo 8), (row + 8, lo 8),
      // (row, hi 8), (row + 8, hi 8)
      pa[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[4 * n] *= alpha0;
      acc[4 * n + 1] *= alpha0;
      acc[4 * n + 2] *= alpha1;
      acc[4 * n + 3] *= alpha1;
    }

    // acc += T(p) v over kN / 16 steps of 16 keys
    bar_wait(&v_full[st], phase);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kN / 16; ++c)
      pv<T, kD, kN>(acc, pa[c], &t.v[st][0][0], c);
    wg_commit();
    wg_wait();
    pin(acc);

    // this warp is done with the stage's K and V
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

  // o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
  const float lf0 = fmaxf(quad_sum(l0), 1e-30f);
  const float lf1 = fmaxf(quad_sum(l1), 1e-30f);
  const int r0 = q0 + wg * 64 + row, r1 = r0 + 8;
  if (lane % 4 == 0) {
    if (r0 < S) lse[(long long)bh * S + r0] = m0 * kLn2 + logf(lf0);
    if (r1 < S) lse[(long long)bh * S + r1] = m1 * kLn2 + logf(lf1);
  }
  typedef typename Elem<T>::Pair Pair;
  T* ob = o + b * out.sb + h * out.sh;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + col;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<Pair*>(ob + r0 * out.sr + c) =
          Elem<T>::store2(acc[4 * n] / lf0, acc[4 * n + 1] / lf0);
    if (r1 < S)
      *reinterpret_cast<Pair*>(ob + r1 * out.sr + c) =
          Elem<T>::store2(acc[4 * n + 2] / lf1, acc[4 * n + 3] / lf1);
  }
}

template <typename T, int kD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int S, int D, float scale, Layout in, Layout out,
        cudaStream_t stream) {
  constexpr int kN = key_tile<kD>();
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType type = map_type<T>();
  int rc = encode(enc, &tq, q, B, H, S, D, in, kBlockM, type);
  if (!rc) rc = encode(enc, &tk, k, B, H, S, D, in, kN, type);
  if (!rc) rc = encode(enc, &tv, v, B, H, S, D, in, kN, type);
  if (rc) return rc;
  const size_t smem = sizeof(Tiles<T, kD>) + 1024;  // + the alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<T, kD><<<dim3((unsigned)blocks), block_threads<kD>(),
                            smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), H, S, D,
      n_qt, scale * kLog2e, out);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_d(const void* q, const void* k, const void* v, void* o, void* lse,
          int B, int H, int S, int D, float scale, Layout in, Layout out,
          cudaStream_t s) {
  if (D <= 64)
    return fwd<T, 64>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
  if (D <= 128)
    return fwd<T, 128>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
  if (D <= 192)
    return fwd<T, 192>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
  return fwd<T, 256>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
}

}  // namespace

extern "C" {

// o (out layout) and lse (B, H, S) fp32 from q, k, v (in layout), all of
// the element type `dtype` (elem.cuh's code, as csrc/flash_blocked.cu takes
// it): bf16 or fp16 (fp32 is csrc/flash_fwd_simt.cu's). 1 <= D <= 256.
// Returns a cudaError_t as int (0 on a launch that was accepted), or a code
// of vtx_cuda_error_string's own when a tensor map could not be made.
int vtx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int S, int D, float scale,
                  long long in_sb, long long in_sh, long long in_sr,
                  long long out_sb, long long out_sh, long long out_sr,
                  int dtype, void* stream) {
  if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const Layout in{in_sb, in_sh, in_sr}, out{out_sb, out_sh, out_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16:
      return fwd_d<bf16>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
    case kF16:
      return fwd_d<f16>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vtx_cuda_error_string(int err) { return error_string(err); }

}  // extern "C"
