// Blocked flash attention forward (online softmax) on Hopper's tensor cores.
//
// Replaces the TPU kernel vision_transformers_torch_xla_tpu/ops/
// flash_blocked.py::_fwd_kernel (:33, ROADMAP K4), the forward of the
// long-sequence path (S > 1024). Per query row, over key tiles, a running
// max m, sum l and fp32 accumulator acc:
//   s = (q k^T) * scale in fp32 (bf16 x bf16 products, fp32 sums), keys >= S
//   masked to -1e30; m' = max(m, rowmax s); alpha = exp(m - m');
//   p = exp(s - m'); l = l alpha + sum(fp32 p); acc = acc alpha + bf16(p) v;
// then o = bf16(acc / max(l, 1e-30)) and lse = m + log(max(l, 1e-30)).
// Both products are bf16 x bf16 into fp32, what wgmma computes, so the cast
// order is the TPU kernel's. The scale is applied to the fp32 product, never
// to a bf16 q (at D = 128, 1/sqrt(128) is not a power of two). The
// exponentials run as exp2f with log2(e) folded into the scale: s2 = s *
// (scale * log2 e), p = exp2f(s2 - m2). Against expf of the natural-units
// score that moves p by a relative ~1e-6 (the rounding of the folded
// constant and of s2, |s2| < ~30, plus exp2f's 2 ulp), far below the 2^-9
// of p's bf16 rounding; lse = m2 ln 2 + log(l) moves by the same ~1e-6.
//
// What bounds it on an H100: at S = 1370, D = 64 one (b, h) is 4 S^2 D =
// 0.48 GFLOP over < 1 MB of operands, hundreds of FLOP per byte: the
// products bound it. At B = 32, 12 heads the least time at the H100 SXM's
// 989 TFLOP/s bf16 peak is 0.187 ms; the S^2 exponentials (7.2e8 a call) on
// the special-function units are a second floor of about the same size.
//
// Design (warp-specialised, one block of 288 threads per 128 query rows of
// one (b, h)):
// * a producer warp starts TMA loads: the block's Q tile once, then K and V
//   tiles of 128 keys through a 2-stage ring in shared memory, with full
//   (TMA bytes arrived) and empty (both consumers done) mbarriers;
// * two consumer warpgroups own 64 query rows each. S = Q K^T is wgmma
//   m64n128k16 with both operands in 128-byte-swizzled shared memory, K-major
//   (q and k rows are D-contiguous). The online softmax runs in registers on
//   the accumulator fragments, with quad shuffles for the row max; each
//   thread keeps a partial row sum, reduced once at the end. P is packed to
//   bf16 in registers and is the register A operand of wgmma for O += P V; V
//   is read from shared memory as an MN-major B operand (the transpose bit
//   that 16-bit types allow). The two warpgroups' softmax and products
//   interleave on the SM.
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
// through cudaGetDriverEntryPoint, so the library links no -lcuda.
//
// Plain C interface, loaded with ctypes. The kernel allocates nothing and
// launches on the caller's stream; the host function returns
// cudaGetLastError(), or a code >= kErrEncodeBase when a tensor map could
// not be encoded (vtx_cuda_error_string says which). The caller checks the
// shapes: 1 <= D <= 128, D a multiple of 8.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 128;          // query rows of a block
constexpr int kBlockN = 128;          // keys of a tile
constexpr int kPanel = 64;            // bf16 columns of one 128-byte row
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kErrNoEntryPoint = 9999;
constexpr int kErrEncodeBase = 10000;

struct Layout {
  long long sb, sh, sr;  // element strides of batch, head and row
};

// One block's shared tiles, each kD / 64 panels of [rows][64] bf16 in the
// TMA's 128-byte swizzle. Every panel is 16 KB, so each stays 1024-byte
// aligned (the swizzle atom) when the struct is.
template <int kD>
struct Tiles {
  bf16 q[kD / kPanel][kBlockM * kPanel];
  bf16 k[kStages][kD / kPanel][kBlockN * kPanel];
  bf16 v[kStages][kD / kPanel][kBlockN * kPanel];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA: one [rows][64] box at (col, row, head, batch) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// ---- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B
// swizzle. K-major (q, k): rows of 128 bytes, SBO = 1024 between 8-row
// groups, LBO unused. MN-major (v): SBO = 1024 between groups of 8 keys,
// LBO = the distance between 64-column panels.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers in program order around the asynchronous
// products, so no read or write of them moves across a fence or a wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)

// d[64] (+)= A[64 x 16] B[16 x 128], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[N/2] += A[64 x 16] B[16 x N]: A from registers (the mma A fragment), B
// from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC64
#undef ACC32
#undef ACC8

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (ceil(S / kBlockM) * B * H): block x is query tile x % n_qt of
// (b, h) = x / n_qt. Accumulator fragments (wgmma m64nN, f32): thread t of
// a warpgroup, warp w = t / 32, lane l, holds d[4n + j] at row 16 w + l / 4
// + 8 (j / 2), column 8 n + 2 (l % 4) + (j % 2).
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int D, int n_qt, float scale_log2, Layout out) {
  constexpr int kPanels = kD / kPanel;
  constexpr int kTileBytes = kBlockN * kD * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // the swizzle atom is 1024 bytes: align the tiles to it
  Tiles<kD>& t = *reinterpret_cast<Tiles<kD>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kBlockM;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: Q once, then K and V tiles through the ring
    if (lane == 0) {
      bar_expect_tx(&q_full, kBlockM * kD * 2);
      for (int p = 0; p < kPanels; ++p)
        tma_load(t.q[p], &tq, &q_full, p * kPanel, q0, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
        bar_expect_tx(&k_full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.k[s][p], &tk, &k_full[s], p * kPanel, j * kBlockN, h, b);
        bar_expect_tx(&v_full[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(t.v[s][p], &tv, &v_full[s], p * kPanel, j * kBlockN, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane / 4;  // and row + 8, in the group
  const int col = 2 * (lane % 4);
  float acc[kD / 2];
  float s[64];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of s2, rows row, row + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums

  bar_wait(&q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const int k0 = j * kBlockN;

    // s = q k^T over kD / 16 steps of 16 columns
    bar_wait(&k_full[st], phase);
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      wgmma_ss_n128(s, desc(&t.q[p][wg * 64 * kPanel + c], 16, 1024),
                    desc(&t.k[st][p][c], 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);

    // scale to log2 units, mask keys >= S, new row maxima
    float mx0 = kNegInf, mx1 = kNegInf;
    const bool ragged = k0 + kBlockN > S;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
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

    // p = exp2(s2 - m2): fp32 into the row sums, bf16 into the A fragments
    uint32_t pa[8][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float p0 = exp2f(s[4 * n] - mn0), p1 = exp2f(s[4 * n + 1] - mn0);
      const float p2 = exp2f(s[4 * n + 2] - mn1);
      const float p3 = exp2f(s[4 * n + 3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      // keys 16 c .. 16 c + 15: registers (row, lo 8), (row + 8, lo 8),
      // (row, hi 8), (row + 8, hi 8)
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
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

    // acc += bf16(p) v over 8 steps of 16 keys
    bar_wait(&v_full[st], phase);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kBlockN / 16; ++c)
      wgmma_rs(acc, pa[c],
               desc(&t.v[st][0][c * 16 * kPanel], kBlockN * kPanel * 2, 1024));
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
  bf16* ob = o + b * out.sb + h * out.sh;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + col;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * out.sr + c) =
          __floats2bfloat162_rn(acc[4 * n] / lf0, acc[4 * n + 1] / lf0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * out.sr + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] / lf1, acc[4 * n + 3] / lf1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t rc = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                           cudaEnableDefault, &found);
#endif
  if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A 4-D map (D, S, H, B) of one bf16 operand with the layout's strides,
// read in [128 rows][64 columns] boxes, 128-byte swizzled, zeros out of
// bounds. Returns 0 or a kErrEncodeBase code.
int encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H,
           int S, int D, Layout in) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)in.sr * 2,
                                 (cuuint64_t)in.sh * 2,
                                 (cuuint64_t)in.sb * 2};
  const cuuint32_t box[4] = {kPanel, kBlockN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrEncodeBase + (int)rc;
}

template <int kD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int S, int D, float scale, Layout in, Layout out,
        cudaStream_t stream) {
  static_assert(kBlockM == kBlockN, "one box shape serves Q, K and V");
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  CUtensorMap tq, tk, tv;
  int rc = encode(enc, &tq, q, B, H, S, D, in);
  if (!rc) rc = encode(enc, &tk, k, B, H, S, D, in);
  if (!rc) rc = encode(enc, &tv, v, B, H, S, D, in);
  if (rc) return rc;
  const size_t smem = sizeof(Tiles<kD>) + 1024;  // + the alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const dim3 grid((unsigned)((long long)n_qt * B * H));
  flash_fwd_kernel<kD><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, S, D,
      n_qt, scale * kLog2e, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (out layout) bf16 and lse (B, H, S) fp32 from q, k, v (in layout).
// Returns a cudaError_t as int (0 on a launch that was accepted), or a code
// of vtx_cuda_error_string's own when a tensor map could not be made.
int vtx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int S, int D, float scale,
                  long long in_sb, long long in_sh, long long in_sr,
                  long long out_sb, long long out_sh, long long out_sr,
                  void* stream) {
  const Layout in{in_sb, in_sh, in_sr}, out{out_sb, out_sh, out_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return fwd<64>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
  return fwd<128>(q, k, v, o, lse, B, H, S, D, scale, in, out, s);
}

const char* vtx_cuda_error_string(int err) {
  static char msg[96];
  if (err == kErrNoEntryPoint)
    return "no cuTensorMapEncodeTiled entry point was found";
  if (err >= kErrEncodeBase) {
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled returned CUresult %d",
             err - kErrEncodeBase);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
