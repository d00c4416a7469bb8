// Softmax attention forward over (B, H, S, D) q, k and v given by strides,
// for Hopper, in fp32, and in bf16 and fp16 past the tensor cores' head
// dims.
//
// Replaces two TPU kernels of
// vision_transformers_torch_xla_tpu/ops/flash_attention.py that compute the
// same function over two layouts:
//   _fwd_kernel (K7): q, k, v (B*H, Sp, Dp), G (b, h) pairs per program;
//   _qkv_fwd_kernel (K11): one (B, Sp, 3H, D) qkv buffer, one image per
//     program, o (B, Sp, H, D).
// Per (b, h), in their cast order:
//   s = (q k^T in fp32 from the raw values) * scale over the S real keys;
//   m = rowmax(s); p = exp(s - m) / sum(exp(s - m)), normalised in fp32;
//   o = T(p) v, accumulated in fp32, stored T (T the inputs' dtype).
// This is not K1's and K9's order (csrc/attn_fwd.cu): there q^ = T(q *
// scale) and p is cast before it is normalised, o scaled by 1 / sum after
// the product. The TPU kernels pad S to 128 and D to 8 and mask the padded
// columns; here the loops run over the S real keys and the D real columns.
//
// Every tensor is a base pointer and three element strides (batch, head,
// token) with the head dim contiguous, so K7 reads (B, H, S, D) tensors and
// K11 reads q, k and v in place in the qkv buffer and writes o straight into
// a (B, S, H*D) output, with no copy in or out.
//
// What bounds it on an H100: at B = 128, S = 197, H = 12, D = 64 the two
// products are 15 GFLOP over ~310 MB of fp32 (q, k, v read, o written):
// 0.228 ms at the 67 TFLOP/s fp32 CUDA-core peak, 0.093 ms at 3.35 TB/s, so
// the products bound the ideal kernel.
//
// fp32 at D <= 256: csrc/attn_fwd_simt.cuh's register tiles in K7's order
// (attn_fwd_simt_kernel<kD, true, kStore>, kD 32, 64, 128, 192 or 256);
// the header has the design and its times. bf16 and fp16 to D = 256 run
// on the tensor cores (csrc/attn_fwd_tc.cu, K7's cast order).
//
// Every dtype past D = 256 (fused_attn_fwd_kernel<T, 0>): the first design,
// with the head dim a run-time value and the loops written for any element
// type through csrc/elem.cuh. One block per (b, h, 64-row query tile). K
// and V of the head are staged once in shared memory (rows padded to an odd
// number of 32-bit words, so lanes reading different key rows hit
// different banks); each warp owns one query row at a time: lanes split the
// keys for q k^T, warp shuffles give the row max and sum, and lanes split
// the head dim for p v. The score row never leaves shared memory. s is
// scaled with __fmul_rn, so the compiler cannot fuse the scale into the
// subtraction of m. When K and V do not fit (long S with wide D), they are
// read from global memory (L2) through the same loops.
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "attn_fwd_simt.cuh"
#include "elem.cuh"

namespace {

constexpr int kWarps = 8;          // query rows in flight per block
constexpr int kRowsPerBlock = 64;  // query tile of one block
constexpr int kMaxHeadDim = 1024;  // the per-warp scratch stays < 227 KB
constexpr int kMaxSeq = 1024;
constexpr long long kMaxGridX = 2147483647;  // (b, h, tile) ride grid x
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

// Element strides of the four (B, H, S, D) tensors, whose base pointers are
// the kernel's __restrict__ parameters. Token strides are int: the host
// checks that one head's rows span < 2^31.
struct Layout {
  long long sb[kTensors], sh[kTensors];
  int ss[kTensors];
  int S, H, D;
  int tiles;  // query tiles of one head
  float scale;
  int kv_in_smem, kv_words;
};

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

// Tensor t's rows of head (b, h).
template <typename T>
__device__ __forceinline__ T* head(T* p, const Layout& a, int t, int b,
                                   int h) {
  return p + b * a.sb[t] + h * a.sh[t];
}

// Floats of one warp's scratch: q (D) then scores (S), padded to 16 bytes.
__host__ __device__ inline int warp_floats(int D, int S) {
  return (D + S + 3) & ~3;
}

// 1-D grid over (b, h, query tile), so B and H are bound by grid x alone
// (2^31 - 1 blocks), not by the 65535 of y and z. Shared memory: per warp
// [q: D][scores: S] (16-byte aligned), then [K: S x kv_words][V: S x
// kv_words] when kv_in_smem. kD is 0: the head dim is a.D.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32)
fused_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const Layout a) {
  static_assert(kD == 0, "the run-time head-dim loops");
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int S = a.S;
  const int bh = blockIdx.x / a.tiles;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int row0 = (blockIdx.x - bh * a.tiles) * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D2 = D >> 1;  // pairs in a head row

  const T* qg = head(q, a, kQ, b, h);
  T* og = head(o, a, kO, b, h);
  const Pair* kp = reinterpret_cast<const Pair*>(head(k, a, kK, b, h));
  const Pair* vp = reinterpret_cast<const Pair*>(head(v, a, kV, b, h));
  int k_stride = a.ss[kK] >> 1, v_stride = a.ss[kV] >> 1;  // in pairs

  const int wf = warp_floats(D, S);
  float* qs = smem + warp * wf;
  float* sc = qs + D;
  if (a.kv_in_smem) {
    Pair* ks = reinterpret_cast<Pair*>(smem + kWarps * wf);
    Pair* vs = ks + S * a.kv_words;
    for (int i = threadIdx.x; i < S * D2; i += blockDim.x) {
      const int r = i / D2, c = i - r * D2;
      ks[r * a.kv_words + c] = kp[r * k_stride + c];
      vs[r * a.kv_words + c] = vp[r * v_stride + c];
    }
    kp = ks;
    vp = vs;
    k_stride = v_stride = a.kv_words;
  }
  __syncthreads();

  const int row_end = min(row0 + kRowsPerBlock, S);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const T* qrow = qg + r * a.ss[kQ];
    for (int d = lane; d < D; d += 32) qs[d] = E::load(qrow[d]);
    __syncwarp();

    // s = (q k^T) * scale: lane j takes keys j, j + 32, ...
    float mx = -FLT_MAX;
    for (int j = lane; j < S; j += 32) {
      const Pair* kr = kp + j * k_stride;
      float a0 = 0.f, a1 = 0.f;
      for (int c = 0; c < D2; ++c) {
        const float2 kf = E::load2(kr[c]);
        a0 = fmaf(qs[2 * c], kf.x, a0);
        a1 = fmaf(qs[2 * c + 1], kf.y, a1);
      }
      const float s = __fmul_rn(a0 + a1, a.scale);
      sc[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    // p = exp(s - m) / sum, normalised in fp32, then rounded to bf16 for
    // the p v product; each lane rereads only the keys it wrote
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(sc[j] - mx);
      sum += e;
      sc[j] = e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32)
      sc[j] = E::round(sc[j] / sum);
    __syncwarp();

    // o = bf16(p) v: lane c takes head-dim pairs c, c + 32
    Pair* orow = reinterpret_cast<Pair*>(og + r * a.ss[kO]);
    for (int c = lane; c < D2; c += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float2 vf = E::load2(vp[j * v_stride + c]);
        ax = fmaf(sc[j], vf.x, ax);
        ay = fmaf(sc[j], vf.y, ay);
      }
      orow[c] = E::store2(ax, ay);
    }
    __syncwarp();  // qs and sc are rewritten by the warp's next row
  }
}

template <typename T>
int launch(T* const* t, Layout a, int B, int H, cudaStream_t stream) {
  // pad K/V rows to an odd number of pairs (of 32-bit words for the 16-bit
  // types): conflict-free row reads
  const int d2 = a.D / 2;
  a.kv_words = (d2 % 2 == 0) ? d2 + 1 : d2;
  const size_t warp_bytes =
      (size_t)kWarps * warp_floats(a.D, a.S) * sizeof(float);
  const size_t kv_bytes =
      2 * (size_t)a.S * a.kv_words * sizeof(typename Elem<T>::Pair);
  a.kv_in_smem = (kv_bytes + warp_bytes <= kSmemBudget) ? 1 : 0;
  const size_t smem = warp_bytes + (a.kv_in_smem ? kv_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_attn_fwd_kernel<T, 0>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)B * H * a.tiles;
  fused_attn_fwd_kernel<T, 0><<<grid, kWarps * 32, smem, stream>>>(
      t[kQ], t[kK], t[kV], t[kO], a);
  return (int)cudaGetLastError();
}

// Every dtype comes here past D = 256 alone (fp32 below is
// csrc/attn_fwd_simt.cuh's, bf16 and fp16 csrc/attn_fwd_tc.cu's): run-time
// loops.
template <typename T>
int launch_d(const void* const* ptrs, const Layout& a, int B, int H,
             cudaStream_t s) {
  T* t[kTensors];
  for (int i = 0; i < kTensors; ++i)
    t[i] = const_cast<T*>(static_cast<const T*>(ptrs[i]));
  return launch<T>(t, a, B, H, s);
}

}  // namespace

extern "C" {

// q, k, v in, o out: (B, H, S, D) of the element type `dtype` (bf16 and
// fp16 at head dims <= 256 are csrc/attn_fwd_tc.cu's; fp32 there takes
// csrc/attn_fwd_simt.cuh's kernel) with the head dim contiguous; strides
// holds 12 element strides,
// (batch, head, token) of q, k, v and o. Returns a cudaError_t as int: 0 on
// a launch that was accepted.
int vtx_fused_attn_fwd(const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int B, int S, int H, int D,
                       float scale, int dtype, void* stream) {
  const int tiles = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 ||
      (long long)B * H * tiles > kMaxGridX || D < 2 || (D & 1) ||
      D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBf16 && dtype != kF16 && dtype != kF32)
    return (int)cudaErrorInvalidValue;
  const uintptr_t pair_bytes = dtype == kF32 ? 8 : 4;
  Layout a;
  const void* ptrs[kTensors] = {q, k, v, o};
  for (int t = 0; t < kTensors; ++t) {
    const long long sb = strides[3 * t], sh = strides[3 * t + 1],
                    ss = strides[3 * t + 2];
    // rows are read and written as pairs: pair-aligned, even strides
    if ((reinterpret_cast<uintptr_t>(ptrs[t]) & (pair_bytes - 1)) ||
        ((sb | sh | ss) & 1) || sb < 0 || sh < 0 || ss < 0 ||
        ss * (S - 1) + D >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    a.sb[t] = sb;
    a.sh[t] = sh;
    a.ss[t] = (int)ss;
  }
  a.S = S;
  a.H = H;
  a.D = D;
  a.tiles = tiles;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D <= 256)
    return attn_fwd_simt<true>(ptrs, nullptr, strides, B, S, H, D, scale, s);
  switch (dtype) {
    case kBf16: return launch_d<__nv_bfloat16>(ptrs, a, B, H, s);
    case kF16: return launch_d<__half>(ptrs, a, B, H, s);
    default: return launch_d<float>(ptrs, a, B, H, s);
  }
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
